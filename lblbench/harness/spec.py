"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) is found by its name; its configuration
by the ``file`` of its ``configs`` entry; its traffic mix at
``lblbench/traffic/<traffic>.json``; its limits at
``lblbench/limits/<cell>.json``; each metric's reader at
``lblbench/metrics/<metric>.py`` (a ``read(run)`` that returns a number,
or None where it finds nothing to read); the line-shape kernels' names in
every ``lblbench/kernels/*.json``.  A cell, a configuration, a traffic mix,
a metric or a list of kernel names is added by adding files and entries,
with no edit to a file that is there.
"""
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load(root):
    """``BENCHMARK.json`` at the checkout ``root``."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root, name):
    """The :class:`Cell` named ``name``; KeyError if there is none."""
    root = Path(root)
    bench = load(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    here = root / "lblbench"
    traffic = json.loads(
        (here / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=entry["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def remove_pedestal(config):
    """Whether the configuration states the reference's pedestal taken out
    (its ``remove_pedestal``; a configuration without the key takes none
    out).  The program, the plain reference and the control all read it
    here."""
    return bool(config.get("remove_pedestal", False))


def _load(root, folder, name):
    """The module ``lblbench/<folder>/<name>.py``."""
    path = Path(root) / "lblbench" / folder / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(
        f"lblbench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def reader(root, metric):
    """The ``read`` function of ``lblbench/metrics/<metric>.py``."""
    return _load(root, "metrics", metric).read


def kernel_names(root, layer):
    """The kernel names that every ``lblbench/kernels/*.json`` lists for
    ``layer``."""
    names = set()
    for path in sorted((Path(root) / "lblbench" / "kernels").glob("*.json")):
        entry = json.loads(path.read_text())
        if entry["layer"] == layer:
            names.update(entry["kernels"])
    return sorted(names)


def kernel_matcher(names):
    """A predicate that accepts a trace's kernel name when it holds one of
    ``names`` as a whole identifier (so ``rows_kernel`` does not accept
    ``my_rows_kernel2``)."""
    if not names:
        return lambda name: False
    pattern = re.compile(r"(?<![A-Za-z0-9_])(?:"
                         + "|".join(map(re.escape, names))
                         + r")(?![A-Za-z0-9_])")
    return lambda name: pattern.search(name) is not None
