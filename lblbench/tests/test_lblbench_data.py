"""A cell, a configuration, a traffic mix, a metric and a list of kernel
names are added as files, with no edit to a file that is there."""
import json
import shutil

from lblbench.harness import spec
from lblbench.tests.tiny import ROOT, run, tiny


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lblbench", tmp_path / "lblbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "lblbench"
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    config = json.loads((here / "configs" / "col60-0p1.json").read_text())
    config["name"] = "col30x3-0p1"
    config["layers"] = 30
    config["sites"] = 3
    (here / "configs" / "col30x3-0p1.json").write_text(json.dumps(config))
    traffic = json.loads((here / "traffic" / "fresh.json").read_text())
    traffic["why"] = "a test"
    (here / "traffic" / "again.json").write_text(json.dumps(traffic))
    (here / "limits" / "col30-0p1.sites3.json").write_text(
        json.dumps({"rel_err": 1e-3}))
    (here / "metrics" / "calls.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    (here / "kernels" / "more.json").write_text(json.dumps(
        {"layer": "line-shape kernels", "kernels": ["new_walk_kernel"]}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="col30x3-0p1",
                                 file="lblbench/configs/col30x3-0p1.json"))
    bench["workloads"].append({"name": "col30-0p1.sites3",
                               "config": "col30x3-0p1", "traffic": "again",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls", "unit": "calls",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["col30-0p1.sites3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(tmp_path, "col30-0p1.sites3")
    assert cell.config["layers"] == 30 and cell.config["sites"] == 3
    assert cell.traffic["why"] == "a test"
    assert "calls" in [m["name"] for m in cell.end_to_end]
    assert "calls" not in [m["name"] for m in
                           spec.cell(tmp_path, "col60-0p1.column").end_to_end]
    assert "new_walk_kernel" in spec.kernel_names(tmp_path,
                                                  "line-shape kernels")
    result = run(tiny(cell, sites=2), root=tmp_path)
    assert result["correct"]
    assert result["metrics"]["calls"]["value"] == result["attempted"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in here.rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_kernel_matcher_takes_whole_names():
    match = spec.kernel_matcher(["rows_kernel", "core_segmix_kernel"])
    assert match("void rows_kernel<4, false>(float const*, ...)")
    assert match("core_segmix_kernel")
    assert not match("void my_rows_kernel2<4>(float const*)")
    assert not spec.kernel_matcher([])("rows_kernel")
