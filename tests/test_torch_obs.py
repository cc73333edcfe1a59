"""The port's observability, plugin hooks, pack cache and database queries.

Ports of tests/test_cli_and_obs.py:14-47 (metrics, the npz round trip,
the pack cache), tests/test_database.py:49-56 (``Database.gas``) and
tests/test_packaging.py:44-92 (entry-point discovery with fake entry
points, here under the port's group "pylbl_tpu_torch"), with packs that
cross between the packages, the ``register_*`` hooks,
``Spectroscopy.list_molecules`` and a profiler trace on the CPU.
"""
import sys
import types

import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack as jfixture
from pylbl_tpu.models.lines import LinePack as JLinePack

from pylbl_tpu_torch import Dataset, Spectroscopy, plugins
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.models.lines import Gas, LinePack
from pylbl_tpu_torch.utils.observability import (Metrics, logger, metrics,
                                                 profiler_trace)

torch.set_num_threads(1)

GRID = np.arange(1.0, 100.0, 0.5)


def assert_packs_equal(a, b):
    assert a.formula == b.formula
    for name in LinePack._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_metrics_counters(backend):
    metrics.reset()
    pack = synthetic_line_pack(num_lines=100, nu_min=0.7, nu_max=120.0,
                               seed=2)
    gas = Gas(pack, pack.formula, device="cpu", dtype=np.float64,
              backend=backend)
    k = gas.absorption_coefficient(288.99, 98388.0, 6.6e-3, GRID,
                                   remove_pedestal=True)
    snap = metrics.snapshot()
    keep = pack.compat_break_filter(1, 100, 25)
    assert snap["counters"] == {"lines.processed": keep,
                                "lines.point_evals": keep * (51 * 2 + 1),
                                "lines.grid_points": k.size}
    for stage in ("lines.absorption", "lines.pedestal"):
        assert snap["timers"][stage]["calls"] == 1
        assert snap["timers"][stage]["seconds"] > 0
    assert metrics.rate("lines.point_evals", "lines.absorption") > 0
    gas.absorption_coefficient_batch([288.99, 250.0], [98388.0, 5e4],
                                     [6.6e-3, 1e-3], GRID)
    snap = metrics.snapshot()
    assert snap["counters"]["lines.processed"] == 3 * keep
    # The portable batch stacks single-layer calls; the kernel pipeline
    # records its own stage.
    calls = 3 if backend == "xla" else 1
    assert snap["timers"]["lines.absorption"]["calls"] == calls
    assert ("lines.absorption_batch" in snap["timers"]) == \
        (backend == "kernel")
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "timers": {}}
    assert metrics.rate("lines.point_evals", "lines.absorption") is None


def test_metrics_registry_is_its_own():
    m = Metrics()
    m.count("a", 2)
    with m.timed("s"):
        pass
    assert m.snapshot()["counters"] == {"a": 2}
    assert m.snapshot()["timers"]["s"]["calls"] == 1
    assert logger.name == "pylbl_tpu_torch"


def test_line_pack_npz_roundtrip(tmp_path):
    pack = synthetic_line_pack(num_lines=64, seed=9)
    path = tmp_path / "H2O.lpk.npz"
    pack.save(path)
    back = LinePack.load(path)
    assert_packs_equal(back, pack)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_line_pack_crosses_packages(tmp_path, direction):
    path = tmp_path / "H2O.lpk.npz"
    if direction == "port_to_jax":
        pack = synthetic_line_pack(num_lines=64, seed=9)
        pack.save(path)
        back = JLinePack.load(path)
    else:
        pack = jfixture(num_lines=64, seed=9)
        pack.save(path)
        back = LinePack.load(path)
    assert_packs_equal(back, pack)


def test_database_pack_cache(tmp_path):
    db = Database(tmp_path / "c.db", pack_cache_dir=tmp_path / "packs")
    pack = synthetic_line_pack(num_lines=64, seed=9)
    db.ingest_line_pack(pack)
    first = db.line_pack("H2O")
    assert (tmp_path / "packs" / "H2O.lpk.npz").exists()
    assert db.line_pack("H2O") is first
    db2 = Database(tmp_path / "c.db", pack_cache_dir=tmp_path / "packs")
    second = db2.line_pack("H2O")
    assert second.meta["source"].endswith("H2O.lpk.npz")
    assert_packs_equal(first, second)


def test_database_echo_prints_sql(tmp_path, capsys):
    db = Database(tmp_path / "e.db", echo=True)
    db.ingest_line_pack(synthetic_line_pack(num_lines=8, seed=1))
    assert db.molecules() == ["H2O"]
    assert "SELECT ordinary_formula FROM molecule" in capsys.readouterr().out


def test_gas_query(tmp_path):
    database = Database(tmp_path / "test.db")
    pack = synthetic_line_pack(num_lines=200, seed=5)
    database.ingest_line_pack(pack, aliases=("water", "H2O-16"))
    formula, mass, transitions, tips = database.gas("H2O")
    assert formula == "H2O"
    assert len(transitions) == pack.num_lines
    assert len(mass) == pack.q_table.shape[0]
    q = tips.total_partition_function(279.54, 1)
    assert np.isfinite(q) and q > 0


def test_list_molecules(tmp_path):
    db = Database(tmp_path / "m.db")
    for name, seed in (("H2O", 1), ("CO2", 2)):
        db.ingest_line_pack(synthetic_line_pack(name, num_lines=8,
                                                seed=seed))
    atm = Dataset(data_vars={
        "p": (["layer"], np.asarray([98388.0]),
              {"standard_name": "air_pressure", "units": "Pa"}),
        "t": (["layer"], np.asarray([288.99]),
              {"standard_name": "air_temperature", "units": "K"})})
    spec = Spectroscopy(atm, GRID, db, device="cpu")
    assert spec.list_molecules() == ["H2O", "CO2"]


def test_discover_entry_points_registers_third_party(monkeypatch):
    """A toy distribution advertising Gas / CrossSection /
    <Mol>Continuum entry points in the port's group lands in the
    registries under its module-root backend name; the JAX package's
    group is never read."""
    class ToyGas:
        pass

    class ToyXsec:
        pass

    class ToyCont:
        pass

    toy_mod = types.ModuleType("toy_backend")
    toy_mod.ToyGas = ToyGas
    toy_mod.ToyXsec = ToyXsec
    toy_mod.ToyCont = ToyCont
    monkeypatch.setitem(sys.modules, "toy_backend", toy_mod)

    class FakeEP:
        def __init__(self, name, value):
            self.name = name
            self.value = value

        def load(self):
            module, _, attr = self.value.partition(":")
            return getattr(sys.modules[module], attr)

    fake = [FakeEP("Gas", "toy_backend:ToyGas"),
            FakeEP("CrossSection", "toy_backend:ToyXsec"),
            FakeEP("CH4Continuum", "toy_backend:ToyCont")]
    asked = []

    def entry_points(group=None):
        asked.append(group)
        return fake if group == "pylbl_tpu_torch" else []

    import importlib.metadata
    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    monkeypatch.setattr(plugins, "molecular_lines",
                        dict(plugins.molecular_lines))
    monkeypatch.setattr(plugins, "cross_sections",
                        dict(plugins.cross_sections))
    monkeypatch.setattr(plugins, "continua",
                        {k: dict(v) for k, v in plugins.continua.items()})
    monkeypatch.setattr(plugins, "models", list(plugins.models))
    plugins.discover_entry_points()
    assert asked == ["pylbl_tpu_torch"]
    assert plugins.molecular_lines["toy_backend"] is ToyGas
    assert plugins.cross_sections["toy_backend"] is ToyXsec
    assert plugins.continua["toy_backend"]["CH4"] is ToyCont
    assert "toy_backend" in plugins.models


@pytest.mark.parametrize("hook,registry,value", [
    ("register_lines_backend", "molecular_lines", object),
    ("register_continua_backend", "continua", {"CH4": object}),
    ("register_cross_sections_backend", "cross_sections", object)])
def test_register_hooks(monkeypatch, hook, registry, value):
    for name in ("molecular_lines", "cross_sections"):
        monkeypatch.setattr(plugins, name, dict(getattr(plugins, name)))
    monkeypatch.setattr(plugins, "continua",
                        {k: dict(v) for k, v in plugins.continua.items()})
    monkeypatch.setattr(plugins, "models", list(plugins.models))
    getattr(plugins, hook)("toy", value)
    assert getattr(plugins, registry)["toy"] == value
    assert "toy" in plugins.models


def test_profiler_trace_writes_a_trace(tmp_path):
    gas = Gas(synthetic_line_pack(num_lines=50, nu_min=0.7, nu_max=120.0,
                                  seed=2), "H2O", device="cpu",
              backend="xla")
    with profiler_trace(tmp_path / "trace") as prof:
        gas.absorption_coefficient(288.99, 98388.0, 6.6e-3, GRID)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json*"))
    assert traces and traces[0].stat().st_size > 0
    # The yielded profile holds the region's ops: the portable path's sort.
    assert any("sort" in event.key for event in prof.key_averages())
