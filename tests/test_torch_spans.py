"""The port's spans: ``metrics.timed`` stages on the reduced
``Spectroscopy.compute_absorption`` path, each a ``pylbl.<stage>`` range
while a profiler records, nested as the layers are, and the counters of
the per-instance work and of the blocks."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lblbench.harness.spans import SPANS
from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.utils.observability import SPAN_PREFIX, metrics

torch.set_num_threads(1)

GRID = np.arange(1.0, 200.0, 0.5)
# Each span and the span it opens inside (None: opened by the caller).
PARENTS = {
    "spectroscopy.init": None,
    "absorption": None,
    "molecules.load": "absorption",
    "lines.build": "absorption",
    "lines.stack": "lines.build",
    "lines.plan": "lines.build",
    "lines.layout": "lines.plan",
    "lines.permute": "lines.plan",
    "lines.core_plan": "lines.plan",
    "lines.pieces": "lines.plan",
    "lines.upload": "lines.build",
    "absorption.block": "absorption",
    "lines.run": "absorption.block",
    "lines.guard": "lines.run",
    "lines.assemble": "lines.run",
    "lines.wings": "lines.run",
    "lines.core": "lines.run",
    "lines.pedestal": "lines.run",
    "continua.build": "absorption.block",
    "continua.run": "absorption.block",
    "output": "absorption.block",
    "output.wait": "output",
}
# A block's copy starts in ``output`` inside its block and lands in
# another ``output`` inside the next block; the last block's lands after
# it, outside any block.
LANDS_IN = "absorption"
GASES = {"H2O": ("water_vapor", 6.6e-3), "CO2": ("carbon_dioxide", 4e-4)}


def make_database(path):
    db = Database(path)
    for seed, name in enumerate(GASES):
        db.ingest_line_pack(synthetic_line_pack(name, num_lines=150,
                                                nu_min=0.7, nu_max=220.0,
                                                seed=seed + 1))
    return db


@pytest.fixture(scope="module")
def database(tmp_path_factory):
    return make_database(tmp_path_factory.mktemp("spans") / "spans.db")


def atmosphere():
    data = {"p": (["layer"], np.asarray([98388.0, 5e4]),
                  {"standard_name": "air_pressure", "units": "Pa"}),
            "t": (["layer"], np.asarray([288.99, 250.0]),
                  {"standard_name": "air_temperature", "units": "K"})}
    for name, (standard, vmr) in GASES.items():
        data[name.lower()] = (["layer"], np.full(2, vmr), {
            "standard_name": f"mole_fraction_of_{standard}_in_air",
            "units": "mol mol-1"})
    return Dataset(data_vars=data)


def spectroscopy(db, grid=GRID):
    return Spectroscopy(atmosphere(), grid, db, device="cpu",
                        device_mechanisms=True)


def spans(prof):
    """[(stage, parent stage or None)] of the profile's ``pylbl.`` ranges,
    the parent the innermost ``pylbl.`` range around each."""
    out = []
    for event in prof.events():
        if not event.name.startswith(SPAN_PREFIX):
            continue
        parent = event.cpu_parent
        while parent is not None and \
                not parent.name.startswith(SPAN_PREFIX):
            parent = parent.cpu_parent
        out.append((event.name[len(SPAN_PREFIX):], None if parent is None
                    else parent.name[len(SPAN_PREFIX):]))
    return out


@pytest.mark.parametrize("grid", [GRID, np.arange(1.0, 60.0, 0.01)],
                         ids=["strided", "splat"])
def test_every_span_opens_in_its_parent(database, grid):
    """At 0.5 cm-1 a stride fits the line windows and the plan permutes
    the lines into its layout; at 0.01 cm-1 none fits (the splat wings)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spec = spectroscopy(database, grid)
        out = spec.compute_absorption("total")
    assert np.isfinite(out["absorption"].data).all()
    got = spans(prof)
    strided = grid[1] - grid[0] > 0.1
    assert {stage for stage, _ in got} == set(PARENTS) - (
        set() if strided else {"lines.permute"})
    for stage, parent in got:
        assert parent == PARENTS[stage] or (stage, parent) == (
            "output", LANDS_IN), stage


@pytest.mark.parametrize("states,blocks", [(None, 1), (1, 4), (3, 2)])
def test_blocks_open_their_spans_in_order(database, monkeypatch, states,
                                          blocks):
    """Each block runs its lines, its sums and the start of its copy in
    ``absorption.block``; its copy lands (``output.wait`` in ``output``)
    inside the next block, after that block's lines, the last block's
    after it; the counter ``absorption.blocks`` counts them, and
    ``lines.pedestal_device`` the blocks' pedestal removals, one a
    block's ``lines.run``."""
    from pylbl_tpu_torch import spectroscopy as module

    if states is not None:
        monkeypatch.setattr(module, "block_bytes", lambda *a: (1, 0))
        monkeypatch.setattr(module, "block_budget", lambda device: states)
    sites = Dataset(data_vars={
        name: (["site", "layer"], np.stack([var.data, var.data]), var.attrs)
        for name, var in atmosphere().data_vars.items()})
    spec = Spectroscopy(sites, GRID, database, device="cpu",
                        device_mechanisms=True)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spec.compute_absorption("total")
    counters = metrics.snapshot()["counters"]
    assert counters["absorption.blocks"] == blocks
    assert counters["lines.pedestal_device"] == blocks
    got = spans(prof)
    order = [stage for stage, parent in got
             if stage == "absorption.block"
             or (stage, parent) == ("output.wait", "output")]
    # Block, block, wait (the first block's), ..., wait (the last's).
    assert order == ["absorption.block"] + [
        "absorption.block", "output.wait"] * (blocks - 1) + ["output.wait"]
    landings = sorted((e for e in prof.events()
                       if e.name == SPAN_PREFIX + "output.wait"),
                      key=lambda e: e.time_range.start)
    assert [e.cpu_parent.cpu_parent.name[len(SPAN_PREFIX):]
            for e in landings] == ["absorption.block"] * (blocks - 1) \
        + [LANDS_IN]
    assert all(e.cpu_parent.name == SPAN_PREFIX + "output"
               for e in landings)
    # In a block the lines run before the block before lands.
    lines_runs = sorted(e.time_range.end for e in prof.events()
                        if e.name == SPAN_PREFIX + "lines.run")
    assert all(run < wait.time_range.start
               for run, wait in zip(lines_runs[1:], landings))
    # The spans the benchmark's span metrics read stay disjoint, so that
    # with host_other_ms they partition a call.
    ranges = [(metric, e.time_range.start, e.time_range.end)
              for e in prof.events() for metric, stages in SPANS.items()
              if e.name in {SPAN_PREFIX + s for s in stages}]
    for metric, lo, hi in ranges:
        assert not any(other != metric and lo < b and a < hi
                       for other, a, b in ranges), metric


def test_a_second_call_builds_nothing(tmp_path):
    database = make_database(tmp_path / "fresh.db")
    metrics.reset()
    spec = spectroscopy(database)
    spec.compute_absorption("total")
    # Every gas here has lines and an MT-CKD continuum (so the call takes
    # the pedestal out on the field's device, once), and a new database
    # reads each gas's pack once.
    fresh = {"lines.builds": 1, "continua.builds": len(GASES),
             "molecules.loaded": len(GASES),
             "database.pack_reads": len(GASES), "absorption.blocks": 1,
             "lines.pedestal_device": 1}
    assert metrics.snapshot()["counters"] == fresh
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spec.compute_absorption("total")
    stages = {stage for stage, _ in spans(prof)}
    assert "lines.run" in stages and "continua.run" in stages
    assert not stages & {"lines.build", "continua.build", "lines.plan"}
    assert metrics.snapshot()["counters"] == dict(
        fresh, **{"absorption.blocks": 2, "lines.pedestal_device": 2})
    # A new object on the same database takes the database's stacked
    # pipeline, and reads no pack.
    metrics.reset()
    spectroscopy(database).compute_absorption("total")
    assert metrics.snapshot()["counters"] == {
        "lines.shared_hits": 1, "continua.builds": len(GASES),
        "molecules.loaded": len(GASES), "absorption.blocks": 1,
        "lines.pedestal_device": 1}


def test_pack_reads_count_the_database_misses(tmp_path):
    db = Database(tmp_path / "reads.db")
    db.ingest_line_pack(synthetic_line_pack(num_lines=8, seed=1))
    metrics.reset()
    first = db.line_pack("H2O")
    assert db.line_pack("H2O") is first
    assert metrics.snapshot()["counters"] == {"database.pack_reads": 1}


def test_timed_opens_no_range_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    metrics.reset()
    with monkeypatch.context() as patch:
        patch.setattr(torch.profiler, "record_function", refused)
        with metrics.timed("quiet"):
            pass
    assert metrics.snapshot()["timers"]["quiet"]["calls"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.timed("loud"):
            torch.ones(2).add_(1)
    assert [e.name for e in prof.events()
            if e.name.startswith(SPAN_PREFIX)] == [SPAN_PREFIX + "loud"]
    assert metrics.snapshot()["timers"]["loud"]["calls"] == 1
