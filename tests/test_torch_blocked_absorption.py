"""``Spectroscopy.compute_absorption`` in blocks of states: the reduced
path's output equals one unblocked call bit for bit at any block size, and
the plain float64 reference of the benchmark; the block planner keeps the
shapes that fit the card in one block and splits those that do not."""
import numpy as np
import pytest
import torch

from lblbench.harness import inputs, spec, system
from lblbench.reference import lbl
from lblbench.tests.tiny import ROOT, tiny_cell
from pylbl_tpu_torch import spectroscopy as module
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.models.lines.physics import LinePack
from pylbl_tpu_torch.utils.observability import metrics

torch.set_num_threads(2)

# The stacked pipelines of the benchmark's configurations (420k lines, 8
# gases) as the planner reads them, and the states of their cells: (lines
# and core instances, flat points, grid points, states).  Counts from the
# built pipelines on an H100 (PERF.md section 3).
CELLS = {
    "col60-0p1.column": (418317 + 647424, 350000, 49990, 60),
    "col60-0p1.default": (418317 + 647424, 350000, 49990, 60),
    "col60-0p1.sites8": (418317 + 647424, 350000, 49990, 480),
    "col60-0p01.column": (418304 + 1906176, 3500000, 499900, 60),
    "col60-0p01.sites8": (418304 + 1906176, 3500000, 499900, 480),
}
# max_memory_allocated of one unblocked call less what was allocated
# before it, at 0.1 cm-1 (1, 4 and 8 sites) and 0.01 cm-1 (1 and 4), on
# an NVIDIA H100 80GB HBM3.
PEAKS = [(CELLS["col60-0p1.sites8"][:3], 60, 5561363968),
         (CELLS["col60-0p1.sites8"][:3], 240, 22217774592),
         (CELLS["col60-0p1.sites8"][:3], 480, 44445595648),
         (CELLS["col60-0p01.sites8"][:3], 60, 12853595648),
         (CELLS["col60-0p01.sites8"][:3], 240, 51395015168)]
# block_budget on an idle H100 80GB HBM3 (84.2 GB free).
H100_BUDGET = 71.58e9


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A tiny two-site cell of the blocked configuration (5 layers, so
    10 states, over 1-150 cm-1), its inputs, a request and the
    Database."""
    cell = tiny_cell("col60-0p01.sites8", sites=2)
    cfg = cell.config
    cfg["layers"] = 5
    cfg["grid"]["stop"] = 150.0
    cfg["lines"].update(counts={k: 600 if k == "H2O" else 60
                                for k in cfg["lines"]["counts"]},
                        nu_max=200.0, first_band=20.0, band_step=15.0)
    inp = inputs.make(cell.config, 2 ** 33 + 5)
    db = Database(tmp_path_factory.mktemp("blocks") / "lines.sqlite")
    for name, lines in inp.lines.items():
        db.ingest_line_pack(LinePack(formula=name, **lines))
    return cell, inp, inp.request(2), db


@pytest.fixture(scope="module")
def whole(case):
    """One unblocked call's output in each format."""
    return {f: compute(case, f) for f in ("total", "gas")}


def compute(case, output_format):
    import pylbl_tpu_torch as P

    _, inp, req, db = case
    s = P.Spectroscopy(system.dataset(P, req.atmosphere), inp.grid, db,
                       device_mechanisms=True, device="cpu")
    return s.compute_absorption(output_format=output_format,
                                remove_pedestal=False)


def force_states(monkeypatch, states):
    """The planner's budget forced to ``states`` states a block."""
    monkeypatch.setattr(module, "block_bytes", lambda *a: (1, 0))
    monkeypatch.setattr(module, "block_budget", lambda device: states)


@pytest.mark.parametrize("states,sizes", [(1, [1] * 10), (3, [3, 3, 3, 1]),
                                          (7, [5, 5])])
@pytest.mark.parametrize("output_format", ["total", "gas"])
def test_blocks_equal_one_call(case, whole, monkeypatch, output_format,
                               states, sizes):
    whole = whole[output_format]
    force_states(monkeypatch, states)
    assert [hi - lo for lo, hi in module.plan_blocks(10, 1, 0, states)] \
        == sizes
    metrics.reset()
    blocked = compute(case, output_format)
    assert metrics.snapshot()["counters"]["absorption.blocks"] == len(sizes)
    assert set(blocked.data_vars) == set(whole.data_vars)
    for name in whole.data_vars:
        got, want = blocked[name].data, whole[name].data
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name


def test_blocks_match_the_reference(case, monkeypatch):
    """Three states a block against the benchmark's plain float64
    reference, within the bound lblbench's reference test holds the
    float32 path to."""
    cell, inp, req, _ = case
    force_states(monkeypatch, 3)
    got = np.asarray(compute(case, "total")["absorption"].data).reshape(
        req.atmosphere.num_states, -1)
    (ref, _), = lbl.totals(cell.config, inp.lines,
                           [(req.atmosphere, req.state, req.point)],
                           inp.grid)
    rel = np.abs(got[req.state, req.point] - ref) / ref
    assert rel.max() < cell.limits["rel_err"] / 3


def test_the_planner_splits_only_what_does_not_fit():
    """One block for the cells that ran whole before blocking; 2 for 8
    sites at 0.01 cm-1 on an 80 GB card; the model above every measured
    peak."""
    for name, (lines, flat, grid, states) in CELLS.items():
        state, fixed = module.block_bytes(lines, flat, grid, 1, 4)
        blocks = module.plan_blocks(states, state, fixed, H100_BUDGET)
        assert len(blocks) == (2 if name == "col60-0p01.sites8" else 1), name
        assert blocks[0][0] == 0 and blocks[-1][1] == states
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for (lines, flat, grid), states, peak in PEAKS:
        state, fixed = module.block_bytes(lines, flat, grid, 1, 4)
        assert peak < states * state + fixed < 1.25 * peak
    assert spec.cell(ROOT, "col60-0p01.sites8").config["sites"] == 8


def test_plan_blocks_edges():
    assert module.plan_blocks(7, 10, 0, None) == [(0, 7)]
    assert module.plan_blocks(7, 10, 5, 75) == [(0, 7)]
    assert module.plan_blocks(7, 10, 5, 74) == [(0, 4), (4, 7)]
    # Not one state fits: one a block, which may still fail.
    assert module.plan_blocks(3, 10, 50, 20) == [(0, 1), (1, 2), (2, 3)]
    assert module.plan_blocks(0, 10, 0, 5) == [(0, 0)]
