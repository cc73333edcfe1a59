"""The plain reference against the port's plain path, and the control
against the limits, at a size the CPU holds."""
import json
import time

import numpy as np
import pytest
import torch

from lblbench.harness import inputs, main, spec, system
from lblbench.harness.control import Control
from lblbench.reference import lbl
from lblbench.tests.tiny import ROOT, run, tiny_cell

CELLS = [w["name"] for w in spec.load(ROOT)["workloads"]]


def port_total(inp, atm, dtype, tmp_path, remove_pedestal=False):
    import pylbl_tpu_torch as P
    from pylbl_tpu_torch.models.lines.physics import LinePack

    db = P.Database(tmp_path / "lines.sqlite")
    for name, lines in inp.lines.items():
        db.ingest_line_pack(LinePack(formula=name, **lines))
    s = P.Spectroscopy(system.dataset(P, atm), inp.grid, db,
                       device_mechanisms=True, device="cpu", dtype=dtype,
                       backend="plain")
    out = s.compute_absorption(output_format="total",
                               remove_pedestal=remove_pedestal)
    return np.asarray(out["absorption"].data).reshape(atm.num_states, -1)


@pytest.mark.parametrize("name", ["col60-0p1.sites8", "col60-0p01.column",
                                  "col60-0p1.default"])
def test_reference_against_the_ports_plain_path(name, tmp_path):
    """In float64 the port's plain path agrees with the reference to the
    float32 rounding of its line constants (about 1e-7); in float32 well
    inside the cell's limit.  Where the cell takes the pedestal out, both
    sides do, and the gap is over the cell's floored divisor."""
    cell = tiny_cell(name, sites=2 if "sites" in name else None)
    pedestal = spec.remove_pedestal(cell.config)
    inp = inputs.make(cell.config, 2 ** 33 + 1)
    req = inp.request(3)
    (ref, before), = lbl.totals(cell.config, inp.lines,
                                [(req.atmosphere, req.state, req.point)],
                                inp.grid, remove_pedestal=pedestal)
    scale = ref
    if pedestal:
        scale = np.maximum(np.abs(ref), cell.limits["rel_err_floor"] * before)
        assert (before > 0).all() and not np.array_equal(ref, before)
    got64 = port_total(inp, req.atmosphere, torch.float64, tmp_path,
                       pedestal)
    assert np.abs(got64[req.state, req.point] - ref).max() \
        <= 1e-6 * ref.max()
    assert (np.abs(got64[req.state, req.point] - ref) / scale).max() < 1e-6
    (tmp_path / "f32").mkdir()
    got32 = port_total(inp, req.atmosphere, torch.float32, tmp_path / "f32",
                       pedestal)
    rel = np.abs(got32[req.state, req.point] - ref) / scale
    assert rel.max() < cell.limits["rel_err"] / 3


def judge_before(got, ref, limit):
    """``main.judge`` as it was before it took a floor."""
    worst = []
    for g, r in zip(got, ref):
        if not (np.isfinite(r).all() and (r > 0).all()):
            raise RuntimeError("the reference is not finite and positive "
                               "at every checked point")
        rel = np.abs(np.asarray(g, np.float64) - r) / r
        worst.append(float(np.where(np.isfinite(rel), rel, np.inf).max()))
    checks = {"rel_err": {"value": max(worst), "limit": limit}}
    return checks, sum(w > limit for w in worst)


@pytest.mark.parametrize("name", ["col60-0p1.column", "col60-0p1.sites8",
                                  "col60-0p01.column"])
def test_judge_without_a_floor_is_unchanged(name, tmp_path):
    """A cell whose limits file has no floor is judged as before: the same
    numbers on a tiny run's calls, and the same refusal of a reference
    that is not finite and positive."""
    cell = tiny_cell(name, sites=2 if "sites" in name else None)
    assert "rel_err_floor" not in cell.limits
    inp = inputs.make(cell.config, 2 ** 31 + 11)
    sut = system.System(cell.config, cell.traffic, inp, tmp_path, "cpu")
    reqs = [inp.request(k) for k in (0, 1)]
    got = [sut(r)[r.state, r.point] for r in reqs]
    ref = lbl.totals(cell.config, inp.lines,
                     [(r.atmosphere, r.state, r.point) for r in reqs],
                     inp.grid)
    assert all(r0 is r for r, r0 in ref)
    refs = [r for r, _ in ref]
    # The calls as run, one point pushed over the limit, and one NaN.
    bad = [g.copy() for g in got]
    bad[1][7] *= 1.5
    bad[0][3] = np.nan
    for g in (got, bad):
        assert main.judge(g, ref, cell.limits) \
            == judge_before(g, refs, cell.limits["rel_err"])
    for fault in (0.0, -1.0, np.nan, np.inf):
        broken = [r.copy() for r in refs]
        broken[1][5] = fault
        with pytest.raises(RuntimeError):
            judge_before(got, broken, cell.limits["rel_err"])
        with pytest.raises(RuntimeError):
            main.judge(got, [(r, r) for r in broken], cell.limits)


def test_judge_with_a_floor():
    """With a floor the divisor is the larger of |reference| and phi x the
    reference before the pedestal; that reference has to be positive, the
    one after it need not be."""
    limits = {"rel_err": 1e-3, "rel_err_floor": 0.01}
    before = np.array([1.0, 2.0, 4.0, 8.0])
    ref = np.array([0.5, -0.001, 0.0, 8.0])
    got = ref + np.array([1e-4, 1e-4, 2e-4, 0.0])
    checks, failed = main.judge([got], [(ref, before)], limits)
    # Point 3: |0 - 2e-4| / (0.01 x 4).
    assert checks["rel_err"]["value"] == pytest.approx(2e-4 / 0.04)
    assert failed == 1
    checks, failed = main.judge([ref + 1e-5], [(ref, before)], limits)
    assert checks["rel_err"]["value"] == pytest.approx(1e-5 / 0.02)
    assert failed == 0
    with pytest.raises(RuntimeError):
        main.judge([got], [(ref, before * np.array([1, 1, 0, 1]))], limits)


def test_voigt_regions_by_hand():
    """K(0, y) of the Lorentzian region and far wings against their closed
    forms, and the region boundaries' continuity."""
    y = torch.tensor([80.0, 80.0], dtype=torch.float64)
    x = torch.tensor([0.0, 3.0], dtype=torch.float64)
    assert torch.allclose(lbl.voigt(x, y),
                          y / np.sqrt(np.pi) / (x * x + y * y))
    far = torch.tensor([200.0], dtype=torch.float64)
    small = torch.tensor([0.01], dtype=torch.float64)
    assert float(lbl.voigt(far, small)) == pytest.approx(
        0.01 / np.sqrt(np.pi) / (200.0 ** 2 + 1e-4), rel=1e-12)
    # K(0, y -> 0) is the Gaussian's peak, 1.
    assert float(lbl.voigt(torch.tensor([0.0], dtype=torch.float64),
                           torch.tensor([1e-7], dtype=torch.float64))) \
        == pytest.approx(1.0, rel=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    """The reference computed a precision lower, run in the program's place
    through the harness's own check, comes out not correct, on three seeds,
    and reads above three times the cell's limit."""
    cell = tiny_cell(name, sites=2 if "sites" in name else None)
    for seed in (3, 2 ** 31 + 3, 2 ** 32 + 3):
        result = run(cell, seed=seed, factory=Control)
        assert not result["correct"] and result["failed"] > 0
        assert result["checks"]["rel_err"]["value"] \
            > 3 * cell.limits["rel_err"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit_at_the_cells_size(name):
    """The same at the cell's own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell(ROOT, name)
    results = [main.run_cell(ROOT, cell, seed, 1.0, False, "cuda",
                             time.perf_counter(), Control)
               for seed in (1, 2 ** 31 + 1, 2 ** 32 + 1)]
    for result in results:
        assert not result["correct"] and result["failed"] > 0, \
            json.dumps(result["checks"])
