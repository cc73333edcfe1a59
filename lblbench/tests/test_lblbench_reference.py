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


def port_total(inp, atm, dtype, tmp_path):
    import pylbl_tpu_torch as P
    from pylbl_tpu_torch.models.lines.physics import LinePack

    db = P.Database(tmp_path / "lines.sqlite")
    for name, lines in inp.lines.items():
        db.ingest_line_pack(LinePack(formula=name, **lines))
    s = P.Spectroscopy(system.dataset(P, atm), inp.grid, db,
                       device_mechanisms=True, device="cpu", dtype=dtype,
                       backend="plain")
    out = s.compute_absorption(output_format="total", remove_pedestal=False)
    return np.asarray(out["absorption"].data).reshape(atm.num_states, -1)


@pytest.mark.parametrize("name", ["col60-0p1.sites8", "col60-0p01.column"])
def test_reference_against_the_ports_plain_path(name, tmp_path):
    """In float64 the port's plain path agrees with the reference to the
    float32 rounding of its line constants (about 1e-7); in float32 well
    inside the cell's limit."""
    cell = tiny_cell(name, sites=2 if "sites" in name else None)
    inp = inputs.make(cell.config, 2 ** 33 + 1)
    req = inp.request(3)
    ref = lbl.absorption(cell.config, inp.lines, req.atmosphere, inp.grid,
                         req.state, req.point)
    got64 = port_total(inp, req.atmosphere, torch.float64, tmp_path)
    assert np.abs(got64[req.state, req.point] - ref).max() \
        <= 1e-6 * ref.max()
    assert (np.abs(got64[req.state, req.point] - ref) / ref).max() < 1e-6
    (tmp_path / "f32").mkdir()
    got32 = port_total(inp, req.atmosphere, torch.float32, tmp_path / "f32")
    rel = np.abs(got32[req.state, req.point] - ref) / ref
    assert rel.max() < cell.limits["rel_err"] / 3


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
