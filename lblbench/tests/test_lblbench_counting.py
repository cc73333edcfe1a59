"""The frozen count of the line-shape work against counts made point by
point."""
import numpy as np
import pytest
import torch

from lblbench.harness import counting, inputs
from lblbench.reference import lbl
from lblbench.tests.tiny import tiny_cell


def brute(lines, grid, cut_off, t, p, x):
    """Per region, the window points of every line counted one by one, the
    region of each chosen as the reference's Voigt function chooses it."""
    v0, vn, n_per_v, n = counting.internal_grid(grid)
    keep = counting.kept(lines["nu"], v0, vn, cut_off)
    out = dict.fromkeys(("lorentz", "k1", "r1", "r2", "r3", "cpf12",
                         "k1_lines", "region_lines"), 0)
    c = counting
    for i in range(keep):
        nu = lines["nu"][i]
        p_atm = p * c.PA_TO_ATM
        shifted = nu + p_atm * lines["delta_air"][i]
        b = np.floor(shifted)
        lo = int(np.clip((b - cut_off - v0) * n_per_v, 0, n - 1))
        hi = int(np.clip((b + cut_off + 1 - v0) * n_per_v, 0, n - 1))
        j = np.arange(lo, hi + 1)
        out["lorentz"] += j.size
        gamma = (lines["gamma_air"][i] * (p_atm - p_atm * x)
                 + lines["gamma_self"][i] * p_atm * x) \
            * (c.T_REF / t) ** lines["n_air"][i]
        mass = lines["mass_slots"][lines["iso"][i] - 1]
        repwid = c.SQRT_LN2 / ((nu / c.VLIGHT) * np.sqrt(c.R2 * t / mass))
        y = repwid * gamma
        ax = np.abs((j - (shifted - v0) * n_per_v) * repwid / n_per_v)
        if y >= 70.55:
            continue
        xlim0 = np.sqrt(max(15100.0 + y * (40.0 - y * 3.6), 0.0))
        need = ax < xlim0
        if not need.any():
            continue
        if y >= 8.425:
            out["k1"] += int(need.sum())
            out["k1_lines"] += 1
            continue
        out["region_lines"] += 1
        xlim1 = np.sqrt(max(164.0 - y * (4.3 + y * 1.8), 0.0))
        xlim2 = 6.8 - y
        if y <= 1e-6:
            xlim1 = xlim2 = xlim0
        r1 = need & (ax >= xlim1)
        r2 = need & ~r1 & (ax >= xlim2)
        rest = need & ~r1 & ~r2
        r3 = rest & (ax < 2.4 * y)
        out["r1"] += int(r1.sum())
        out["r2"] += int(r2.sum())
        out["r3"] += int(r3.sum())
        out["cpf12"] += int((rest & ~r3).sum())
    return out


@pytest.mark.parametrize("step", [0.1, 0.01])
def test_line_work_counts_every_point(step):
    cell = tiny_cell("col60-0p1.column")
    cell.config["grid"]["step"] = step
    cell.config["lines"]["counts"] = {"H2O": 300, "CO2": 40}
    lines = inputs.line_lists(cell.config, 11)
    grid = inputs.user_grid(cell.config)
    for t, p, x in ((288.9, 98388.0, 6.6e-3), (220.0, 117.0, 5e-6)):
        for gas in lines.values():
            got = counting.line_work(gas, grid, 25, [t], [p], [x])
            want = brute(gas, grid, 25, t, p, x)
            assert got == pytest.approx({k: float(v) for k, v in
                                         want.items()}, abs=0)


def test_one_line_window_by_hand():
    """A line at 100.05 cm-1 on 1-300 cm-1 at 0.1: its window runs from
    (100 - 25 - 1) x 10 to (100 + 26 - 1) x 10, 511 points; at the grid's
    edge it is cut to the grid."""
    grid = np.arange(1.0, 300.0, 0.1)
    one = {"nu": np.array([100.05]), "gamma_air": np.array([0.07]),
           "gamma_self": np.array([0.3]), "n_air": np.array([0.7]),
           "delta_air": np.array([0.0]), "iso": np.array([1]),
           "mass_slots": np.full(32, 18.0)}
    assert counting.line_work(one, grid, 25, [296.0], [101325.0],
                              [0.0])["lorentz"] == 511
    one["nu"] = np.array([10.5])
    assert counting.line_work(one, grid, 25, [296.0], [101325.0],
                              [0.0])["lorentz"] == (10 + 26 - 1) * 10 + 1


def test_points_within_by_hand():
    c = torch.tensor([5.5, 5.0, 0.2])
    r = torch.tensor([2.0, 2.0, 10.0])
    lo = torch.tensor([0.0, 0.0, 0.0])
    hi = torch.tensor([100.0, 100.0, 3.0])
    # (3.5, 7.5) holds 4..7; (3, 7) holds 4..6; (-9.8, 10.2) within [0, 3].
    assert counting.points_within(c, r, lo, hi).tolist() == [4, 3, 4]


def test_work_sums_gases_and_counts_bytes():
    cell = tiny_cell("col60-0p1.column")
    inp = inputs.make(cell.config, 5)
    atm = inp.request(0).atmosphere
    w = counting.work(cell.config, inp.lines, atm, inp.grid)
    t, p, vmr = atm.flat()
    lorentz = sum(counting.line_work(g, inp.grid, 25, t, p, vmr[n])["lorentz"]
                  for n, g in inp.lines.items())
    assert w["lorentz"] == lorentz
    v0, vn, _, n = lbl.internal_grid(inp.grid)
    keep = sum(lbl.kept(g["nu"], v0, vn, 25) for g in inp.lines.values())
    assert w["bytes"] == 4 * (8 * keep + t.size * (2 + len(vmr))
                              + t.size * len(inp.lines) * n)
    assert w["seconds"] == max(w["operations"] / counting.PEAK_OPS,
                               w["bytes"] / counting.PEAK_BYTES)
