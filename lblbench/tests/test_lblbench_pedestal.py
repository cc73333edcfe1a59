"""The reference's pedestal (``lbl.pedestals``, kept at the window endpoints
alone) against the reference's C loop written out over every grid point,
on line lists where the order of the lines matters."""
import numpy as np
import pytest
import torch

from lblbench.harness import inputs
from lblbench.reference import lbl

CUT_OFF = 25


def c_loop(lines, grid, t, p, x):
    """[layers, points]: one gas's cross section by the loop of spectra.c,
    literally: for each line in list order and each layer, its terms added
    over its window [s, e] clamped to the grid, then min(k[s], k[e])
    subtracted over [s, e]; a window that misses the grid is skipped."""
    v0, vn, n_per_v, n = lbl.internal_grid(grid)
    keep = lbl.kept(lines["nu"], v0, vn, CUT_OFF)
    dev = lbl._device_lines(lines, keep, "cpu")
    dev.update(q_t=torch.as_tensor(lbl.partition(lines, t)),
               t=torch.as_tensor(t), p=torch.as_tensor(p),
               x=torch.as_tensor(x))
    layer = torch.arange(t.size)[:, None, None]
    line = torch.arange(keep)[None, :, None]
    prm = lbl._line_params(dev, line, layer, CUT_OFF, v0, n_per_v)
    j = torch.arange(n, dtype=torch.float64)
    terms = lbl._terms(prm, j, torch.ones(1, dtype=torch.bool), v0,
                       n_per_v, torch.float64).numpy()
    start, end = prm["start"][..., 0].long(), prm["end"][..., 0].long()
    k = np.zeros((t.size, n))
    for i in range(keep):
        for lay in range(t.size):
            s, e = int(start[lay, i]), int(end[lay, i])
            if s >= n or e < 0:
                continue
            s, e = max(s, 0), min(e, n - 1)
            k[lay, s:e + 1] += terms[lay, i, s:e + 1]
            pedestal = min(k[lay, s], k[lay, e])
            k[lay, s:e + 1] -= pedestal
    return k


def reference(lines, grid, t, p, x):
    """(with the pedestal, before it): the reference's cross section at
    every grid point of every layer."""
    n = lbl.internal_grid(grid)[3]
    ped = lbl.pedestals(lines, grid, CUT_OFF, t, p, x, "float64", "cpu")
    layer = np.repeat(np.arange(t.size), n)
    k, taken = lbl.cross_section(lines, grid, CUT_OFF, t[layer], p[layer],
                                 x[layer], np.tile(np.arange(n), t.size),
                                 "float64", "cpu", ped, layer)
    return ((k - taken).numpy().reshape(t.size, n),
            k.numpy().reshape(t.size, n))


def lines_at(nu, seed, delta=None):
    """A line list of the repository's fixture, at the positions ``nu``
    (sorted), with pressure shifts ``delta`` where given."""
    rng = np.random.default_rng(seed)
    lines = inputs.line_list(rng, np.random.default_rng([seed, 1]), nu.size,
                             1.0, 2.0, 3, (), 1.0)
    lines["nu"] = np.sort(nu)
    lines["sw"] = 10.0 ** rng.uniform(-22.0, -20.0, size=nu.size)
    if delta is not None:
        lines["delta_air"] = delta
    return lines


LAYERS = {"t": np.array([210.0, 255.0, 300.0]),
          "p": np.array([2.0e3, 3.0e4, 1.0e5]),
          "x": np.array([0.004, 0.01, 0.02])}

CASES = {
    # 40 lines in one wavenumber over a sparse background: each line's
    # window starts where the others' did.
    "cluster": (np.arange(1.0, 121.0, 0.1),
                np.concatenate([np.random.default_rng(5).uniform(60.2, 60.9,
                                                                 40),
                                np.linspace(2.5, 118.5, 30)])),
    # A grid narrower than a window: every window is clamped at both
    # edges, and lines before and past the grid (some missing it).
    "clamped": (np.arange(1.0, 31.0, 0.1),
                np.concatenate([np.random.default_rng(6).uniform(-20.0, 5.0,
                                                                 25),
                                np.random.default_rng(7).uniform(5.0, 30.0,
                                                                 25),
                                np.array([40.0, 50.5, 56.2, 56.8])])),
    # A whole-wavenumber grid, and n_per_v 4.
    "coarse": (np.arange(1.0, 80.0, 1.0),
               np.random.default_rng(8).uniform(0.5, 82.0, 60)),
    "quarter": (np.arange(1.0, 70.0, 0.25),
                np.random.default_rng(9).uniform(0.5, 80.0, 60)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pedestal_equals_the_c_loop(case):
    grid, nu = CASES[case]
    lines = lines_at(nu, 11)
    want = c_loop(lines, grid, **LAYERS)
    got, before = reference(lines, grid, **LAYERS)
    assert np.abs(got - want).max() <= 1e-12 * before.max()
    # The pedestal is no small correction here: somewhere it takes out
    # most of the field.
    assert (np.abs(before - got) > 0.5 * before).any()


def test_pedestal_follows_each_layers_window():
    """Lines just above a whole wavenumber whose pressure shift moves
    their window down a wavenumber in the denser layers only."""
    grid = np.arange(1.0, 90.0, 0.1)
    nu = np.concatenate([np.arange(10.004, 80.0, 3.0),
                         np.random.default_rng(3).uniform(0.5, 95.0, 30)])
    order = np.argsort(nu)
    delta = np.where(nu % 1.0 < 0.01, -0.02, 0.01)[order]
    lines = lines_at(nu, 12, delta)
    layers = {"t": np.array([220.0, 260.0, 290.0, 296.0]),
              "p": np.array([5.0e2, 2.0e4, 6.0e4, 1.0e5]),
              "x": np.array([0.001, 0.003, 0.01, 0.02])}
    v0, _, n_per_v, _ = lbl.internal_grid(grid)
    shifted = lines["nu"][None, :] + layers["p"][:, None] \
        * lbl.PA_TO_ATM * lines["delta_air"][None, :]
    bucket = np.floor(shifted)
    assert ((bucket != bucket[:1]).any(axis=0)).sum() >= 10
    want = c_loop(lines, grid, **layers)
    got, before = reference(lines, grid, **layers)
    assert np.abs(got - want).max() <= 1e-12 * before.max()


def test_bfloat16_pedestal_is_a_precision_lower():
    """The control's pedestal (bfloat16 terms, float32 sums) is the same
    loop a precision lower: near the float64 one, not equal to it."""
    grid, nu = CASES["cluster"]
    lines = lines_at(nu, 13)
    ped64 = lbl.pedestals(lines, grid, CUT_OFF, *LAYERS.values(), "float64",
                          "cpu")
    ped16 = lbl.pedestals(lines, grid, CUT_OFF, *LAYERS.values(),
                          "bfloat16", "cpu")
    assert ped16.dtype == np.float32
    gap = np.abs(ped16 - ped64).max() / np.abs(ped64).max()
    assert 1e-5 < gap < 0.1
