"""The line-shape work that a cell's inputs need, counted from the inputs
alone, and the H100's peaks it is held against.

A frozen copy of the port's counting (``pylbl_tpu_torch/tools``:
``window_evals``, ``CENSUS_OPS``, ``census_ops``, ``PEAK_OPS``,
``PEAK_BYTES``), rewritten to read nothing but the line lists, the layers
and the grid: never the program's plans, pieces or launch counters, so the
count stays the same whatever implements the work.

Per layer and line:

- the wings: every grid point of the line's window, clamped to the grid,
  at ``OPS_LORENTZ`` operations (x, x^2 + y^2, the reciprocal, the
  product and the add);
- the core: every window point with |x| < xlim0 (and y < 70.55), the
  points where the Voigt function departs from the Lorentzian, by the
  Humlicek region that evaluates it, at ``CENSUS_OPS`` operations, and
  once for each line with such a point its region limits (``OPS_LIMITS``,
  or ``OPS_K1_LIMIT`` where y >= 8.425 leaves only region 1);
- bytes: each line's eight float32 parameters and each layer's
  temperature, pressure and mole fractions read once, the float32 cross
  sections of every gas at every internal grid point written once.

The least time is the larger of the operations over ``PEAK_OPS`` and the
bytes over ``PEAK_BYTES``.
"""
import numpy as np
import torch

from ..reference.constants import PA_TO_ATM, R2, SQRT_LN2, T_REF, VLIGHT
from ..reference.lbl import internal_grid, kept

# NVIDIA H100 SXM (data sheet, at its 700 W limit): FP32 outside the tensor
# cores, and HBM3 bytes a second.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_LORENTZ = 7
# Operations per point that needs a correction, by Humlicek region (x, the
# region's body, the Lorentzian and the difference for the regions, the
# product with the prefactor and the add), counted from the port's
# csrc/lineshape.cu; divides and exp count as one each.
CENSUS_OPS = {"k1": 23, "r1": 24, "r2": 57, "r3": 140, "cpf12": 246}
OPS_LIMITS = 17
OPS_K1_LIMIT = 5
LINE_FIELDS = 8
# Layers counted at once.
LAYERS_PER_BLOCK = 8


def points_within(center, radius, lo, hi):
    """Integer points j in (center - radius, center + radius) and in [lo,
    hi]."""
    first = torch.maximum(torch.floor(center - radius) + 1, lo)
    last = torch.minimum(torch.ceil(center + radius) - 1, hi)
    return torch.clamp(last - first + 1, min=0)


def line_work(lines, grid, cut_off, t, p, x, device="cpu"):
    """{"lorentz", "k1", "r1", "r2", "r3", "cpf12", "k1_lines",
    "region_lines"} of one gas's lines over layers ``t``, ``p``, ``x``
    (arrays of one entry a layer)."""
    v0, vn, n_per_v, n = internal_grid(grid)
    keep = kept(lines["nu"], v0, vn, cut_off)
    out = dict.fromkeys(("lorentz", "k1", "r1", "r2", "r3", "cpf12",
                         "k1_lines", "region_lines"), 0.0)
    if keep == 0:
        return out
    dev = {k: torch.as_tensor(v[:keep], dtype=torch.float64, device=device)
           for k, v in lines.items()
           if k in ("nu", "gamma_air", "gamma_self", "n_air", "delta_air")}
    mass = torch.as_tensor(lines["mass_slots"][lines["iso"][:keep] - 1],
                           device=device)
    for lo in range(0, len(t), LAYERS_PER_BLOCK):
        tk, pa, xg = (torch.as_tensor(np.asarray(a[lo:lo + LAYERS_PER_BLOCK],
                                                 np.float64),
                                      device=device)[:, None]
                      for a in (t, p, x))
        p_atm = pa * PA_TO_ATM
        shifted = dev["nu"] + p_atm * dev["delta_air"]
        bucket = torch.floor(shifted)
        w_lo = torch.clamp((bucket - cut_off - v0) * n_per_v, 0, n - 1)
        w_hi = torch.clamp((bucket + cut_off + 1 - v0) * n_per_v, 0, n - 1)
        out["lorentz"] += float(torch.clamp(w_hi - w_lo + 1, min=0).sum())
        gamma = (dev["gamma_air"] * (p_atm - p_atm * xg)
                 + dev["gamma_self"] * p_atm * xg) \
            * (T_REF / tk) ** dev["n_air"]
        repwid = SQRT_LN2 / ((dev["nu"] / VLIGHT)
                             * torch.sqrt(R2 * tk / mass))
        y = repwid * gamma
        step = repwid / n_per_v        # x per grid point
        center = (shifted - v0) * n_per_v

        def within(limit):
            return points_within(center, torch.clamp(limit, min=0.0) / step,
                                 w_lo, w_hi)

        live = y < 70.55
        k1 = live & (y >= 8.425)
        regions = live & ~k1
        xlim0 = torch.sqrt(torch.clamp(15100.0 + y * (40.0 - y * 3.6),
                                       min=0.0))
        tiny = y <= 1.0e-6
        xlim1 = torch.where(tiny, xlim0, torch.sqrt(torch.clamp(
            164.0 - y * (4.3 + y * 1.8), min=0.0)))
        xlim2 = torch.where(tiny, xlim0, torch.minimum(
            torch.clamp(6.8 - y, min=0.0), xlim1))
        xlim3 = torch.minimum(2.4 * y, xlim2)
        n0, n1, n2, n3 = (within(lim) for lim in (xlim0, xlim1, xlim2, xlim3))
        zero = torch.zeros_like(n0)
        out["k1"] += float(torch.where(k1, n0, zero).sum())
        out["r1"] += float(torch.where(regions, n0 - n1, zero).sum())
        out["r2"] += float(torch.where(regions, n1 - n2, zero).sum())
        out["r3"] += float(torch.where(regions, n3, zero).sum())
        out["cpf12"] += float(torch.where(regions, n2 - n3, zero).sum())
        out["k1_lines"] += float((k1 & (n0 > 0)).sum())
        out["region_lines"] += float((regions & (n0 > 0)).sum())
    return out


def work(config, lines, atmosphere, grid, device="cpu"):
    """The line-shape work of one call over the whole atmosphere: the
    counts of :func:`line_work` summed over the gases, with "operations",
    "bytes" and "seconds" (the least time at the peaks) and "bound"
    ("operations" or "bytes")."""
    t, p, vmr = atmosphere.flat()
    total = {}
    for name, gas_lines in lines.items():
        for key, value in line_work(gas_lines, grid, config["cut_off"], t, p,
                                    vmr[name], device).items():
            total[key] = total.get(key, 0.0) + value
    ops = OPS_LORENTZ * total["lorentz"] \
        + sum(CENSUS_OPS[k] * total[k] for k in CENSUS_OPS) \
        + OPS_LIMITS * total["region_lines"] + OPS_K1_LIMIT * total["k1_lines"]
    v0, vn, _, n = internal_grid(grid)
    num_lines = sum(kept(v["nu"], v0, vn, config["cut_off"])
                    for v in lines.values())
    layers = t.size
    nbytes = 4 * (LINE_FIELDS * num_lines + layers * (2 + len(vmr))
                  + layers * len(lines) * n)
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    total.update(operations=ops, bytes=nbytes, seconds=max(t_ops, t_bytes),
                 bound="operations" if t_ops >= t_bytes else "bytes")
    return total
