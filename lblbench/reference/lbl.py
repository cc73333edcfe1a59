"""The plain reference of the line-by-line configurations: the total
absorption [m-1] of a layer at chosen grid points, in float64.

It follows the reference pyLBL (GRIPS-code/pyLBL), whose semantics the
program reproduces, point by point and line by line:

- the internal grid v0 = round(first), n_per_v = round(1 / step) points a
  wavenumber (c_lib/gas_optics.py);
- a molecule's lines are taken in wavenumber order up to the first one
  outside [v0 - cut - 1, vn + cut + 1], vn = round(last) + 1 (the C loop
  breaks there, absorption.c);
- each line's strength scaled to the layer's temperature with the
  partition function interpolated on its 1 K table, its Lorentz width
  from air and self broadening, its Doppler width and its pressure shift
  (spectra.c);
- its window of points from (floor(shifted centre) - cut - v0) n_per_v to
  (floor(shifted centre) + cut + 1 - v0) n_per_v, both ends included
  (spectra.c);
- the Voigt function K(x, y) by the regions of Humlicek's W4 and CPF12
  (voigt.c): the Lorentzian beyond xlim0 and for y >= 70.55, W4's three
  rationals and CPF12's two sums inside;
- each gas's cross section times its number density p x / (kB T), summed
  over the gases, plus the MT-CKD continua (mtckd.py).

Everything is worked out here from the line lists and the layers: nothing
of the program is imported or read.  ``precision`` chooses the arithmetic:
"float64" is the reference; "bfloat16" is the control, the same sums with
each line's x, y and prefactor rounded to bfloat16, the Voigt function and
the terms in bfloat16, the sums in float32 and the continua in float32
(the step below each precision the configuration states).
"""
import numpy as np
import torch

from . import mtckd
from .constants import (C2, KB, PA_TO_ATM, R2, RSQRPI, SQRT_LN2, T_REF,
                        VLIGHT)

# (line-term dtype, accumulation dtype, continua dtype) by precision.
PRECISIONS = {"float64": (torch.float64, torch.float64, np.float64),
              "bfloat16": (torch.bfloat16, torch.float32, np.float32)}
# Line-point pairs evaluated at once.
PAIRS_PER_BLOCK = 1 << 22

_CPF12_C = (1.0117281, -0.75197147, 0.012557727, 0.010022008,
            -0.00024206814, 0.00000050084806)
_CPF12_S = (1.393237, 0.23115241, -0.15535147, 0.0062183662,
            0.000091908299, -0.00000062752596)
_CPF12_T = (0.31424038, 0.94778839, 1.5976826, 2.2795071, 3.0206370,
            3.8897249)


def _poly(y, coeffs):
    """coeffs[0] + y (coeffs[1] + y (...)), Horner's order."""
    out = torch.full_like(y, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        out = c + y * out
    return out


def voigt(x, y):
    """K(x, y) of Humlicek's W4 regions and CPF12, the region of each point
    chosen as the reference's voigt.c chooses it."""
    ax = x.abs()
    xq = ax * ax
    yq = y * y
    xlim0 = torch.sqrt(torch.clamp(15100.0 + y * (40.0 - y * 3.6), min=0.0))
    xlim1 = torch.where(y >= 8.425, torch.zeros_like(y), torch.sqrt(
        torch.clamp(164.0 - y * (4.3 + y * 1.8), min=0.0)))
    xlim2 = 6.8 - y
    tiny = y <= 1.0e-6
    xlim1 = torch.where(tiny, xlim0, xlim1)
    xlim2 = torch.where(tiny, xlim0, xlim2)
    out = torch.empty_like(x)

    r0 = (y >= 70.55) | (ax >= xlim0)
    out[r0] = (y[r0] * RSQRPI) / (xq[r0] + yq[r0])
    r1 = ~r0 & (ax >= xlim1)
    q, w, wq = xq[r1], y[r1], yq[r1]
    a0 = wq + 0.5
    out[r1] = RSQRPI * w * (a0 + q) / (a0 * a0 + q * (wq + wq - 1.0 + q))
    r2 = ~r0 & ~r1 & (ax >= xlim2)
    q, w, wq = xq[r2], y[r2], yq[r2]
    h0 = 0.5625 + wq * (4.5 + wq * (10.5 + wq * (6.0 + wq)))
    h2 = -4.5 + wq * (9.0 + wq * (6.0 + wq * 4.0))
    h4 = 10.5 - wq * (6.0 - wq * 6.0)
    h6 = -6.0 + wq * 4.0
    e0 = 1.875 + wq * (8.25 + wq * (5.5 + wq))
    e2 = 5.25 + wq * (1.0 + wq * 3.0)
    out[r2] = (w * (e0 + q * (e2 + q * (0.75 * h6 + q))) * RSQRPI
               / (h0 + q * (h2 + q * (h4 + q * (h6 + q)))))
    rest = ~r0 & ~r1 & ~r2
    r3 = rest & (ax < 2.4 * y)
    q, w = xq[r3], y[r3]
    z = [_poly(w, c) for c in (
        (272.1014, 1280.829, 2802.870, 3764.966, 3447.629, 2256.981,
         1074.409, 369.1989, 88.26741, 13.39880, 1.0),
        (211.678, 902.3066, 1758.336, 2037.310, 1549.675, 793.4273,
         266.2987, 53.59518, 5.0),
        (78.86585, 308.1852, 497.3014, 479.2576, 269.2916, 80.39278, 10.0),
        (22.03523, 55.02933, 92.75679, 53.59518, 10.0),
        (1.496460, 13.39880, 5.0))]
    p = [_poly(w, c) for c in (
        (153.5168, 549.3954, 919.4955, 946.8970, 662.8097, 328.2151,
         115.3772, 27.93941, 4.264678, 0.3183291),
        (-34.16955, -1.322256, 124.5975, 189.7730, 139.4665, 56.81652,
         12.79458, 1.2733163),
        (2.584042, 10.46332, 24.01655, 29.81482, 12.79568, 1.9099744),
        (-0.07272979, 0.9377051, 4.266322, 1.273316),
        (0.0005480304, 0.3183291))]
    den = z[0] + q * (z[1] + q * (z[2] + q * (z[3] + q * (z[4] + q))))
    num = p[0] + q * (p[1] + q * (p[2] + q * (p[3] + q * p[4])))
    out[r3] = 1.7724538 * num / den
    r4 = rest & ~r3
    out[r4] = _cpf12(x[r4], xq[r4], ax[r4], y[r4])
    return out


def _cpf12(x, xq, ax, y):
    """Humlicek's CPF12: region I within |x| <= 18.1 y + 1.65, II beyond."""
    ypy0 = y + 1.5
    ypy0q = ypy0 * ypy0
    yf = y + 3.0
    buf1 = torch.zeros_like(x)
    buf2 = torch.zeros_like(x)
    for c, s, t in zip(_CPF12_C, _CPF12_S, _CPF12_T):
        dm = x - t
        mq = dm * dm
        mf = 1.0 / (mq + ypy0q)
        xm, ym = mf * dm, mf * ypy0
        dp = x + t
        pq = dp * dp
        pf = 1.0 / (pq + ypy0q)
        xp, yp = pf * dp, pf * ypy0
        buf1 = buf1 + (c * (ym + yp) - s * (xm - xp))
        buf2 = buf2 + ((c * (mq * mf - 1.5 * ym) + s * yf * xm) / (mq + 2.25)
                       + (c * (pq * pf - 1.5 * yp) - s * yf * xp)
                       / (pq + 2.25))
    return torch.where(ax <= 18.1 * y + 1.65, buf1, y * buf2 + torch.exp(-xq))


def internal_grid(grid):
    """(v0, vn, n_per_v, points) of a user grid (c_lib/gas_optics.py)."""
    v0 = int(round(float(grid[0])))
    vn = int(round(float(grid[-1])) + 1)
    n_per_v = int(round(1.0 / (float(grid[1]) - float(grid[0]))))
    return v0, vn, n_per_v, (vn - v0) * n_per_v


def kept(nu, v0, vn, cut_off):
    """The number of lines the reference's loop takes: those before the
    first one outside [v0 - cut - 1, vn + cut + 1]."""
    outside = (nu > vn + cut_off + 1) | (nu < v0 - (cut_off + 1))
    return int(np.argmax(outside)) if outside.any() else nu.size


def partition(lines, t):
    """[len(t), isotopologues] Q(t): each isotopologue's table interpolated
    at each temperature on its uniform 1 K grid (spectral_database.c)."""
    table, temps = lines["q_table"], lines["q_temperature"]
    t = np.asarray(t, np.float64)
    t0 = int(temps[0])
    i = np.clip(np.floor(t).astype(np.int64) - t0, 0, table.shape[1] - 2)
    lo, hi = table[:, i], table[:, i + 1]
    return (lo + (hi - lo) * (t - (i + t0))).T


def blocks(count):
    """Slices of consecutive points whose line counts sum to at most
    ``PAIRS_PER_BLOCK`` (a point with more lines is a block alone)."""
    start = 0
    ends = np.cumsum(count)
    while start < count.size:
        base = ends[start - 1] if start else 0
        stop = max(start + 1, int(np.searchsorted(
            ends, base + PAIRS_PER_BLOCK, side="right")))
        yield slice(start, stop)
        start = stop


def cross_section(lines, grid, cut_off, t, p, x, points, precision,
                  device):
    """One gas's cross section [m2] at pairs of a layer and an internal
    grid point: ``t`` [K], ``p`` [Pa], ``x`` (the gas's mole fraction) and
    ``points`` (int) are arrays of one entry a pair.  Each is the sum of
    prefactor x K(x, y) over the lines whose window holds the point, the
    line's physics worked out for the pair's layer (spectra.c)."""
    term_dtype, sum_dtype, _ = PRECISIONS[precision]
    v0, vn, n_per_v, _ = internal_grid(grid)
    keep = kept(lines["nu"], v0, vn, cut_off)
    out = torch.zeros(points.size, dtype=sum_dtype, device=device)
    if keep == 0 or points.size == 0:
        return out
    nu = lines["nu"][:keep]
    # A line's window starts at its bucket floor(shifted centre); the shift
    # moves it by less than a wavenumber, so the lines with floor(nu) one
    # wider on each side are the candidates, and the exact test is below.
    floor_nu = np.floor(nu)
    lo = -(-points // n_per_v) + v0 - cut_off - 2
    hi = points // n_per_v + v0 + cut_off + 1
    first = np.searchsorted(floor_nu, lo, side="left")
    count = np.searchsorted(floor_nu, hi, side="right") - first
    slot = np.clip(lines["iso"][:keep] - 1, 0, lines["q_table"].shape[0] - 1)
    dev = {name: torch.as_tensor(value, device=device) for name, value in (
        ("nu", nu), ("sw", lines["sw"][:keep]),
        ("ga", lines["gamma_air"][:keep]), ("gs", lines["gamma_self"][:keep]),
        ("na", lines["n_air"][:keep]), ("da", lines["delta_air"][:keep]),
        ("el", lines["elower"][:keep]), ("slot", slot),
        ("mass", lines["mass_slots"][lines["iso"][:keep] - 1]),
        ("q_ref", partition(lines, [T_REF])[0]),
        ("q_t", partition(lines, t)), ("t", t), ("p", p), ("x", x),
        ("j", points.astype(np.float64)), ("first", first))}
    for blk in blocks(count):
        cnt = torch.as_tensor(count[blk], device=device)
        owner = torch.repeat_interleave(
            torch.arange(blk.start, blk.stop, device=device), cnt)
        line = dev["first"][owner] + torch.arange(
            owner.numel(), device=device) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt)
        tk, j = dev["t"][owner], dev["j"][owner]
        nu_l = dev["nu"][line]
        p_atm = dev["p"][owner] * PA_TO_ATM
        partial = p_atm * dev["x"][owner]
        shifted = nu_l + p_atm * dev["da"][line]
        bucket = torch.floor(shifted)
        inside = ((bucket - cut_off - v0) * n_per_v <= j) \
            & (j <= (bucket + cut_off + 1 - v0) * n_per_v)
        gamma = (dev["ga"][line] * (p_atm - partial)
                 + dev["gs"][line] * partial) \
            * (T_REF / tk) ** dev["na"][line]
        alpha = (nu_l / VLIGHT) * torch.sqrt(R2 * tk / dev["mass"][line])
        slot_l = dev["slot"][line]
        strength = (dev["sw"][line]
                    * torch.exp(dev["el"][line] * C2 * (tk - T_REF)
                                / (tk * T_REF))
                    * (1.0 - torch.exp(-C2 * nu_l / tk))
                    / (1.0 - torch.exp(-C2 * nu_l / T_REF))
                    * dev["q_ref"][slot_l] / dev["q_t"][owner, slot_l]
                    * 1e-4)
        repwid = SQRT_LN2 / alpha
        xs = ((v0 + j / n_per_v - shifted) * repwid).to(term_dtype)
        ys = (repwid * gamma).to(term_dtype)
        pref = (strength * RSQRPI * repwid).to(term_dtype)
        terms = torch.where(inside, pref * voigt(xs, ys),
                            torch.zeros_like(xs))
        out.index_add_(0, owner, terms.to(sum_dtype))
    return out


def absorption(config, lines, atmosphere, grid, state, point,
               precision="float64", device="cpu"):
    """Total absorption [m-1] at (state, point) pairs: the density-weighted
    cross sections of every gas with lines plus the continua, as float64
    numpy (computed in ``precision``)."""
    _, sum_dtype, cont_dtype = PRECISIONS[precision]
    t_all, p_all, vmr_all = atmosphere.flat()
    t, p = t_all[state], p_all[state]
    total = torch.zeros(state.size, dtype=sum_dtype, device=device)
    for name, gas_lines in lines.items():
        x = vmr_all[name][state]
        k = cross_section(gas_lines, grid, config["cut_off"], t, p, x, point,
                          precision, device)
        density = torch.as_tensor(p * x / (KB * t), device=device)
        total += k * density.to(sum_dtype)
    out = total.double().cpu().numpy()
    tables = mtckd.Tables(cont_dtype)
    for s in np.unique(state):
        where = np.flatnonzero(state == s)
        vmr = {g: float(v[s]) for g, v in vmr_all.items()}
        out[where] += mtckd.continua(tables, grid[point[where]],
                                     float(t_all[s]), float(p_all[s]), vmr)
    return out
