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
- with ``remove_pedestal`` (the reference API's default with MT-CKD), each
  line, in list order, then subtracts min(k[s], k[e]) of its gas's
  accumulated cross section k over its window [s, e] (spectra.c:66-78,
  :func:`pedestals`);
- each gas's cross section times its number density p x / (kB T), summed
  over the gases, plus the MT-CKD continua (mtckd.py).

Everything is worked out here from the line lists and the layers: nothing
of the program is imported or read.  ``precision`` chooses the arithmetic:
"float64" is the reference; "bfloat16" is the control, the same sums with
each line's x, y and prefactor rounded to bfloat16, the Voigt function and
the terms in bfloat16, the sums and the pedestal loop in float32 and the
continua in float32 (the step below each precision the configuration
states).
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


def _device_lines(lines, keep, device):
    """The first ``keep`` lines' parameters as tensors on ``device``."""
    slot = np.clip(lines["iso"][:keep] - 1, 0, lines["q_table"].shape[0] - 1)
    return {name: torch.as_tensor(value, device=device) for name, value in (
        ("nu", lines["nu"][:keep]), ("sw", lines["sw"][:keep]),
        ("ga", lines["gamma_air"][:keep]), ("gs", lines["gamma_self"][:keep]),
        ("na", lines["n_air"][:keep]), ("da", lines["delta_air"][:keep]),
        ("el", lines["elower"][:keep]), ("slot", slot),
        ("mass", lines["mass_slots"][lines["iso"][:keep] - 1]),
        ("q_ref", partition(lines, [T_REF])[0]))}


def _line_params(dev, line, layer, cut_off, v0, n_per_v):
    """Each (line, layer) pair's window and Voigt inputs in float64
    (spectra.c), ``line`` and ``layer`` broadcast against each other:
    ``dev`` holds the lines (:func:`_device_lines`) and each layer's
    ``t``, ``p``, ``x`` and ``q_t``.  The window is [start, end] in
    internal grid points, before clamping."""
    tk = dev["t"][layer]
    nu_l = dev["nu"][line]
    p_atm = dev["p"][layer] * PA_TO_ATM
    partial = p_atm * dev["x"][layer]
    shifted = nu_l + p_atm * dev["da"][line]
    bucket = torch.floor(shifted)
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
                * dev["q_ref"][slot_l] / dev["q_t"][layer, slot_l]
                * 1e-4)
    repwid = SQRT_LN2 / alpha
    return {"shifted": shifted, "repwid": repwid, "y": repwid * gamma,
            "pref": strength * RSQRPI * repwid,
            "start": (bucket - cut_off - v0) * n_per_v,
            "end": (bucket + cut_off + 1 - v0) * n_per_v}


def _terms(prm, j, inside, v0, n_per_v, term_dtype):
    """prefactor x K(x, y) at internal grid points ``j`` (float64) where
    ``inside``, 0 elsewhere, in ``term_dtype``; ``prm`` from
    :func:`_line_params`, broadcast against ``j``."""
    xs = ((v0 + j / n_per_v - prm["shifted"]) * prm["repwid"]).to(term_dtype)
    ys = prm["y"].to(term_dtype)
    pref = prm["pref"].to(term_dtype)
    xs, ys = torch.broadcast_tensors(xs, ys)
    return torch.where(inside, pref * voigt(xs, ys), torch.zeros_like(xs))


def cross_section(lines, grid, cut_off, t, p, x, points, precision,
                  device, pedestal=None, layer=None):
    """One gas's cross section [m2] at pairs of a layer and an internal
    grid point: ``t`` [K], ``p`` [Pa], ``x`` (the gas's mole fraction) and
    ``points`` (int) are arrays of one entry a pair.  Each is the sum of
    prefactor x K(x, y) over the lines whose window holds the point, the
    line's physics worked out for the pair's layer (spectra.c).  With
    ``pedestal`` ([layers, kept lines], :func:`pedestals`) and ``layer``
    (each pair's row of it), returns (cross section, the sum of the
    pedestals of the same lines); without, (cross section, None)."""
    term_dtype, sum_dtype, _ = PRECISIONS[precision]
    v0, vn, n_per_v, _ = internal_grid(grid)
    keep = kept(lines["nu"], v0, vn, cut_off)
    out = torch.zeros(points.size, dtype=sum_dtype, device=device)
    taken = None if pedestal is None else torch.zeros_like(out)
    if keep == 0 or points.size == 0:
        return out, taken
    nu = lines["nu"][:keep]
    # A line's window starts at its bucket floor(shifted centre); the shift
    # moves it by less than a wavenumber, so the lines with floor(nu) one
    # wider on each side are the candidates, and the exact test is below.
    floor_nu = np.floor(nu)
    lo = -(-points // n_per_v) + v0 - cut_off - 2
    hi = points // n_per_v + v0 + cut_off + 1
    first = np.searchsorted(floor_nu, lo, side="left")
    count = np.searchsorted(floor_nu, hi, side="right") - first
    dev = _device_lines(lines, keep, device)
    dev.update({name: torch.as_tensor(value, device=device) for name, value
                in (("q_t", partition(lines, t)), ("t", t), ("p", p),
                    ("x", x), ("j", points.astype(np.float64)),
                    ("first", first))})
    if pedestal is not None:
        pedestal = torch.as_tensor(pedestal, device=device)
        dev["layer"] = torch.as_tensor(layer, device=device)
    for blk in blocks(count):
        cnt = torch.as_tensor(count[blk], device=device)
        owner = torch.repeat_interleave(
            torch.arange(blk.start, blk.stop, device=device), cnt)
        line = dev["first"][owner] + torch.arange(
            owner.numel(), device=device) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt)
        j = dev["j"][owner]
        prm = _line_params(dev, line, owner, cut_off, v0, n_per_v)
        inside = (prm["start"] <= j) & (j <= prm["end"])
        terms = _terms(prm, j, inside, v0, n_per_v, term_dtype)
        out.index_add_(0, owner, terms.to(sum_dtype))
        if pedestal is not None:
            taken.index_add_(0, owner, torch.where(
                inside, pedestal[dev["layer"][owner], line],
                torch.zeros_like(out[:1])))
    return out, taken


def endpoints(num_points, n_per_v):
    """The internal grid points at which a window can start or end: every
    whole wavenumber, and the last point (a window past the grid's top
    ends there)."""
    return np.unique(np.append(np.arange(0, num_points, n_per_v),
                               num_points - 1))


def pedestals(lines, grid, cut_off, t, p, x, precision, device):
    """[layers, kept lines]: the pedestal each line takes out of one gas's
    cross section in each layer (``t``, ``p``, ``x``: one entry a layer),
    by the reference's loop (spectra.c:66-78): the lines in list order,
    each adding its terms over its window [s, e] (clamped to the grid) and
    then subtracting min(k[s], k[e]) over it, from the one accumulator k.
    A line whose window misses the grid (s >= n or e < 0) takes nothing.

    Only k's values at s and e are read, and every s and e is one of
    :func:`endpoints`, so k is kept there alone: a line adds its terms at
    the endpoints in its window and takes its pedestal out of them.  The
    loop runs over the lines, each step over every layer at once; the
    terms are worked out on ``device`` in blocks of lines, in
    ``precision``, and k is kept in its accumulation type."""
    term_dtype, sum_dtype, _ = PRECISIONS[precision]
    v0, vn, n_per_v, num_points = internal_grid(grid)
    keep = kept(lines["nu"], v0, vn, cut_off)
    layers = t.size
    host = torch.zeros(0, dtype=sum_dtype).numpy().dtype
    if keep == 0 or layers == 0:
        return np.zeros((layers, keep), host)
    ends = endpoints(num_points, n_per_v)
    last = ends.size - 1
    dev = _device_lines(lines, keep, device)
    dev.update({name: torch.as_tensor(value, device=device) for name, value
                in (("q_t", partition(lines, t)), ("t", t), ("p", p),
                    ("x", x), ("ends", ends.astype(np.float64)))})
    layer = torch.arange(layers, device=device)[:, None]
    # k at the endpoints, endpoint by endpoint, each a row of the layers.
    acc = np.zeros((ends.size, layers), host)
    ped = np.zeros((keep, layers), host)
    rows = np.arange(layers)
    per_block = max(1, PAIRS_PER_BLOCK // (layers * (2 * cut_off + 4)))
    for start in range(0, keep, per_block):
        line = torch.arange(start, min(start + per_block, keep),
                            device=device)[None, :]
        prm = _line_params(dev, line, layer, cut_off, v0, n_per_v)
        s, e = prm["start"].long(), prm["end"].long()
        live = (s < num_points) & (e >= 0)
        # Each window's first and last endpoint, as indices of ``ends``.
        first = torch.where(live, s.clamp(0, num_points - 1) // n_per_v, 0)
        final = torch.where(e > num_points - 1, last,
                            e.clamp(min=0) // n_per_v)
        final = torch.where(live, final, 0)
        # A line's endpoints base, base + 1, ..., top - 1 hold its window
        # in every layer.
        base = torch.where(live, first, last).amin(0)
        top = final.amax(0) + 1
        width = max(int((top - base).max()), 1)
        slot = base[None, :, None] + torch.arange(width, device=device)
        inside = live[..., None] & (first[..., None] <= slot) \
            & (slot <= final[..., None])
        j = dev["ends"][slot.clamp(max=last)]
        terms = _terms({k: v[..., None] for k, v in prm.items()}, j, inside,
                       v0, n_per_v, term_dtype)
        # [line, endpoint, layer] on the host.
        terms = terms.to(sum_dtype).permute(1, 2, 0).contiguous() \
            .cpu().numpy()
        inside = inside.to(sum_dtype).permute(1, 2, 0).contiguous() \
            .cpu().numpy()
        # A line whose window is the same live one in every layer.
        same = (live.all(0) & (first == first[:1]).all(0)
                & (final == final[:1]).all(0)).tolist()
        any_live = live.any(0).tolist()
        live = live.to(sum_dtype).T.contiguous().cpu().numpy()
        first, final = first.T.cpu().numpy(), final.T.cpu().numpy()
        for i, (lo, hi) in enumerate(zip(base.tolist(), top.tolist())):
            if not any_live[i]:
                continue
            window = acc[lo:hi]
            window += terms[i, :hi - lo]
            if same[i]:
                k = np.minimum(acc[first[i, 0]], acc[final[i, 0]])
                window -= k
            else:
                k = np.minimum(acc[first[i], rows], acc[final[i], rows]) \
                    * live[i]
                window -= k * inside[i, :hi - lo]
            ped[start + i] = k
    return np.ascontiguousarray(ped.T)


def totals(config, lines, calls, grid, precision="float64", device="cpu",
           remove_pedestal=False):
    """[(total, total before the pedestal)] of each call, a call being
    (atmosphere, state, point): the total absorption [m-1] at its (state,
    point) pairs, the density-weighted cross sections of every gas with
    lines plus the continua, as float64 numpy (computed in ``precision``).
    With ``remove_pedestal`` each gas's cross section has the reference's
    pedestals taken out (:func:`pedestals`, over the layers of every call
    at once); without, the two totals are the same array."""
    _, sum_dtype, cont_dtype = PRECISIONS[precision]
    flat = [atm.flat() for atm, _, _ in calls]
    # The layers the calls read, and each pair's row among them.
    used = [np.unique(state) for _, state, _ in calls]
    offset = np.cumsum([0] + [u.size for u in used])
    row = np.concatenate([o + np.searchsorted(u, state) for o, u, (_, state, _)
                          in zip(offset, used, calls)])
    t_row = np.concatenate([f[0][u] for f, u in zip(flat, used)])
    p_row = np.concatenate([f[1][u] for f, u in zip(flat, used)])
    t, p = t_row[row], p_row[row]
    point = np.concatenate([pt for _, _, pt in calls])
    total = torch.zeros(row.size, dtype=sum_dtype, device=device)
    before = total.clone()
    for name, gas_lines in lines.items():
        x_row = np.concatenate([f[2][name][u] for f, u in zip(flat, used)])
        x = x_row[row]
        ped = pedestals(gas_lines, grid, config["cut_off"], t_row, p_row,
                        x_row, precision, device) if remove_pedestal else None
        k, taken = cross_section(gas_lines, grid, config["cut_off"], t, p, x,
                                 point, precision, device, ped, row)
        density = torch.as_tensor(p * x / (KB * t), device=device) \
            .to(sum_dtype)
        before += k * density
        if taken is not None:
            total += (k - taken) * density
    if not remove_pedestal:
        total = before
    out, out_before = total.double().cpu().numpy(), \
        before.double().cpu().numpy()
    start = np.cumsum([0] + [state.size for _, state, _ in calls])
    tables = mtckd.Tables(cont_dtype)
    results = []
    for c, (_, state, pt) in enumerate(calls):
        t_all, p_all, vmr_all = flat[c]
        r = out[start[c]:start[c + 1]]
        r0 = out_before[start[c]:start[c + 1]] if remove_pedestal else r
        for s in np.unique(state):
            where = np.flatnonzero(state == s)
            vmr = {g: float(v[s]) for g, v in vmr_all.items()}
            continua = mtckd.continua(tables, grid[pt[where]],
                                      float(t_all[s]), float(p_all[s]), vmr)
            r[where] += continua
            if r0 is not r:
                r0[where] += continua
        results.append((r, r0))
    return results


def absorption(config, lines, atmosphere, grid, state, point,
               precision="float64", device="cpu", remove_pedestal=False):
    """The total absorption [m-1] of one call (:func:`totals`)."""
    return totals(config, lines, [(atmosphere, state, point)], grid,
                  precision, device, remove_pedestal)[0][0]
