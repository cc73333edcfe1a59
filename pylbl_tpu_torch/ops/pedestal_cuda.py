"""The stacked pedestal remover's work on the field's device.

Reference pedestal removal (spectra.c:66-78, models/lines/pedestal.py) for
one gas's [B, N] lines of a [B, G, num_points] field, with no per-line
array built on the host, nothing fetched from the card and no wait for
the host.  Five parts, each for a layer batch:

1. :func:`line_inputs` (kernel P, ``pedestal_lines``):
   ``line_profile_params`` and ``kernel_inputs`` (models/lines/physics.py)
   in float64, with the layer-independent parts computed once by
   :class:`GasLines` with numpy's operations.
   Every result but the line's strength and widths is the host's bit for
   bit (the window's bucket, ``s_idx`` and ``e_idx`` come from mul, add
   and floor alone); those pass through exp, pow and sqrt and may differ
   from glibc's in the last ulp (rel 1e-15).  Each bucket's segment of
   lines and window endpoints come with them.
2. :func:`endpoint_contributions` (kernel A, ``pedestal_contrib``): per
   (layer, line), k(p_s) less the later lines' terms at its left window
   endpoint, the earlier lines' terms at its right one, and its own terms
   at the grid's two edge points; a walk a (layer, bucket), since a
   bucket's lines share their endpoints and segment.
3. :func:`scan` (kernel B, ``pedestal_scan``): the order-dependent scan,
   the native scan's rule (csrc/pylbl_native.cpp), a row per layer: each
   line's pedestal.
4. :func:`bucket_totals` (kernel D, ``pedestal_totals``): the pedestals'
   totals by bucket, each first rounded to the field's dtype (as the
   host's remover and the JAX package's did before their box
   subtraction).
5. :func:`subtract_field` (kernel C, ``pedestal_field``): every window is
   anchored at its line's integer bucket, so the pedestal field at a point
   is the sum of the totals of the buckets whose window holds it
   (:func:`bucket_windows`), added in bucket order in float64 and
   subtracted in the field's dtype.

On CUDA tensors 1-5 launch the kernels of ``csrc/pedestal.cu`` (built
with ``csrc/lineshape.cu`` into one library, ops/lineshape_cuda.py
``cuda_library``) and add one to their entry in :data:`LAUNCHES`; there
is no fallback.  On CPU tensors, or with ``plain=True``, they run their
plain versions: the physics as torch ops, the segment walks a step at a
time over every (layer, bucket) in the kernel's order (the same bits
where the torch and CUDA math agree), the native scan on the host (the
kernel's sums are its own, bit for bit), ``np.bincount`` (line order)
and the bucket sum in the kernel's order.  No float atomics anywhere:
repeat calls give the same bits.
"""
import ctypes

import numpy as np
import torch

from . import lineshape_cuda as lc
from .voigt import region_limits, voigt_full, voigt_lorentz
from ..models.tips import interp_uniform
from ..runtime import native
from ..utils import constants as c

# Launches of each kernel wrapper since the last reset_launches().
LAUNCHES = {"pedestal_lines": 0, "pedestal_contrib": 0, "pedestal_scan": 0,
            "pedestal_totals": 0, "pedestal_field": 0}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _library():
    """The kernels' library (ops/lineshape_cuda.py ``cuda_library``) with
    the pedestal entries' argument types set."""
    lib = lc.cuda_library()
    if not getattr(lib, "_pylbl_pedestal_bound", False):
        p, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_double)
        lib.pylbl_pedestal_lines.restype = ctypes.c_int
        lib.pylbl_pedestal_lines.argtypes = [
            *[p] * 13,                  # the gas's constants, slot
            p, p, p, p,                 # T, p, x [B], Q(T) [slots, B]
            i32, i32,                   # B, N
            *[f64] * 8,                 # PhysConsts
            p, p, p, p, p, p, p,        # center, srw, y, pref, s, e, bucket
            p]                          # stream
        lib.pylbl_pedestal_contrib.restype = ctypes.c_int
        lib.pylbl_pedestal_contrib.argtypes = [
            p, p, p, p, p, p, p,        # center, srw, y, pref, s, e, bucket
            p, p, p, p,                 # seg_lo, seg_hi, p_s, p_e [nb]
            p, i32, i64, i64,           # field, float64?, row, offset
            i32, i32, i32, i32, f64,    # B, N, nb, num_points, 1/sqrt(pi)
            p, p, p, p,                 # ks, pre, c0, cn [B, N]
            p]                          # stream
        lib.pylbl_pedestal_scan.restype = ctypes.c_int
        lib.pylbl_pedestal_scan.argtypes = [
            p, p, p, p, p, p, p,        # bucket, s, e, ks, pre, c0, cn
            i32, i32, i32, i32, i32,    # rows, N, num_points, window, nb
            p, p,                       # ped [rows, N], scratch [rows, nb]
            p]                          # stream
        lib.pylbl_pedestal_totals.restype = ctypes.c_int
        lib.pylbl_pedestal_totals.argtypes = [
            p, p, p, p,                 # ped, bucket, seg_lo, seg_hi
            i32, i32, i32, i32,         # B, N, nb, float32 field
            p,                          # totals [B, nb]
            p]                          # stream
        lib.pylbl_pedestal_field.restype = ctypes.c_int
        lib.pylbl_pedestal_field.argtypes = [
            p, i32, i64, i64,           # out, float64?, row, offset
            p, i32,                     # totals [B, nb], nb
            p, p, i32,                  # blo, bhi [num_points], b0
            i32, i32,                   # B, num_points
            p]                          # stream
        lib._pylbl_pedestal_bound = True
    return lib


def _check_rows(name, tensors, dtypes, shape):
    for t, dtype in zip(tensors, dtypes):
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError(f"{name}: expected contiguous {dtype} "
                             f"{tuple(shape)} tensors on one device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


# --------------------------------------------------------------------------
# Line physics.
# --------------------------------------------------------------------------

class GasLines:
    """One gas's kept lines, in processing order, as :func:`line_inputs`
    reads them: float64 line constants and the layer-independent parts of
    ``line_profile_params`` (computed here with numpy's operations, so
    they hold the host's bits), on each device once (:meth:`on`)."""

    # The constants in kernel P's argument order.
    KERNEL_ORDER = ("nu", "delta_air", "gamma_air", "gamma_self", "n_air",
                    "mass", "sw", "nu_c", "elower_c2", "neg_c2_nu",
                    "one_minus_gref", "q_ref", "slot")

    def __init__(self, pack, keep):
        sl = slice(0, keep)
        nu = pack.nu[sl]
        self.pack = pack
        self.host = {
            "nu": nu, "delta_air": pack.delta_air[sl],
            "gamma_air": pack.gamma_air[sl],
            "gamma_self": pack.gamma_self[sl], "n_air": pack.n_air[sl],
            "mass": pack.mass[sl], "sw": pack.sw[sl],
            "nu_c": nu / c.VLIGHT,
            "elower_c2": pack.elower[sl] * c.C2,
            "neg_c2_nu": -c.C2 * nu,
            "one_minus_gref": 1.0 - np.exp((-c.C2 * nu) / 296.0),
            "q_ref": pack.q(296.0)[sl],
            "slot": np.clip(pack.iso[sl] - 1, 0, pack.q_table.shape[0] - 1),
        }
        self.num_slots = pack.q_table.shape[0]
        self._nu_lo, self._nu_hi = float(nu.min()), float(nu.max())
        self._delta_max = float(np.abs(pack.delta_air[sl]).max())
        self._dev = {}

    def on(self, device):
        """The constants as tensors on ``device`` (uploaded once)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {name: torch.as_tensor(
                np.ascontiguousarray(value), device=device)
                for name, value in self.host.items()}
        return self._dev[key]

    def q_slots(self, temperature):
        """[slots, B] TIPS Q(T) per isotopologue slot, as ``LinePack.q``
        interpolates it before its gather."""
        pack = self.pack
        return interp_uniform(pack.q_temperature, pack.q_table[:, None, :],
                              np.asarray(temperature)[None, :])

    def bucket_range(self, pressure):
        """(b0, nb, margin): buckets b0 .. b0 + nb - 1 hold every line's
        bucket floor(nu + p_atm * delta_air) at these pressures, a bucket
        of room on each side of the bound; ``margin`` bounds |nu_shift -
        nu| (pedestal.py's segment margin, 1e-9 above the largest shift:
        a wider segment walks more lines, none of which adds a term)."""
        p_atm = float(np.max(np.abs(pressure))) * c.PA_TO_ATM
        if not np.isfinite(p_atm):
            raise ValueError("non-finite pressure: no pedestal buckets")
        shift = p_atm * self._delta_max
        b0 = int(np.floor(self._nu_lo - shift)) - 1
        top = int(np.floor(self._nu_hi + shift)) + 1
        return b0, top - b0 + 1, shift + 1e-9


def line_inputs(dev, temperature, pressure, vmr, q_slots, v0, n_per_v,
                cut_off, buckets, num_points, plain=False):
    """The kernels' inputs of one gas on the constants' device:
    ``line_profile_params`` and ``kernel_inputs`` in their operations and
    order (:class:`GasLines`), and each bucket's segment and endpoints.

    Args:
        dev: :meth:`GasLines.on`'s tensors.
        temperature, pressure, vmr: [B] float64 tensors.
        q_slots: [slots, B] float64 Q(T) (:meth:`GasLines.q_slots`).
        buckets: (b0, num_buckets, margin), :meth:`GasLines.bucket_range`.

    On CUDA tensors (unless ``plain``) the [B, N] part is kernel P
    (``pedestal_lines``), the same operations with CUDA's exp, pow and
    sqrt, as torch's on the card.

    Returns:
        dict of [B, N] tensors: center, srw (repwid / n_per_v), y, pref
        (float64); s_idx, e_idx and bucket (floor(nu_shift) - b0) int32;
        and of [num_buckets] int32 tensors of the buckets b0 + r: seg_lo,
        seg_hi, the lines within the batch's largest pressure shift of the
        bucket's wavenumber (pedestal.py's local segments, searched on the
        device: every line of the bucket and every line whose window can
        reach its window's endpoints), and p_s, p_e, its window's clamped
        endpoints.
    """
    b0, num_buckets, margin = buckets
    if temperature.is_cuda and not plain:
        out = _lines_kernel(dev, temperature, pressure, vmr, q_slots, v0,
                            n_per_v, cut_off, b0)
    else:
        out = _lines_plain(dev, temperature, pressure, vmr, q_slots, v0,
                           n_per_v, cut_off, b0)
    # The buckets' wavenumbers, windows and segments, as each line's.
    bucket = torch.arange(num_buckets, dtype=torch.float64,
                          device=temperature.device) + b0
    n = num_points
    out.update(
        seg_lo=torch.searchsorted(dev["nu"], bucket - margin, side="left",
                                  out_int32=True),
        seg_hi=torch.searchsorted(dev["nu"], bucket + 1 + margin,
                                  side="right", out_int32=True),
        p_s=((bucket - cut_off - v0) * n_per_v).to(torch.int64)
        .clamp(0, n - 1).to(torch.int32),
        p_e=((bucket + cut_off + 1 - v0) * n_per_v).to(torch.int64)
        .clamp(0, n - 1).to(torch.int32))
    return out


def _lines_plain(dev, temperature, pressure, vmr, q_slots, v0, n_per_v,
                 cut_off, b0):
    """Kernel P's plain version: the [B, N] part of :func:`line_inputs`."""
    def const(value):
        # A divide by (or of) a Python number is a multiply by its
        # reciprocal in torch (and on CUDA for a number divisor too), not
        # numpy's IEEE quotient: each such divide takes a tensor, filled
        # on the device (a copy from the host would wait for the card).
        return torch.full((), value, dtype=torch.float64,
                          device=temperature.device)

    t = temperature[:, None]
    p = pressure[:, None]
    x = vmr[:, None]
    p_atm = p * c.PA_TO_ATM
    partial = p_atm * x
    tfact = const(296.0) / t
    nu_shift = dev["nu"] + p_atm * dev["delta_air"]
    gamma = (dev["gamma_air"] * (p_atm - partial)
             + dev["gamma_self"] * partial) * tfact ** dev["n_air"]
    alpha = dev["nu_c"] * torch.sqrt(c.R2 * t / dev["mass"])
    sb = torch.exp(dev["elower_c2"] * (t - 296.0) / (t * 296.0))
    se = (1.0 - torch.exp(dev["neg_c2_nu"] / t)) / dev["one_minus_gref"]
    sq = dev["q_ref"] / q_slots.index_select(0, dev["slot"]).T
    sw = dev["sw"] * sb * se * sq * 0.01 * 0.01
    del sb, se, sq
    repwid = const(c.SQRT_LN2) / alpha
    b = torch.floor(nu_shift)
    return {
        "center": (nu_shift - v0) * n_per_v,
        "srw": repwid / const(n_per_v),
        "y": repwid * gamma,
        "pref": sw * c.RSQRPI * repwid,
        "s_idx": ((b - cut_off - v0) * n_per_v).to(torch.int32),
        "e_idx": ((b + cut_off + 1 - v0) * n_per_v).to(torch.int32),
        "bucket": (b - b0).to(torch.int32),
    }


def _lines_kernel(dev, temperature, pressure, vmr, q_slots, v0, n_per_v,
                  cut_off, b0):
    """Kernel P: the [B, N] part of :func:`line_inputs` on the card."""
    batch = temperature.shape[0]
    num = dev["nu"].shape[0]
    inputs = [temperature, pressure, vmr, q_slots]
    _check_rows("pedestal_lines", inputs[:3], [torch.float64] * 3, (batch,))
    _check_rows("pedestal_lines", inputs[3:], [torch.float64],
                (q_slots.shape[0], batch))
    f64, i32 = torch.float64, torch.int32
    out = {name: torch.empty((batch, num), dtype=dtype,
                             device=temperature.device)
           for name, dtype in (("center", f64), ("srw", f64), ("y", f64),
                               ("pref", f64), ("s_idx", i32),
                               ("e_idx", i32), ("bucket", i32))}
    err = _library().pylbl_pedestal_lines(
        *(lc._ptr(dev[k]) for k in GasLines.KERNEL_ORDER),
        *(lc._ptr(t) for t in inputs), batch, num, c.PA_TO_ATM, c.R2,
        c.SQRT_LN2, c.RSQRPI, float(v0), float(n_per_v), float(cut_off),
        float(b0), *(lc._ptr(t) for t in out.values()),
        lc._stream_ptr(temperature.device))
    lc._check_launch("pedestal_lines", err)
    LAUNCHES["pedestal_lines"] += 1
    return out


def bucket_windows(v0, vn, n_per_v, num_points, cut_off):
    """(blo, bhi) int32 [num_points]: the first and last absolute bucket
    whose window [s(b), e(b)] (``kernel_inputs``' s_idx and e_idx of a
    line in bucket b) holds each point.  A window that reaches past a
    grid edge holds the same points clamped, and a window that misses the
    grid holds none, so these are the buckets of every line whose clamped
    window holds the point."""
    b = np.arange(np.floor(v0 - cut_off) - 2, np.ceil(vn + cut_off) + 3)
    s = ((b - cut_off - v0) * n_per_v).astype(np.int64)
    e = ((b + cut_off + 1 - v0) * n_per_v).astype(np.int64)
    p = np.arange(num_points)
    bhi = b[np.searchsorted(s, p, side="right") - 1]
    blo = b[np.searchsorted(e, p, side="left")]
    return blo.astype(np.int32), bhi.astype(np.int32)


# --------------------------------------------------------------------------
# Kernel A: endpoint contributions.
# --------------------------------------------------------------------------

def _terms(ka, xlim, point, j, ok):
    """[B, R] terms pref_j K(x_j(point), y_j) of lines ``j`` ([R] or [B,
    R]) at ``point`` ([R] or [B, R] float64) where ``ok``, else +0.0
    (pedestal.py ``contrib_at``'s voigt_full choice)."""
    batch = ka["center"].shape[0]
    j = j.expand(batch, *j.shape[-1:])

    def gather(t):
        return torch.take_along_dim(t, j, dim=1)

    x = (point - gather(ka["center"])) * gather(ka["srw"])
    y = gather(ka["y"])
    k = voigt_lorentz(x, y)
    core = ok & (x.abs() < gather(xlim))
    if bool(core.any()):
        k[core] = voigt_full(x[core], y[core])
    return torch.where(ok, gather(ka["pref"]) * k, torch.zeros_like(k))


def endpoint_contributions_plain(ka, field, field_off, num_points):
    """Kernel A's plain version (:func:`endpoint_contributions`): each
    bucket's segment walked up and down, all (layer, bucket) pairs a step
    at a time, each line's sums handed over as the kernel does."""
    n = num_points
    s, e = ka["s_idx"].long(), ka["e_idx"].long()
    batch, num = s.shape
    y = ka["y"]
    xlim = torch.where(y < 70.55, region_limits(y)[0],
                       torch.full_like(y, -1.0))
    lo, hi = ka["seg_lo"].long(), ka["seg_hi"].long()
    nb = lo.numel()
    own_bucket = torch.arange(nb, device=s.device)
    width = int((hi - lo).max()) if nb else 0
    out = {name: torch.zeros((batch, num), dtype=torch.float64,
                             device=s.device) for name in ("ks", "pre")}
    k_at = torch.take_along_dim(field, field_off + ka["p_s"].long().expand(
        batch, nb), dim=1).double()

    def step(m, point, acc, name, before):
        j = (lo + m).clamp(0, max(num - 1, 0))
        valid = (lo + m < hi).expand(batch, nb)
        cover = valid & (s.gather(1, j.expand(batch, nb)) <= point) \
            & (e.gather(1, j.expand(batch, nb)) >= point)
        own = valid & (ka["bucket"].long().gather(
            1, j.expand(batch, nb)) == own_bucket)
        rows, cols = own.nonzero(as_tuple=True)
        if before:
            out[name][rows, j[cols]] = (k_at - acc)[rows, cols]
        acc = acc + _terms(ka, xlim, point.double(), j, cover)
        if not before:
            out[name][rows, j[cols]] = acc[rows, cols]
        return acc

    acc = torch.zeros((batch, nb), dtype=torch.float64, device=s.device)
    p_e = ka["p_e"].long().expand(batch, nb)
    for m in range(width):
        acc = step(m, p_e, acc, "pre", False)
    acc = torch.zeros_like(acc)
    p_s = ka["p_s"].long().expand(batch, nb)
    for m in reversed(range(width)):
        acc = step(m, p_s, acc, "ks", True)
    live = (s < n) & (e >= 0)
    rows = torch.arange(num, device=s.device)
    edges = [_terms(ka, xlim, torch.full((batch, num), float(point),
                                         dtype=torch.float64,
                                         device=s.device), rows, cover)
             for point, cover in ((0, (s <= 0) & (e >= 0) & live),
                                  (n - 1, (s <= n - 1) & (e >= n - 1)
                                   & live))]
    return out["ks"], out["pre"], edges[0], edges[1]


def endpoint_contributions(ka, field, field_off, num_points, plain=False):
    """Kernel A: the order-independent terms of the scan.

    Args:
        ka: :func:`line_inputs`' dict.
        field: [B, F] float32 or float64 field, the gas's points at
            columns ``field_off`` .. ``field_off + num_points - 1``.

    Returns:
        (ks, pre, c0, cn) [B, N] float64: k(p_s) less the terms at p_s of
        the later lines of the line's bucket's segment whose window holds
        it (added from the segment's last line down); the terms at p_e of
        the segment's lines up to the line whose window holds it (added
        in line order); the line's own term at point 0 where its live
        window holds it, and at point n - 1.
    """
    if plain or not field.is_cuda:
        return endpoint_contributions_plain(ka, field, field_off,
                                            num_points)
    shape = ka["center"].shape
    _check_rows("pedestal_contrib",
                [ka[k] for k in ("center", "srw", "y", "pref", "s_idx",
                                 "e_idx", "bucket")],
                [torch.float64] * 4 + [torch.int32] * 3, shape)
    nb = ka["seg_lo"].numel()
    _check_rows("pedestal_contrib",
                [ka[k] for k in ("seg_lo", "seg_hi", "p_s", "p_e")],
                [torch.int32] * 4, (nb,))
    if field.dim() != 2 or field.stride(1) != 1 or field.shape[0] \
            != shape[0] or field.dtype not in (torch.float32, torch.float64) \
            or field.device != ka["center"].device \
            or field_off + num_points > field.shape[1]:
        raise ValueError("pedestal_contrib: the field must be a [B, F] "
                         "float32 or float64 tensor with unit column stride "
                         "on the lines' device, holding the gas's points")
    out = [torch.empty(shape, dtype=torch.float64, device=field.device)
           for _ in range(4)]
    err = _library().pylbl_pedestal_contrib(
        *(lc._ptr(ka[k]) for k in ("center", "srw", "y", "pref", "s_idx",
                                   "e_idx", "bucket", "seg_lo", "seg_hi",
                                   "p_s", "p_e")),
        lc._ptr(field), int(field.dtype == torch.float64), field.stride(0),
        field_off, shape[0], shape[1], nb, num_points, c.RSQRPI,
        *(lc._ptr(t) for t in out), lc._stream_ptr(field.device))
    lc._check_launch("pedestal_contrib", err)
    LAUNCHES["pedestal_contrib"] += 1
    return tuple(out)


# --------------------------------------------------------------------------
# Kernel B: the scan.
# --------------------------------------------------------------------------

def scan_plain(bucket, s_idx, e_idx, ks, pre, c0, cn, num_points, window,
               num_buckets):
    """Kernel B's plain version: the native scan (runtime/native.py) a row
    on the host, its flags and inclusive edge sums from numpy."""
    device = bucket.device
    bucket, s, e, ks, pre, c0, cn = (t.cpu().numpy() for t in (
        bucket, s_idx, e_idx, ks, pre, c0, cn))
    n = num_points
    skip = (s >= n) | (e < 0)
    live = ~skip
    cover0 = (s <= 0) & (e >= 0) & live
    covern = (s <= n - 1) & (e >= n - 1) & live
    ped = np.zeros(s.shape)
    for r in range(s.shape[0]):
        ped[r] = native.pedestal_scan(
            bucket[r], skip[r], s[r] < 0, e[r] > n - 1, cover0[r],
            covern[r], ks[r], pre[r], np.cumsum(c0[r]), np.cumsum(cn[r]),
            window, num_buckets)
    return torch.as_tensor(ped, device=device)


def scan(bucket, s_idx, e_idx, ks, pre, c0, cn, num_points, window,
         num_buckets, plain=False):
    """Kernel B: the sequential pedestal scan, a row per layer.

    Args:
        bucket, s_idx, e_idx: [B, N] int32 (bucket relative to the rows'
            first bucket, in [0, num_buckets)).
        ks, pre, c0, cn: [B, N] float64 (:func:`endpoint_contributions`).
        window: 2 * cut_off + 1.

    Returns:
        ped [B, N] float64: each line's pedestal (0 for lines that miss
        the grid).
    """
    if plain or not bucket.is_cuda:
        return scan_plain(bucket, s_idx, e_idx, ks, pre, c0, cn, num_points,
                          window, num_buckets)
    shape = bucket.shape
    _check_rows("pedestal_scan", [bucket, s_idx, e_idx, ks, pre, c0, cn],
                [torch.int32] * 3 + [torch.float64] * 4, shape)
    ped = torch.empty(shape, dtype=torch.float64, device=bucket.device)
    scratch = torch.empty((shape[0], num_buckets), dtype=torch.float64,
                          device=bucket.device)
    err = _library().pylbl_pedestal_scan(
        *(lc._ptr(t) for t in (bucket, s_idx, e_idx, ks, pre, c0, cn)),
        shape[0], shape[1], num_points, window, num_buckets, lc._ptr(ped),
        lc._ptr(scratch), lc._stream_ptr(bucket.device))
    lc._check_launch("pedestal_scan", err)
    LAUNCHES["pedestal_scan"] += 1
    return ped


def bucket_totals_plain(ped, bucket, num_buckets, field_dtype):
    """Kernel D's plain version: ``np.bincount`` a row (it adds in line
    order)."""
    ped_np = ped.cpu().numpy()
    if field_dtype == torch.float32:
        ped_np = ped_np.astype(np.float32).astype(np.float64)
    bucket = bucket.cpu().numpy()
    return torch.as_tensor(np.stack([
        np.bincount(bucket[r], weights=ped_np[r], minlength=num_buckets)
        for r in range(ped_np.shape[0])]), device=ped.device)


def bucket_totals(ped, ka, field_dtype=torch.float64, plain=False):
    """Kernel D: [B, nb] float64 totals of the pedestals by bucket, each
    bucket's in line order from +0.0, each pedestal first rounded to
    float32 where ``field_dtype`` is float32 (as the host's remover and
    the JAX package's round them before their subtraction).  ``ka``:
    :func:`line_inputs`' dict (the lines' buckets, the buckets'
    segments)."""
    nb = ka["seg_lo"].numel()
    if plain or not ped.is_cuda:
        return bucket_totals_plain(ped, ka["bucket"], nb, field_dtype)
    _check_rows("pedestal_totals", [ped], [torch.float64], ped.shape)
    _check_rows("pedestal_totals", [ka["bucket"]], [torch.int32], ped.shape)
    _check_rows("pedestal_totals", [ka["seg_lo"], ka["seg_hi"]],
                [torch.int32] * 2, (nb,))
    totals = torch.empty((ped.shape[0], nb), dtype=torch.float64,
                         device=ped.device)
    err = _library().pylbl_pedestal_totals(
        lc._ptr(ped), lc._ptr(ka["bucket"]), lc._ptr(ka["seg_lo"]),
        lc._ptr(ka["seg_hi"]), ped.shape[0], ped.shape[1], nb,
        int(field_dtype == torch.float32), lc._ptr(totals),
        lc._stream_ptr(ped.device))
    lc._check_launch("pedestal_totals", err)
    LAUNCHES["pedestal_totals"] += 1
    return totals


# --------------------------------------------------------------------------
# Kernel C: the field.
# --------------------------------------------------------------------------

def subtract_field_plain(out, field_off, num_points, totals, blo, bhi, b0):
    """Kernel C's plain version (:func:`subtract_field`)."""
    nb = totals.shape[1]
    lo = (blo.long() - b0).clamp(min=0)
    count = (bhi.long() - b0).clamp(max=nb - 1) - lo + 1
    acc = torch.zeros((totals.shape[0], num_points), dtype=torch.float64,
                      device=totals.device)
    width = int(count.max()) if num_points else 0
    for m in range(max(width, 0)):
        part = totals.index_select(1, (lo + m).clamp(0, nb - 1))
        acc = acc + torch.where(m < count, part, torch.zeros_like(part))
    cols = slice(field_off, field_off + num_points)
    out[:, cols] = out[:, cols] - acc.to(out.dtype)


def subtract_field(out, field_off, num_points, totals, blo, bhi, b0,
                   plain=False):
    """Kernel C, in place: ``out[:, field_off + p]`` less the sum of the
    bucket totals ``totals[:, r]`` over the buckets b0 + r in [blo[p],
    bhi[p]] (:func:`bucket_windows`), added in bucket order from +0.0 in
    float64 and cast to ``out``'s dtype; ``out`` [B, F] float32 or
    float64, ``totals`` [B, nb] float64, ``blo``/``bhi`` int32
    [num_points]."""
    if plain or not out.is_cuda:
        subtract_field_plain(out, field_off, num_points, totals, blo, bhi,
                             b0)
        return
    batch, nb = totals.shape
    _check_rows("pedestal_field", [blo, bhi], [torch.int32] * 2,
                (num_points,))
    _check_rows("pedestal_field", [totals], [torch.float64], (batch, nb))
    if out.dim() != 2 or out.stride(1) != 1 or out.shape[0] != batch \
            or out.dtype not in (torch.float32, torch.float64) \
            or field_off + num_points > out.shape[1] \
            or len({out.device, totals.device, blo.device}) > 1:
        raise ValueError("pedestal_field: out must be a [B, F] float32 or "
                         "float64 tensor with unit column stride on the "
                         "totals' device, holding the gas's points")
    err = _library().pylbl_pedestal_field(
        lc._ptr(out), int(out.dtype == torch.float64), out.stride(0),
        field_off, lc._ptr(totals), nb, lc._ptr(blo), lc._ptr(bhi), b0,
        batch, num_points, lc._stream_ptr(out.device))
    lc._check_launch("pedestal_field", err)
    LAUNCHES["pedestal_field"] += 1


def upload(values, device):
    """A float64 numpy vector on ``device``; to a card from pinned memory
    without a wait (the copy queues behind the card's work, the host goes
    on)."""
    host = torch.from_numpy(np.ascontiguousarray(values, np.float64))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
