"""Kernel-array preparation and the portable two-pass accumulation.

Counterpart of pylbl_tpu/ops/lineshape.py.  The float64 physics outputs
become kernel arrays with split line centers, so float32 kernels see no
catastrophic cancellation: x = ((t - c_int) - c_frac) * (repwid /
n_per_v) subtracts small same-scale numbers.

:func:`accumulate` and :func:`accumulate_segment` are the portable
backend (``backend="xla"`` of ``Gas`` and ``make_multigas_batched_fn``):
the windowed Voigt sum k[t] = sum_i prefactor_i * K(x_it, y_i) as two
order-independent passes over chunks of lines, the Lorentzian over each
line's full +/-cut_off window and the Humlicek correction over a narrow
core around its center (reference spectra.c:48-62, voigt.c:74-189).  The
JAX package computes them in XLA with masked scatter-adds; here they are
plain torch ops that run on any device and are deterministic by
construction: each chunk's in-window points are stable-sorted by grid
index, summed per index (``torch.segment_reduce``) and added once at the
now-unique indices.  No float atomics and no accumulating scatter are
used, so repeated calls are bit-identical on the card as on the CPU.
"""
import numpy as np
import torch

from .lineshape_cuda import core_halfwidths  # noqa: F401  (re-export)
from .voigt import XLIM0_MAX, voigt_correction, voigt_lorentz
from ..runtime.device import resolve_device


def _pad_lines(arrays, multiple):
    """Pads the line axis so it divides evenly into chunks.

    Padded entries get prefactor 0 and a window placed at [-1, -2] so every
    candidate point is dropped by masking.
    """
    n = arrays["prefactor"].shape[-1]
    padded = -n % multiple
    if padded == 0:
        return arrays, n

    def pad(name, value):
        a = arrays[name]
        width = [(0, 0)] * (a.ndim - 1) + [(0, padded)]
        return np.pad(a, width, constant_values=value)
    out = {
        "c_int": pad("c_int", 0),
        "c_frac": pad("c_frac", 0.0),
        "scaled_repwid": pad("scaled_repwid", 1.0),
        "y": pad("y", 1.0),
        "prefactor": pad("prefactor", 0.0),
        "s_idx": pad("s_idx", -1),
        "e_idx": pad("e_idx", -2),
    }
    return out, n


def prepare_kernel_arrays(kin, n_per_v, dtype):
    """Converts float64 physics outputs to kernel dtype with split centers.

    Args:
        kin: dict from physics.kernel_inputs (float64, [N] or [B, N]).
        n_per_v: grid points per wavenumber.
        dtype: kernel dtype (np.float32 or np.float64).

    Returns:
        dict of host arrays for ops/lineshape_cuda.py and :func:`accumulate`.
    """
    center = kin["center"]
    c_int = np.rint(center).astype(np.int32)
    c_frac = (center - c_int).astype(dtype)
    return {
        "c_int": c_int,
        "c_frac": c_frac,
        "scaled_repwid": (kin["repwid"] / n_per_v).astype(dtype),
        "y": kin["y"].astype(dtype),
        "prefactor": kin["prefactor"].astype(dtype),
        "s_idx": kin["s_idx"].astype(np.int32),
        "e_idx": kin["e_idx"].astype(np.int32),
    }


def core_halfwidth(kin, n_per_v, cut_off):
    """Core-window half width in grid points, one for all lines.

    Covers |x| < XLIM0_MAX for every line with y < 70.55 (lines with larger
    y are pure Lorentzian everywhere, reference voigt.c:17-27), clipped to
    the wing window, and rounded up to a power of two as the JAX package
    does (there it is a jit-static shape).
    """
    y = np.asarray(kin["y"], dtype=np.float64)
    repwid = np.asarray(kin["repwid"], dtype=np.float64)
    needs = y < 70.55
    if not needs.any():
        return 1
    width = XLIM0_MAX / repwid[needs].min() * n_per_v
    width = int(min(np.ceil(width) + 1, (cut_off + 1) * n_per_v))
    return int(min(2 ** int(np.ceil(np.log2(max(width, 1)))),
                   (cut_off + 1) * n_per_v))


def _chunk_points(ch, idx, origin, num_points, e_eff, core):
    """One pass over a chunk's candidate points ``idx`` [B, C, W]: the
    flat keys (layer row + local grid index) and values of the points the
    masks keep, in row-major order."""
    dtype = ch["prefactor"].dtype
    local = idx - origin
    x = ((idx - ch["c_int"]).to(dtype) - ch["c_frac"]) * ch["scaled_repwid"]
    shape = voigt_correction if core else voigt_lorentz
    vals = ch["prefactor"] * shape(x, ch["y"])
    mask = (idx >= 0) & (idx <= e_eff) & (local >= 0) & (local < num_points)
    if core:
        mask &= idx >= ch["s_idx"]
    row = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return (row * num_points + local)[mask], vals[mask]


def _accumulate_impl(arrays, origin, num_points, total_points, window,
                     core_window, chunk):
    """Two-pass accumulation over line chunks (JAX ``_accumulate_impl``).

    Args:
        arrays: dict of [B, N] tensors on one device (N a multiple of
            chunk; ``c_int``, ``s_idx``, ``e_idx`` integer).
        origin: first global grid index owned by this output segment (0
            for a whole grid, a shard's offset for a segment of it).
        num_points: local output segment size.
        total_points: global grid size (the reference clamps windows to
            the *global* upper edge, spectra.c:58-62).
        window / core_window: wing window points and core half width.
        chunk: lines per step.

    Each step takes C = ``chunk`` lines of all B layers: B * C * (window +
    2 * core_window + 1) candidate points, whose index, value and mask
    tensors (and the correction's region temporaries) are the step's
    working set, freed before the next; the sort and the per-index sums
    hold only the points in their windows.  The step's peak is about 125
    bytes per candidate point in float32 (``chip_smoke.py`` phase 13 on an
    H100: 0.73 GiB above the resident data for B = 16, C = 512 and 768
    points per line), plus the [B, num_points] output.

    Returns:
        [B, num_points] tensor in the arrays' float dtype.
    """
    pref = arrays["prefactor"]
    batch, num_lines = pref.shape
    device = pref.device
    k = torch.zeros(batch * num_points, dtype=pref.dtype, device=device)
    wing_off = torch.arange(window, device=device)
    core_off = torch.arange(-core_window, core_window + 1, device=device)
    for lo in range(0, num_lines, chunk):
        ch = {name: a[:, lo:lo + chunk, None] for name, a in arrays.items()}
        ch["c_int"] = ch["c_int"].long()
        ch["s_idx"] = ch["s_idx"].long()
        e_eff = torch.clamp(ch["e_idx"].long(), max=total_points - 1)
        wings = _chunk_points(ch, ch["s_idx"] + wing_off, origin, num_points,
                              e_eff, core=False)
        core = _chunk_points(ch, ch["c_int"] + core_off, origin, num_points,
                             e_eff, core=True)
        keys = torch.cat([wings[0], core[0]])
        if keys.numel() == 0:
            continue
        order = torch.argsort(keys, stable=True)
        index, counts = torch.unique_consecutive(keys[order],
                                                 return_counts=True)
        sums = torch.segment_reduce(torch.cat([wings[1], core[1]])[order],
                                    "sum", lengths=counts)
        k[index] = k[index] + sums
    return k.reshape(batch, num_points)


def accumulate_segment(arrays, origin, num_points, total_points, window,
                       core_window, chunk):
    """Segment accumulation over possibly-batched arrays (JAX
    ``accumulate_segment``).

    ``arrays`` leaves are [N] or carry a leading layer-batch axis [B, N]
    (torch tensors on one device, or numpy arrays, taken on the CPU); the
    output is then [num_points] or [B, num_points].  ``origin`` is the
    segment's global offset, ``total_points`` the global grid size.
    """
    arrays = {name: torch.as_tensor(a) for name, a in arrays.items()}
    single = arrays["prefactor"].dim() == 1
    if single:
        arrays = {name: a[None] for name, a in arrays.items()}
    k = _accumulate_impl(arrays, origin, int(num_points), int(total_points),
                         int(window), int(core_window), int(chunk))
    return k[0] if single else k


def static_params(kin, n_per_v, cut_off, chunk=2048):
    """The window sizes and chunk for a pack: (window, core half width,
    chunk)."""
    window = (2 * cut_off + 1) * n_per_v + 1
    core_w = core_halfwidth(
        {"y": kin["y"], "repwid": kin["repwid"]}, n_per_v, cut_off)
    chunk = int(np.clip(2 ** int(np.log2(4.0e6 / window)), 128, chunk))
    return window, core_w, chunk


def accumulate(kernel_arrays, num_points, n_per_v, cut_off, chunk=2048,
               device="cuda"):
    """Sums all line contributions onto the internal spectral grid, the
    portable way (JAX ``accumulate``).

    Args:
        kernel_arrays: dict from :func:`prepare_kernel_arrays` ([N] host
            arrays; their float dtype is the computation's).
        num_points: internal grid size (vn - v0) * n_per_v.
        n_per_v: grid points per wavenumber.
        cut_off: wing cut-off [cm-1].
        chunk: most lines per step; the step takes
            clip(2**floor(log2(4e6 / window)), 128, chunk) lines, so the
            per-step working set (:func:`_accumulate_impl`) stays near 4e6
            candidate points per layer whatever the grid.
        device: torch device of the computation and the result: the card
            by default (raising without one); "cpu" runs on the host.

    Returns:
        [num_points] tensor of absorption cross sections (same units as
        the prefactor; m2 when physics supplied SI strengths).
    """
    device = resolve_device(device)
    repwid = np.asarray(kernel_arrays["scaled_repwid"], np.float64) * n_per_v
    window, core_w, chunk = static_params(
        {"y": kernel_arrays["y"], "repwid": repwid}, n_per_v, cut_off, chunk)
    arrays, _ = _pad_lines(kernel_arrays, chunk)
    arrays = {name: torch.as_tensor(np.ascontiguousarray(a), device=device)
              for name, a in arrays.items()}
    return accumulate_segment(arrays, 0, num_points, num_points, window,
                              core_w, chunk)
