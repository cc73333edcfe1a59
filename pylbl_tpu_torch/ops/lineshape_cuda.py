"""Windowed Voigt summation on the card: host plans, CUDA kernels, plain twins.

Counterpart of pylbl_tpu/ops/lineshape_pallas.py for the stacked
all-gases path.  Three parts:

1. **Host planners**, copied from the JAX package as numpy (the port cannot
   import it): per-tile line CSRs (:func:`tile_line_ranges`), the
   overlapped-tile strided wings layout (:func:`plan_strided_stage` and its
   helpers) and the mixed-slot segment-32 core plan (:class:`CorePlan`,
   :func:`build_core_segments_mixed`).  Tests hold them byte-identical to
   the JAX planners.
2. **Kernel wrappers.**  :func:`wings_strided_pass` (strided prepacked
   wings, with or without the tail chunk class), :func:`wings_splat_pass`
   (the splat fallback on fine grids) and :func:`core_segmix_pass` (the
   mixed-slot Humlicek core).  On CUDA tensors each launches its
   hand-written kernel from ``csrc/lineshape.cu`` (built on first use,
   runtime/build.py) and adds one to its entry in :data:`LAUNCHES`; on CPU
   tensors it runs the plain version.  There is no fallback between the
   two: a CUDA tensor that the kernel does not take raises.
3. **Plain PyTorch versions** (``*_plain``) with the same plan, tile,
   chunking and summation order as the kernels (two-level chunk sums, warp
   partials summed in warp order), in any float dtype and on any device.
   They work in slabs so they also run at main-path size on the card.

Kernel source notes (flags: ``-O3 -std=c++17 -gencode
arch=compute_90a,code=sm_90a -fmad=false``; no ``--use_fast_math``):

- Wings (replaces ``_tile_kernel_strided_pre_tail_batched``
  lineshape_pallas.py:2228, ``_tile_kernel_strided_pre_batched`` :2172 as
  its empty-tail case, and ``_tile_kernel_batched`` :1662 with
  ``_lorentz_line_pre`` :2088 for splat).  One block per (tile, layer);
  256 threads own the tile's points, chunks of the 8-row SoA are staged in
  shared memory and walked line by line in order.  Bound: one IEEE f32
  divide per line-point (``pref_y / (x*x + ysq)``), so it is bound by
  the instruction rate of the divide sequence, not by memory (each line
  is read once per tile from shared memory as a broadcast).
- Core (replaces ``_seg_kernel_mixed_batched`` :1148 with
  ``_seg_chunk_accumulate_mixed`` :1070).  One block of 4 warps per (tile,
  layer); per 128-instance chunk the class is picked from the chunk's min
  y (block-uniform branch), lane = point offset within the 32-point
  segment, each warp walks its 32 instances in order into a private
  [slot, offset] partial tile in shared memory, and the four partials are
  summed in warp order into the tile accumulator.  Bound: the Humlicek
  rationals (CPF12: 12 divides and an exp per point).  No tensor cores and
  no atomics: the slot scatter is a direct indexed add, so runs are
  bit-identical.
- ``-fmad=false`` keeps ``a*b + c`` as two rounded operations, so the
  kernels compute the same values, in the same order, as the plain
  versions and the JAX reference's separate multiply and add.
"""
import ctypes
import shutil
from pathlib import Path

import numpy as np
import torch

from .voigt import (XLIM0_MAX, voigt_correction, voigt_correction_k1,
                    voigt_correction_k12, voigt_correction_k123)
from ..runtime.build import PACKAGE_DIR, load_library

# SoA row order in the packed (8, N) line block.
C_INT, C_FRAC, SRW, Y, PREF, S_IDX, E_IDX, _PAD = range(8)

DEFAULT_TILE = 1024
DEFAULT_CHUNK = 512
STRIDED_CHUNK = 256
ROWS_CHUNK = 128          # instances per core chunk.
SEG = 32                  # aligned segment width in points.
SEGP_ROWS = 8             # param rows per instance.
(SR_SEG0REL, SR_CFRAC, SR_SRW, SR_Y, SR_PREF, SR_SREL,
 SR_EREL, SR_SLOT) = range(8)

# Core-correction classes by chunk min y (lineshape_pallas.py:1102-1110).
_CORE_CLASSES = ((8.425, voigt_correction_k1), (6.8, voigt_correction_k12),
                 (2.0, voigt_correction_k123), (-np.inf, voigt_correction))
_CORE_SKIP_Y = 70.55

# Launches of each CUDA kernel since the last reset_launches().
LAUNCHES = {"wings_strided": 0, "wings_splat": 0, "core_segmix": 0}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# --------------------------------------------------------------------------
# Host planners (numpy copies of lineshape_pallas.py).
# --------------------------------------------------------------------------

def core_halfwidths(repwid, n_per_v, cut_off):
    """Per-line core-window half widths in grid points
    (pylbl_tpu/ops/lineshape.py): cover |x| < XLIM0_MAX at the line's
    Doppler width, clipped to the wing window."""
    repwid = np.asarray(repwid, dtype=np.float64)
    width = np.ceil(XLIM0_MAX / np.maximum(repwid, 1e-300) * n_per_v) + 1
    return np.minimum(width, (cut_off + 1) * n_per_v).astype(np.int64)


def tile_line_ranges(window_start, window_end, num_points, tile, chunk):
    """Per-tile contiguous line ranges (host-side CSR construction).

    Args:
        window_start / window_end: [N] inclusive point-index windows per
            line, in nu-sorted order (running envelopes absorb the
            pressure-shift jitter; the in-kernel window mask stays exact).
        num_points: grid size.
        tile: tile width in points.
        chunk: line-chunk size (starts are aligned to it).

    Returns:
        (start[T_tiles] int32, nchunks[T_tiles] int32)
    """
    num_tiles = -(-num_points // tile)
    end_env = np.maximum.accumulate(window_end)
    start_env = np.minimum.accumulate(window_start[::-1])[::-1]
    tile_lo = np.arange(num_tiles, dtype=np.int64) * tile
    tile_hi = np.minimum(tile_lo + tile, num_points) - 1
    lo = np.searchsorted(end_env, tile_lo, side="left")
    hi = np.searchsorted(start_env, tile_hi, side="right")
    lo_aligned = (lo // chunk) * chunk
    nchunks = np.maximum(-(-(hi - lo_aligned) // chunk), 0)
    return lo_aligned.astype(np.int32), nchunks.astype(np.int32)


def build_core_segments_mixed(core_start, core_end, num_points,
                              tile=DEFAULT_TILE, seg=SEG, chunk=ROWS_CHUNK,
                              sort_key=None):
    """Packs per-line core windows into per-tile mixed-slot streams.

    Each line becomes one instance per ``seg``-point segment its core
    window touches; instances are grouped (and chunk-padded) per tile,
    y-descending within a tile, and carry their segment slot.

    Returns:
        (inst_line [I_pad] int64 with -1 dead lanes,
         seg0 [I_pad] int64 absolute segment base points,
         slot [I_pad] int32 segment slot within the tile,
         tile_start [T] int32 first chunk index per tile,
         tile_chunks [T] int32 chunk count per tile).
    """
    core_start = np.asarray(core_start)
    core_end = np.asarray(core_end)
    cs = np.clip(core_start, 0, num_points - 1)
    ce = np.clip(core_end, 0, num_points - 1)
    valid = (core_end >= core_start) & (core_end >= 0) \
        & (core_start < num_points)
    s0 = cs // seg
    s1 = ce // seg
    counts = np.where(valid, s1 - s0 + 1, 0).astype(np.int64)
    num_tiles = -(-num_points // tile)
    slots_per_tile = tile // seg

    inst_of = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    off = np.arange(inst_of.size, dtype=np.int64) - np.repeat(starts, counts)
    segidx = s0[inst_of] + off
    tile_of = segidx // slots_per_tile

    if sort_key is not None:
        key = -np.asarray(sort_key, np.float64)[inst_of]   # descending y
        order = np.lexsort((key, tile_of))
    else:
        order = np.argsort(tile_of, kind="stable")
    tile_s = tile_of[order]
    segidx_s = segidx[order]
    lines_s = inst_of[order]

    tile_counts = np.bincount(tile_s, minlength=num_tiles)
    tile_chunks = -(-tile_counts // chunk)
    tile_pad = tile_chunks * chunk
    col_start = np.concatenate(([0], np.cumsum(tile_pad)[:-1]))
    total = int(tile_pad.sum())

    size = max(total, chunk)
    inst_line = np.full(size, -1, dtype=np.int64)
    seg0 = np.zeros(size, dtype=np.int64)
    slot = np.zeros(size, dtype=np.int32)
    if tile_s.size:
        tile_first = np.concatenate(([0], np.cumsum(tile_counts)[:-1]))
        pos = np.arange(tile_s.size, dtype=np.int64) - tile_first[tile_s]
        dst = col_start[tile_s] + pos
        inst_line[dst] = lines_s
        seg0[dst] = segidx_s * seg
        slot[dst] = (segidx_s % slots_per_tile).astype(np.int32)
    tile_start = np.concatenate(([0], np.cumsum(tile_chunks)[:-1]))
    return (inst_line, seg0, slot, tile_start.astype(np.int32),
            tile_chunks.astype(np.int32))


class CorePlan:
    """Host-built plan for the mixed-slot segment-32 core pass.

    Counterpart of the JAX ``CorePlan`` in its production "segmix" mode
    (the A/B "seg" and "rows" modes are not ported)::

        plan = CorePlan(cs, ce, num_points, tile, sort_key=y)
        inst = plan.expand_line_arrays(line_tensors)   # once
        params = plan.seg_params(line_kernel_arrays(inst, ...))
        out = plan.core_pass(params)
    """

    def __init__(self, core_start, core_end, num_points, tile,
                 sort_key=None, chunk=ROWS_CHUNK, seg=SEG):
        self.seg = seg
        self.num_points = int(num_points)
        self.tile = tile
        self.chunk = chunk
        (self.inst_line, self.seg0, self.slot, self.t_start,
         self.t_chunks) = build_core_segments_mixed(
            core_start, core_end, num_points, tile=tile, seg=seg,
            chunk=chunk, sort_key=sort_key)
        self._dev = {}

    @property
    def num_instances(self):
        return int(self.inst_line.size)

    def _device_consts(self, device):
        """(inst index, seg0 f32, dead mask, slot f32, tile_start,
        tile_chunks) as tensors on ``device``, built once per device."""
        key = str(device)
        consts = self._dev.get(key)
        if consts is None:
            consts = (
                torch.as_tensor(np.maximum(self.inst_line, 0),
                                device=device),
                torch.as_tensor(self.seg0.astype(np.float32), device=device),
                torch.as_tensor(self.inst_line < 0, device=device),
                torch.as_tensor(self.slot.astype(np.float32), device=device),
                torch.as_tensor(self.t_start, device=device),
                torch.as_tensor(self.t_chunks, device=device))
            self._dev[key] = consts
        return consts

    def expand_line_arrays(self, arrays):
        """Instance-order copy of per-line tensors (``q_table`` passes
        through), gathered once at build time so each layer's core
        parameters come from running the elementwise line physics directly
        in instance space.  Dead lanes point at line 0 and are overwritten
        by :meth:`seg_params`' fills."""
        device = arrays["nu"].device
        idx = self._device_consts(device)[0]
        return {k: (v if k == "q_table" else v.index_select(0, idx))
                for k, v in arrays.items()}

    def seg_params(self, ka_inst):
        """[..., 8, I] core parameters from INSTANCE-order kernel arrays
        (rows seg0_rel, c_frac, srw, y, pref, s_rel, e_rel, slot; dead lanes
        get (0, 0, 1, 100, 0, 1, -1, 0): empty window, y above the
        pure-Lorentz threshold)."""
        device = ka_inst["c_frac"].device
        _, seg0f, dead, slotf, _, _ = self._device_consts(device)
        dtype = ka_inst["c_frac"].dtype
        seg0f = seg0f.to(dtype)
        fills = (0.0, 0.0, 1.0, 100.0, 0.0, 1.0, -1.0, 0.0)
        rows = (seg0f - ka_inst["c_int"].to(dtype),
                ka_inst["c_frac"],
                ka_inst["scaled_repwid"],
                ka_inst["y"],
                ka_inst["prefactor"],
                ka_inst["s_idx"].to(dtype) - seg0f,
                ka_inst["e_idx"].to(dtype) - seg0f,
                slotf.to(dtype))
        rows = torch.broadcast_tensors(*rows)
        return torch.stack([torch.where(dead, torch.as_tensor(f, dtype=dtype,
                                                              device=device),
                                        r)
                            for f, r in zip(fills, rows)], dim=-2)

    def core_pass(self, params, plain=False):
        """The core-correction pass: params [B, 8, I] -> [B, num_points]."""
        _, _, _, _, t_start, t_chunks = self._device_consts(params.device)
        fn = core_segmix_plain if plain else core_segmix_pass
        return fn(params, t_start, t_chunks, self.num_points, self.tile,
                  self.chunk, self.seg)


def pick_wings_stride(tile, window_max):
    """Largest power-of-two stride whose overlapped tiles fully contain
    every window; None if even tile//8 cannot (fall back to tile splat,
    whose waste ratio (tile + w)/w is small exactly when w is large)."""
    for stride in (tile // 2, tile // 4, tile // 8):
        if stride >= 128 and window_max <= tile - stride + 1:
            return stride
    return None


def padded_strided_layout_tail(assign, num_tiles, chunk=STRIDED_CHUNK,
                               tail=128):
    """Two-class chunk layout: full ``chunk``-wide chunks plus short
    ``tail``-wide chunks for each tile's remainder.  Tile t gets
    ``n_t // chunk`` full chunks and ``ceil((n_t % chunk) / tail)`` tail
    chunks, cutting the worst-case per-tile padding from chunk-1 to tail-1
    dead slots.  The wings kernel runs the tail chunks after the full ones.

    Returns:
        (perm [M] int64, w_start [T] i32 line units, w_n [T] i32 full
        chunks, t_start [T] i32 line units, t_n [T] i32 tail chunks);
        the tail region follows the (chunk-aligned) main region.
    """
    assign = np.asarray(assign, np.int64)
    if assign.size == 0:
        z = np.zeros(num_tiles, np.int32)
        return np.full(chunk, -1, np.int64), z, z, z.copy(), z.copy()
    order = np.argsort(assign, kind="stable")
    cnt = np.bincount(assign, minlength=num_tiles)
    full = cnt // chunk
    tchunks = -(-(cnt - full * chunk) // tail)
    main_first = np.concatenate(([0], np.cumsum(full)[:-1]))
    w_start = (main_first * chunk).astype(np.int64)
    main_total = int(full.sum()) * chunk
    tail_first = np.concatenate(([0], np.cumsum(tchunks)[:-1]))
    t_start = (main_total + tail_first * tail).astype(np.int64)
    total = max(main_total + int(tchunks.sum()) * tail, chunk)
    perm = np.full(total, -1, np.int64)
    cum = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    a = assign[order]
    rank = np.arange(order.size, dtype=np.int64) - cum[a]
    in_main = rank < full[a] * chunk
    pos = np.where(in_main, w_start[a] + rank,
                   t_start[a] + (rank - full[a] * chunk))
    perm[pos] = order
    return (perm, w_start.astype(np.int32), full.astype(np.int32),
            t_start.astype(np.int32), tchunks.astype(np.int32))


def padded_strided_layout(assign, num_tiles, chunk=STRIDED_CHUNK):
    """Chunk-aligned per-tile line layout (single chunk class): tile t's
    lines occupy ceil(n_t / chunk) PRIVATE chunks, padded with dead slots.

    Returns:
        (perm [M] int64, w_start [T] int32, w_n [T] int32): ``perm`` maps
        padded slots to source lines, -1 for dead slots.
    """
    assign = np.asarray(assign, np.int64)
    if assign.size == 0:
        z = np.zeros(num_tiles, np.int32)
        return np.full(chunk, -1, np.int64), z, z
    order = np.argsort(assign, kind="stable")
    cnt = np.bincount(assign, minlength=num_tiles)
    nchunks = -(-cnt // chunk)
    first_chunk = np.concatenate(([0], np.cumsum(nchunks)[:-1]))
    w_start = (first_chunk * chunk).astype(np.int64)
    total = max(int(nchunks.sum()), 1) * chunk
    perm = np.full(total, -1, np.int64)
    cum = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    a = assign[order]
    rank = np.arange(order.size, dtype=np.int64) - cum[a]
    perm[w_start[a] + rank] = order
    return perm, w_start.astype(np.int32), nchunks.astype(np.int32)


class StridedLayout:
    """Chunk-aligned per-tile wings layout plus its dead-slot bookkeeping
    (``assign`` is -1 for dead slots)."""

    def __init__(self, perm, w_start, w_n, assign, t_start=None,
                 t_n=None, tail=None):
        self.perm = perm
        self.idx = np.maximum(perm, 0)
        self.dead = perm < 0
        self.w_start = w_start
        self.w_n = w_n
        self.t_start = t_start   # tail-chunk CSR (two-class layout) or None
        self.t_n = t_n
        self.tail = tail
        self.assign = np.where(self.dead, -1, assign[self.idx])
        self.nlines = perm.size

    def gather_windows(self, lo, hi):
        """Permutes per-line window bounds; dead slots get the empty
        window (lo=1, hi=0) so the core plan drops them."""
        return (np.where(self.dead, 1, lo[self.idx]),
                np.where(self.dead, 0, hi[self.idx]))

    def gather(self, values):
        """Permutes any per-line array (dead slots copy line idx 0)."""
        return values[self.idx]


def _balanced_tile_assign(s, e, stride, tile, num_tiles, chunk):
    """Chunk-filling tile assignment for the overlapped strided layout:
    each line goes to its rightmost containing tile, then a left-fill
    greedy tops every tile's line count up to a chunk multiple with lines
    of later tiles whose window already fits (the chunk total never
    increases).  Returns the per-line tile assignment."""
    t_pref = np.minimum(s // stride, num_tiles - 1)
    # Leftmost containing tile: t*stride + tile - 1 >= e.
    t_min = np.maximum(-(-(e - tile + 1) // stride), 0)
    t_min = np.minimum(t_min, t_pref)
    assign = t_pref.copy()
    reach = int((t_pref - t_min).max(initial=0))
    if reach == 0:
        return assign
    order = np.lexsort((t_min, t_pref))   # by t_pref, then t_min
    cnt = np.bincount(t_pref, minlength=num_tiles)
    first = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    taken = np.zeros(num_tiles, np.int64)  # pulled-from count per t_pref
    pulled = np.zeros(num_tiles, np.int64)  # pulled-into count per tile
    for t in range(num_tiles - 1):
        n_t = cnt[t] - taken[t] + pulled[t]
        need = (-n_t) % chunk
        if need == 0:
            continue
        for tp in range(t + 1, min(t + reach + 1, num_tiles)):
            if need == 0:
                break
            # Candidates assigned to tp whose t_min <= t, not yet taken.
            lo = first[tp] + taken[tp]
            hi = first[tp] + cnt[tp]
            if lo >= hi:
                continue
            cand = order[lo:hi]
            ok = np.searchsorted(t_min[cand], t, side="right")
            m = min(need, int(ok))
            if m == 0:
                continue
            assign[cand[:m]] = t
            taken[tp] += m
            pulled[t] += m
            need -= m
    return assign


def build_strided_layout(s_wide, stride, num_points, chunk=STRIDED_CHUNK,
                         e_wide=None, tile=DEFAULT_TILE, tail=None):
    """Builds the :class:`StridedLayout` for widened window starts
    ``s_wide`` on a ``num_points`` grid with overlapped-tile ``stride``
    (2-choice balanced when ``e_wide`` is given; two-class chunks when
    ``tail`` is given)."""
    s = np.clip(np.asarray(s_wide, np.int64), 0, None)
    num_tiles = (num_points - 1) // stride + 1
    if e_wide is None:
        assign = s // stride
    else:
        e = np.minimum(np.clip(np.asarray(e_wide, np.int64), 0, None),
                       num_points - 1)
        assign = _balanced_tile_assign(s, np.maximum(e, s), stride, tile,
                                       num_tiles, chunk)
    if tail is not None:
        perm, w_start, w_n, t_start, t_n = padded_strided_layout_tail(
            assign, num_tiles, chunk, tail)
        return StridedLayout(perm, w_start, w_n, assign, t_start, t_n,
                             tail)
    perm, w_start, w_n = padded_strided_layout(assign, num_tiles, chunk)
    return StridedLayout(perm, w_start, w_n, assign)


def plan_strided_stage(s_wide, e_wide, core_lo, core_hi, y_ref, n_out,
                       tile=DEFAULT_TILE, chunk=STRIDED_CHUNK, stride=None,
                       tail=None):
    """Strided-wings + core plan for one line set and output grid.

    Returns:
        (stride, StridedLayout, CorePlan) with the core plan built over
        the layout-permuted windows, or None when no stride fits (callers
        fall back to the splat CSR).
    """
    if stride is None:
        stride = pick_wings_stride(
            tile, int((np.asarray(e_wide) - np.asarray(s_wide))
                      .max(initial=0)) + 1)
        if stride is None:
            return None
    lay = build_strided_layout(s_wide, stride, n_out, chunk=chunk,
                               e_wide=e_wide, tile=tile, tail=tail)
    c_lo, c_hi = lay.gather_windows(core_lo, core_hi)
    cp = CorePlan(c_lo, c_hi, n_out, tile, sort_key=lay.gather(y_ref))
    return stride, lay, cp


def permute_line_arrays(arrays, perm, zero_keys=("sw", "sw_pre")):
    """Applies a strided-layout perm to per-line constant arrays.

    Dead slots copy line 0's constants with the strength fields zeroed, so
    their per-layer prefactor is exactly 0.  ``q_table`` passes through;
    any other non-per-line field is an error.
    """
    idx = np.maximum(perm, 0)
    dead = perm < 0
    src_len = arrays["nu"].shape[0] if "nu" in arrays else None
    out = {}
    for k, v in arrays.items():
        if k == "q_table":
            out[k] = v
            continue
        if src_len is not None and (v.ndim != 1 or v.shape[0] != src_len):
            raise ValueError(
                f"permute_line_arrays: field {k!r} has shape {v.shape}, "
                f"expected a 1-D per-line array of length {src_len}")
        g = v[idx]
        if k in zero_keys:
            g = np.where(dead, np.zeros((), v.dtype), g)
        out[k] = g
    return out


# --------------------------------------------------------------------------
# CUDA library.
# --------------------------------------------------------------------------

CUDA_SOURCE = PACKAGE_DIR / "csrc" / "lineshape.cu"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else "nvcc"


def _nvcc_command(sources, out):
    return [nvcc_path(), *NVCC_FLAGS, *map(str, sources), "-o", str(out)]


def cuda_library():
    """The kernels' shared library, built with nvcc on first use."""
    lib = load_library("liblineshape_cuda.so", [CUDA_SOURCE], _nvcc_command)
    if not getattr(lib, "_pylbl_bound", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pylbl_wings.restype = ctypes.c_int
        lib.pylbl_wings.argtypes = [
            p, i64, i64,            # soa, batch stride, row stride
            p, p, p, p, i64,        # w_start, w_n, t_start, t_n, csr bstride
            p,                      # out [B, T, tile]
            i32, i32, i32, i32, i32, i32,  # B, T, tile, stride, chunk, tail
            p]                      # stream
        lib.pylbl_core_segmix.restype = ctypes.c_int
        lib.pylbl_core_segmix.argtypes = [
            p, i64, i64,            # params, batch stride, row stride
            p, p,                   # tile_start, tile_chunks
            p,                      # out [B, T, tile]
            i32, i32, i32, i32, i32,  # B, T, tile, chunk, seg
            p]                      # stream
        lib._pylbl_bound = True
    return lib


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr()) if tensor is not None \
        else ctypes.c_void_p(0)


def _check_cuda_inputs(name, data, csr, num_tiles):
    """Raises unless ``data`` is a contiguous float32 [B, 8, N] tensor and
    every CSR an int32 [T] or [B, T] tensor on its device."""
    if data.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{data.dtype}")
    if data.dim() != 3 or data.shape[1] != 8 or not data.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [B, 8, N] tensor")
    for c in csr:
        if c is None:
            continue
        if c.device != data.device:
            raise ValueError(f"{name}: CSR on {c.device}, data on "
                             f"{data.device}")
        if c.dtype != torch.int32 or c.stride(-1) != 1:
            raise TypeError(f"{name}: CSR must be int32 with unit stride")
        if c.shape[-1] != num_tiles or (c.dim() == 2 and c.shape[0]
                                        != data.shape[0]) or c.dim() > 2:
            raise ValueError(f"{name}: CSR of shape {tuple(c.shape)} for "
                             f"{num_tiles} tiles and {data.shape[0]} layers")


# --------------------------------------------------------------------------
# Wings: strided prepacked (ROADMAP K1/K3) and splat (K4).
# --------------------------------------------------------------------------

def _launch_wings(soa, w_start, w_n, t_start, t_n, num_tiles, tile,
                  stride, chunk, tail):
    _check_cuda_inputs("wings", soa, [w_start, w_n, t_start, t_n],
                       num_tiles)
    if tile not in (256, 512, 1024) or chunk > 512 or tail > 512 \
            or chunk <= 0 or tail <= 0:
        raise ValueError("wings kernel takes tile 256/512/1024 and chunk, "
                         "tail <= 512")
    batch = soa.shape[0]
    csr_bstride = w_start.stride(0) if w_start.dim() == 2 else 0
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=soa.device)
    err = cuda_library().pylbl_wings(
        _ptr(soa), soa.stride(0), soa.stride(1),
        _ptr(w_start), _ptr(w_n), _ptr(t_start), _ptr(t_n), csr_bstride,
        _ptr(out), batch, num_tiles, tile, stride, chunk,
        tail if t_start is not None else 0, _stream_ptr(soa.device))
    _check_launch("wings", err)
    return out


def _chunk_pairs(start, count, width, seq0, device):
    """Flattens a per-tile chunk CSR into (tile, first line, seq) pairs in
    tile-major, chunk order; seq = seq0[tile] + k for the tile's k-th
    chunk."""
    count = count.to(torch.int64)
    tiles = torch.repeat_interleave(
        torch.arange(count.numel(), device=device), count)
    first = torch.cumsum(count, 0) - count
    k = torch.arange(tiles.numel(), device=device) - first[tiles]
    line0 = start.to(torch.int64)[tiles] + k * width
    return tiles, line0, seq0[tiles] + k


def _wings_partials_plain(soa, tiles, line0, width, tile, stride,
                          max_elems=1 << 23):
    """[B, P, tile] per-chunk partial sums: for each (tile, chunk) pair,
    the chunk's ``width`` lines summed in line order (the first level of
    the two-level summation), in slabs of pairs."""
    batch = soa.shape[0]
    dtype = soa.dtype
    pairs = tiles.numel()
    out = soa.new_zeros((batch, pairs, tile))
    offs = torch.arange(tile, device=soa.device)
    slab = max(1, max_elems // max(batch * tile, 1))
    for lo in range(0, pairs, slab):
        hi = min(lo + slab, pairs)
        point = (tiles[lo:hi, None] * stride + offs[None, :]).to(dtype)
        part = soa.new_zeros((batch, hi - lo, tile))
        for j in range(width):
            vals = soa[:, :, line0[lo:hi] + j, None]     # [B, 8, P, 1]
            x = ((point - vals[:, C_INT]) - vals[:, C_FRAC]) * vals[:, SRW]
            val = vals[:, PREF] / (x * x + vals[:, Y])
            mask = (point >= vals[:, S_IDX]) & (point <= vals[:, E_IDX])
            part = part + torch.where(mask, val, torch.zeros_like(val))
        out[:, lo:hi] = part
    return out


def _fold_in_order(parts, tiles, seq, shape):
    """acc[tile] = ((0 + parts[seq 0]) + parts[seq 1]) + ... per tile, in
    seq order (the second level of the two-level summation).  Each seq
    value names at most one pair per tile, so every step is a plain
    indexed add without collisions."""
    acc = parts.new_zeros(shape)
    if seq.numel() == 0:
        return acc
    for j in range(int(seq.max()) + 1):
        sel = torch.nonzero(seq == j).flatten()
        t = tiles[sel]
        acc[:, t] = acc[:, t] + parts[:, sel]
    return acc


def wings_tiles_plain(soa, w_start, w_n, num_tiles, tile, stride, chunk,
                      t_start=None, t_n=None, tail=128):
    """Plain version of the wings kernel: [B, 8, N] prepacked SoA and a
    per-tile chunk CSR ([T], shared by every layer) -> [B, T, tile] tile
    sums; point = t * stride + offset, main chunks then tail chunks."""
    device = soa.device
    zero = torch.zeros(num_tiles, dtype=torch.int64, device=device)
    tiles, line0, seq = _chunk_pairs(w_start, w_n, chunk, zero, device)
    parts = _wings_partials_plain(soa, tiles, line0, chunk, tile, stride)
    if t_start is not None:
        tt, tl, ts = _chunk_pairs(t_start, t_n, tail,
                                  w_n.to(torch.int64), device)
        tparts = _wings_partials_plain(soa, tt, tl, tail, tile, stride)
        tiles = torch.cat([tiles, tt])
        seq = torch.cat([seq, ts])
        parts = torch.cat([parts, tparts], dim=1)
    return _fold_in_order(parts, tiles, seq,
                          (soa.shape[0], num_tiles, tile))


def strided_combine(out, num_points, tile, stride):
    """Overlap-add of strided tile outputs [B, T, tile] -> [B, num_points]
    (``_strided_combine``, lineshape_pallas.py:2382): tile/stride shifted
    adds in fixed order; deterministic plain torch."""
    ratio = tile // stride
    batch, num_tiles, _ = out.shape
    length = stride * (num_tiles - 1) + tile
    total = out.new_zeros((batch, length))
    for g in range(ratio):
        blk = out[:, g::ratio, :].reshape(batch, -1)
        lo = g * stride
        total[:, lo:lo + blk.shape[-1]] = total[:, lo:lo + blk.shape[-1]] \
            + blk
    return total[:, :num_points]


def _wings_plain(soa, w_start, w_n, num_points, tile, stride, chunk,
                 t_start, t_n, tail):
    num_tiles = (num_points - 1) // stride + 1
    tiles = wings_tiles_plain(soa, _shared_csr(w_start), _shared_csr(w_n),
                              num_tiles, tile, stride, chunk,
                              _shared_csr(t_start), _shared_csr(t_n), tail)
    return strided_combine(tiles, num_points, tile, stride)


def _wings(soa, w_start, w_n, num_points, tile, stride, chunk, t_start,
           t_n, tail, counter):
    if soa.device.type == "cpu":
        return _wings_plain(soa, w_start, w_n, num_points, tile, stride,
                            chunk, t_start, t_n, tail)
    if not soa.is_cuda:
        raise ValueError(f"no wings kernel for device {soa.device}")
    num_tiles = (num_points - 1) // stride + 1
    tiles = _launch_wings(soa, w_start, w_n, t_start, t_n, num_tiles, tile,
                          stride, chunk, tail)
    LAUNCHES[counter] += 1
    return strided_combine(tiles, num_points, tile, stride)


def _shared_csr(csr):
    """A [T] view of a layer-shared CSR ([T] or a [B, T] broadcast)."""
    if csr is None or csr.dim() == 1:
        return csr
    if not bool((csr == csr[:1]).all()):
        raise ValueError("plain wings take a CSR shared by all layers")
    return csr[0]


def wings_strided_pass(soa, w_start, w_n, num_points, tile, stride,
                       chunk=STRIDED_CHUNK, t_start=None, t_n=None,
                       tail=128):
    """Strided overlapped-tile prepacked wings -> [B, num_points].

    ``soa`` [B, 8, N] carries y^2 in the Y row and pref*y/sqrt(pi) in the
    PREF row; ``w_start``/``w_n`` (and optionally the tail class
    ``t_start``/``t_n``) are [T] int32 CSRs over the private per-tile
    chunks of :func:`padded_strided_layout_tail`."""
    if t_start is not None and tail % 128 != 0:
        raise ValueError("tail width must be a multiple of 128")
    return _wings(soa, w_start, w_n, num_points, tile, stride, chunk,
                  t_start, t_n, tail, "wings_strided")


def wings_splat_pass(soa, start, nchunks, num_points, tile,
                     chunk=DEFAULT_CHUNK):
    """Splat prepacked wings -> [B, num_points]: tile t sums its
    envelope-CSR line range (:func:`tile_line_ranges`) over points
    t*tile + offset, window-masked.  The CSR is [T] or a [B, T]
    broadcast."""
    return _wings(soa, start, nchunks, num_points, tile, tile, chunk,
                  None, None, 128, "wings_splat")


# --------------------------------------------------------------------------
# Core: mixed-slot segment-32 Humlicek correction (ROADMAP K2).
# --------------------------------------------------------------------------

def _launch_core(params, tile_start, tile_chunks, num_tiles, tile, chunk,
                 seg):
    _check_cuda_inputs("core", params, [tile_start, tile_chunks], num_tiles)
    if chunk != 128 or seg != 32 or tile % 128 or not 128 <= tile <= 1024 \
            or params.shape[2] % chunk:
        raise ValueError("core kernel takes chunk 128, seg 32, a tile of "
                         "128..1024 points and whole chunks of instances")
    batch = params.shape[0]
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=params.device)
    err = cuda_library().pylbl_core_segmix(
        _ptr(params), params.stride(0), params.stride(1),
        _ptr(tile_start), _ptr(tile_chunks), _ptr(out), batch, num_tiles,
        tile, chunk, seg, _stream_ptr(params.device))
    _check_launch("core", err)
    return out


def core_tiles_plain(params, tile_start, tile_chunks, num_tiles, tile,
                     chunk=ROWS_CHUNK, seg=SEG, max_elems=1 << 22):
    """Plain version of the core kernel: [B, 8, I] params -> [B, T, tile].

    Per (layer, chunk): class from the chunk's min y (skip at >= 70.55),
    ``pref * (K_class - K_lorentz)`` on the [instance, offset] block,
    window-masked; warp w (instances 32w..32w+31) adds its instances in
    order into a private [slot, offset] partial through a one-hot slot
    select; the chunk sum is ((p0 + p1) + p2) + p3; tiles fold their
    chunks in order."""
    device = params.device
    dtype = params.dtype
    batch = params.shape[0]
    slots = tile // seg
    warps = chunk // 32
    count = tile_chunks.to(torch.int64)
    nref = int(count.sum())
    chunk_tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=device), count)
    chunk_seq = torch.arange(nref, device=device) \
        - (torch.cumsum(count, 0) - count)[chunk_tile]
    chunk_id = tile_start.to(torch.int64)[chunk_tile] + chunk_seq
    blocks = params.reshape(batch, SEGP_ROWS, -1, chunk)
    blocks = blocks.index_select(2, chunk_id).permute(0, 2, 1, 3)
    ymin = blocks[:, :, SR_Y].amin(dim=-1)                  # [B, C]
    sums = params.new_zeros((batch, nref, slots, seg))
    offs = torch.arange(seg, device=device).to(dtype)
    onehot_slots = torch.arange(slots, device=device).to(dtype)
    taken = ymin >= _CORE_SKIP_Y
    for threshold, corr_fn in _CORE_CLASSES:
        cls = (~taken) & (ymin >= threshold)
        taken = taken | cls
        idx = torch.nonzero(cls)                            # [M, 2]
        per = max(1, max_elems // (chunk * seg))
        for lo in range(0, idx.shape[0], per):
            sel = idx[lo:lo + per]
            blk = blocks[sel[:, 0], sel[:, 1]]              # [M, 8, chunk]
            row = {r: blk[:, r, :, None] for r in range(SEGP_ROWS)}
            x = ((row[SR_SEG0REL] + offs) - row[SR_CFRAC]) * row[SR_SRW]
            val = corr_fn(x, row[SR_Y])
            mask = (offs >= row[SR_SREL]) & (offs <= row[SR_EREL])
            val = torch.where(mask, row[SR_PREF] * val,
                              torch.zeros_like(val))       # [M, chunk, seg]
            val = val.reshape(-1, warps, 32, seg)
            slot = blk[:, SR_SLOT].reshape(-1, warps, 32)
            part = val.new_zeros((val.shape[0], warps, slots, seg))
            for j in range(32):
                onehot = (slot[:, :, j, None] == onehot_slots).to(dtype)
                part = part + onehot[..., None] * val[:, :, j, None, :]
            chunk_sum = part[:, 0]
            for w in range(1, warps):
                chunk_sum = chunk_sum + part[:, w]
            sums[sel[:, 0], sel[:, 1]] = chunk_sum
    acc = _fold_in_order(sums, chunk_tile, chunk_seq,
                         (batch, num_tiles, slots, seg))
    return acc.reshape(batch, num_tiles, tile)


def _core_out(tiles, num_points):
    batch, num_tiles, tile = tiles.shape
    return tiles.reshape(batch, num_tiles * tile)[:, :num_points]


def core_segmix_pass(params, tile_start, tile_chunks, num_points, tile,
                     chunk=ROWS_CHUNK, seg=SEG):
    """Mixed-slot core pass -> [B, num_points] (point = t*tile + seg*slot
    + offset).  ``params`` [B, 8, I] from :meth:`CorePlan.seg_params`."""
    if params.device.type == "cpu":
        return core_segmix_plain(params, tile_start, tile_chunks, num_points,
                                 tile, chunk, seg)
    if not params.is_cuda:
        raise ValueError(f"no core kernel for device {params.device}")
    tiles = _launch_core(params, tile_start, tile_chunks,
                         -(-num_points // tile), tile, chunk, seg)
    LAUNCHES["core_segmix"] += 1
    return _core_out(tiles, num_points)


def core_segmix_plain(params, tile_start, tile_chunks, num_points, tile,
                      chunk=ROWS_CHUNK, seg=SEG):
    """:func:`core_segmix_pass` through the plain version on any device
    and float dtype."""
    num_tiles = -(-num_points // tile)
    return _core_out(core_tiles_plain(params, tile_start, tile_chunks,
                                      num_tiles, tile, chunk, seg),
                     num_points)


def wings_strided_plain(soa, w_start, w_n, num_points, tile, stride,
                        chunk=STRIDED_CHUNK, t_start=None, t_n=None,
                        tail=128):
    """:func:`wings_strided_pass` through the plain version on any device
    and float dtype."""
    return _wings_plain(soa, w_start, w_n, num_points, tile, stride, chunk,
                        t_start, t_n, tail)


def wings_splat_plain(soa, start, nchunks, num_points, tile,
                      chunk=DEFAULT_CHUNK):
    """:func:`wings_splat_pass` through the plain version on any device
    and float dtype."""
    return _wings_plain(soa, start, nchunks, num_points, tile, tile, chunk,
                        None, None, 128)
