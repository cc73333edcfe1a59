"""Windowed Voigt summation on the card: host plans, CUDA kernels, plain twins.

Counterpart of pylbl_tpu/ops/lineshape_pallas.py.  Four parts:

1. **Host planners**, copied from the JAX package as numpy (the port cannot
   import it): the SoA packer (:func:`pack_lines_soa`), per-tile line CSRs
   (:func:`tile_line_ranges`, and :func:`strided_line_ranges` over a
   near-sorted tile assignment), the overlapped-tile strided wings layout
   (:func:`plan_strided_stage` and its helpers), the exact per-layer core
   windows (:func:`core_instance_windows`) and the core plans
   (:class:`CorePlan` in its "segmix", "seg" and "rows" modes,
   :func:`build_core_segments_mixed`, :func:`build_core_segments`,
   :func:`gather_segment_params`, :func:`build_core_groups`,
   :func:`gather_group_params`).  Tests hold them byte-identical to the
   JAX planners.
2. **Kernel wrappers.**  :func:`wings_strided_pass` (strided prepacked
   wings, with or without the tail chunk class),
   :func:`wings_strided_checked_pass` (strided wings over a straddle CSR
   with the per-line ownership check), :func:`tile_pass` (the tile kernel
   at stride = tile with the prepacked, raw-Lorentz or per-line-correction
   line function), :func:`core_segmix_pass` (the mixed-slot Humlicek
   core), :func:`seg_pass` (the per-stream segment-32 pass, core or
   wings), :func:`rows_pass` (the rows core) and :func:`rows_vmem_pass`
   (the rows core with a separate group-min-y block).  Each takes a layer
   batch [B, 8, N] (rows: [B, 64, G]) or a single layer [8, N] ([64, G]),
   a batch of one.  On CUDA tensors each launches
   its hand-written kernel from ``csrc/lineshape.cu`` (built on first use,
   runtime/build.py) and adds one to its entry in :data:`LAUNCHES`; on CPU
   tensors it runs the plain version.  There is no fallback between the
   two: a CUDA tensor that the kernel does not take raises.  The tile,
   mixed-slot core and rows kernels split each tile's walk into pieces
   (:class:`TilePieces`), the segment pass works per chunk and folds per
   stream (:class:`SegStreams`); the plans build both once.
3. **Plain PyTorch versions** (``*_plain``) with the same plan, tile,
   chunking, summation order and term as the kernels (per-chunk
   partials, then pieces of :data:`WINGS_PIECE_CHUNKS` chunks for the tile
   kernel and :func:`core_piece_chunks` for the mixed-slot core, then the tile
   in piece order; the rows core per piece of :data:`ROWS_PIECE_GROUPS`
   groups; warp partials summed in warp order), in any float dtype and on
   any device.  They work in slabs so they also run at main-path size on
   the card.
4. **The single-layer device plan** (:class:`DevicePlan`,
   :func:`make_device_plan`, :func:`accumulate_device`, counterparts of
   ``DevicePlan``, ``make_device_plan`` and ``accumulate_tpu``).

Kernel source notes (flags: ``-O3 -std=c++17 -gencode
arch=compute_90a,code=sm_90a -fmad=false``; no ``--use_fast_math``):

- Tile kernel (replaces ``_tile_kernel_strided_pre(_tail)(_batched)``
  lineshape_pallas.py:2148-2257, ``_tile_kernel_strided(_batched)``
  :2260/:2321, and ``_tile_kernel(_batched)`` :1528/:1662 with
  ``_lorentz_line_pre`` :2088, ``_lorentz_line`` :110 or
  ``_correction_line`` :119).  One block per (piece, layer) of
  :data:`WINGS_PIECE_CHUNKS` chunks; the piece's chunks of the SoA are
  staged into a shared-memory ring with ``cp.async`` (two slots, one
  for a piece of one chunk).  The
  prepacked Lorentzian (every strided and splat wings pass of the main
  path), the raw Lorentzian (the splat of raw rows) and the
  ownership-checked raw Lorentzian take the Lorentzian walk: tile/4
  threads, a warp owning 128 consecutive points, the ring line-major,
  per 32 lines two ballots listing the lines that reach the warp's
  points and those that cover them, the listed lines walked in order
  (the covering ones without the window mask), the term ``pref_y *
  rcp(x^2 + y^2)``.  The raw kinds form each line's ``y^2`` and
  ``pref*y/sqrt(pi)`` from the raw rows first, and the checked kind
  leaves out, before the ballot, the foreign lines whose terms are all
  +/-0.0.  Bound: about 7 operations per in-window line-point, one a
  reciprocal (instruction issue, not memory).  The correction takes the
  unit walk (below) on the same ring.
- Mixed-slot core (replaces ``_seg_kernel_mixed(_batched)`` :1113/:1148
  with ``_seg_chunk_accumulate_mixed`` :1070).  One block of 4 warps per
  (piece, layer); per 128-instance chunk (the next one staged with
  ``cp.async``; class from the chunk's min y, block-uniform): lane =
  instance lists its window offsets that need a correction by Humlicek
  region (the y-only limits once an instance), a block scan packs the
  pairs by region, the warps evaluate 32 pairs of one region a round into
  a value block in shared memory, and warp w sums slots w, w+4, ... in
  the one-block order into its piece accumulator.  Bound: the Humlicek
  rationals of the points that need a correction (CPF12: 25 divides and
  an exp).  No tensor cores and no float atomics: the slot scatter is a
  direct indexed add and a split tile's pieces are folded in piece order
  by the last of them (an integer counter), so runs are bit-identical.
- The unit walk (CORR and the rows core).  Each line of a chunk (an
  instance of a piece) becomes an item: its class (CORR: the line's own
  y; the rows core: the group's min y) and its need window,
  the window narrowed to the points that can need a correction (a
  non-finite prefactor keeps its window).  A unit is an item with one
  point group of 32 points its need window meets; per pass of up to 256
  units, lane = unit classifies the unit's points by Humlicek region, the
  block lists the pairs by region, the warps evaluate 32 pairs of one
  region a round into a [unit][point] value block, and the warp that owns
  a point group adds its units in item order.  Bound: the Humlicek
  rationals of the points that need a correction.
- Per-stream segment pass (replaces ``_seg_kernel(_batched)`` :842/:880
  with ``_seg_chunk_accumulate`` :762 or ``_seg_chunk_accumulate_lorentz``
  :806).  A chunk carries one slot, so it adds to one (tile, slot) stream.
  A chunk kernel writes each walked chunk's sum in the one-block walk's
  order (warp partials over 32 instances in order, added in warp order)
  to a scratch row, and a second launch adds each stream's rows in walk
  order, one thread per point.  The core (``seg_core_kernel``): the
  chunk sum is the mixed-slot core's for one slot (the block's slot row
  is zero), so a block of 4 warps walks :func:`seg_core_piece` entries
  (each staged by TMA bulk copies while the last is worked) and runs the
  mixed-slot core's classify, list and evaluate phases on each.  The
  wings (``seg_wings_kernel``): each warp walks one entry on its own,
  staged with 16-byte ``cp.async``, its
  32-instance groups rewritten line-major with y^2, pref*y/sqrt(pi) and
  the window's lanes (a bit mask), a ballot listing the instances that
  reach the segment (a group that all reach takes its 32 terms
  unrolled), the term the IEEE quotient of the plain version.
  Bound: the Humlicek rationals of the points that need a correction
  (core), instruction issue beside the bytes of the 7 rows read (wings).
- Rows core (replaces ``_rows_kernel(_batched)`` :456/:505 and
  ``_rows_kernel_vmem`` :363).  One block of 8 warps per (piece, layer);
  warp r owns row r of the tile (tile/8 points), the piece's 32 groups of
  57 parameter rows are staged with 16-byte ``cp.async`` copies, the block
  walks the piece's 256 instances (the unit walk, the class from the
  group's min-y row or block), and warp r sums row r.  One running sum per
  point and piece, the pieces folded in order: a deviation from the JAX
  kernels' single running sum (``rows_tiles_plain``).  Bound: the
  Humlicek rationals of the points that need a correction.
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
from ..runtime.device import resolve_device
from ..utils.constants import RSQRPI
from ..utils.observability import metrics

# SoA row order in the packed (8, N) line block.
C_INT, C_FRAC, SRW, Y, PREF, S_IDX, E_IDX, _PAD = range(8)

DEFAULT_TILE = 1024
DEFAULT_CHUNK = 512
STRIDED_CHUNK = 256
MAX_CHUNK = 512           # lines per wings chunk (csrc kMaxChunk).
ROWS_CHUNK = 128          # instances per core chunk.
SEG = 32                  # aligned segment width in points.
SEGP_ROWS = 8             # param rows per instance.
(SR_SEG0REL, SR_CFRAC, SR_SRW, SR_Y, SR_PREF, SR_SREL,
 SR_EREL, SR_SLOT) = range(8)
# Rows-core group block (lineshape_pallas.py:166-171): 7 fields x 8 row
# slots, then the group's min y, then 7 zero rows.
ROW = 128                 # points per row at the default tile.
N_FIELDS = 7              # c_int, c_frac, srw, y, pref, s, e.
Y_FIELD = 3               # index of y in the group-params field order.
GROUP_ROWS = 64
YMIN_ROW = 56

# Chunks per piece of the mixed-slot core kernel's split chunk walk
# (:class:`TilePieces`, where :func:`core_piece_chunks` does not take one
# chunk) and of the tile kernel's (every wings pass: one chunk a block was
# the fastest of 1, 2 and 4 on every wings cell of the H100, PERF.md); the
# plain versions fold in the same pieces.
PIECE_CHUNKS = 4
WINGS_PIECE_CHUNKS = 1
# The mixed-slot core's blocks one wave of the H100 holds: 132 SMs, 6
# blocks of 128 threads an SM by the kernel's shared memory (kCoreBlocks).
CORE_WAVE_BLOCKS = 132 * 6
# The segment core's grid, which the launch passes to the kernel (pylbl_seg
# core_piece): a block walks SEG_CORE_PIECE entries of the stream-ordered
# chunk list where the layers hold at least SEG_CORE_MANY entries in all
# (four waves of the H100's 132 SMs x 6 blocks at that piece), else 1
# (:func:`seg_core_piece`).  Measured on Sc (2,909 entries: 1 the faster)
# and S16 (63,472: 4 the faster), not between them (PERF.md).  No value
# depends on it (each entry's sum stands alone).
SEG_CORE_PIECE = 4
SEG_CORE_MANY = 16 * CORE_WAVE_BLOCKS
# Groups per piece of the rows core's split group walk (the kernel's
# kRowsPiece): a quarter of a 128-group chunk, staged in one go (PERF.md
# says why this width).
ROWS_PIECE_GROUPS = 32

# Production core-pass formulation (lineshape_pallas.py CORE_MODE); "seg"
# (per-stream segments) and "rows" (8 instances per group, one per row)
# are the A/B modes.
CORE_MODE = "segmix"

# Core-correction classes by min y (lineshape_pallas.py:1102-1110).
_CORE_CLASSES = ((8.425, voigt_correction_k1), (6.8, voigt_correction_k12),
                 (2.0, voigt_correction_k123), (-np.inf, voigt_correction))
_CORE_SKIP_Y = 70.55

# Launches of each CUDA kernel wrapper since the last reset_launches():
# the strided wings, splat wings and mixed-slot core on layer batches,
# the strided wings and mixed-slot core on single layers ([8, N] inputs),
# the tile kernel's raw-Lorentz and correction line functions, the
# segment passes, the rows core (batched, single, separate min-y block)
# and the ownership-checked strided wings (batched, single).
LAUNCHES = {"wings_strided": 0, "wings_splat": 0, "core_segmix": 0,
            "wings_strided_single": 0, "wings_strided_tail_single": 0,
            "core_segmix_single": 0, "tile_lorentz": 0,
            "tile_correction": 0, "seg_core": 0, "seg_wings": 0,
            "core_rows": 0, "core_rows_single": 0, "core_rows_vmem": 0,
            "wings_strided_checked": 0, "wings_strided_checked_single": 0}


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


def pack_lines_soa(arrays, chunk=DEFAULT_CHUNK, dtype=np.float32):
    """Packs kernel arrays into the ([B,] 8, N_padded) SoA block.

    Args:
        arrays: dict from ops.lineshape.prepare_kernel_arrays, leaves [N]
            or layer-batched [B, N].
        chunk: line-chunk size; N is padded to a multiple of it with dead
            lines (window [-1, -2] so every point masks off).
        dtype: block dtype (float32 for the kernels; float64 for the plain
            reference).

    Returns:
        (soa[..., 8, N_padded], num_lines).
    """
    num = arrays["prefactor"].shape[-1]
    batch = arrays["prefactor"].shape[:-1]
    padded = -num % chunk
    total = num + padded
    soa = np.zeros(batch + (8, total), dtype=dtype)
    soa[..., C_INT, :num] = arrays["c_int"]
    soa[..., C_FRAC, :num] = arrays["c_frac"]
    soa[..., SRW, :num] = arrays["scaled_repwid"]
    soa[..., Y, :num] = arrays["y"]
    soa[..., PREF, :num] = arrays["prefactor"]
    soa[..., S_IDX, :num] = arrays["s_idx"]
    soa[..., E_IDX, :num] = arrays["e_idx"]
    soa[..., S_IDX, num:] = -1.0
    soa[..., E_IDX, num:] = -2.0
    soa[..., SRW, num:] = 1.0
    # Dead-line y sits above the pure-Lorentz threshold (70.55) so the
    # scalar core pass's per-line branch skips padded lines outright.
    soa[..., Y, num:] = 100.0
    return soa, num


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


def _core_instances(core_start, core_end, num_points, seg):
    """(line index, segment index) of every instance: one per ``seg``-point
    segment a line's clipped core window touches (entries with end < start
    or outside the grid are dropped)."""
    core_start = np.asarray(core_start)
    core_end = np.asarray(core_end)
    cs = np.clip(core_start, 0, num_points - 1)
    ce = np.clip(core_end, 0, num_points - 1)
    valid = (core_end >= core_start) & (core_end >= 0) \
        & (core_start < num_points)
    s0 = cs // seg
    s1 = ce // seg
    counts = np.where(valid, s1 - s0 + 1, 0).astype(np.int64)
    inst_of = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    off = np.arange(inst_of.size, dtype=np.int64) - np.repeat(starts, counts)
    return inst_of, s0[inst_of] + off


def build_core_segments(core_start, core_end, num_points,
                        tile=DEFAULT_TILE, seg=SEG, chunk=ROWS_CHUNK,
                        sort_key=None):
    """Packs per-line core windows into aligned ``seg``-point segment
    streams, one per (tile, slot), each padded to whole chunks.

    Instances within a stream are ordered by descending ``sort_key``
    (typically y) so chunks are y-class homogeneous.

    Returns:
        (inst_line [I_pad] int64 with -1 dead lanes,
         seg0 [I_pad] int64 segment base points,
         tile_start [T] int32 first chunk index per tile,
         tile_chunks [T] int32 chunk count per tile,
         chunk_slot [C] int32 segment slot (seg0 % tile) // seg per chunk).
    """
    inst_of, segidx = _core_instances(core_start, core_end, num_points, seg)
    num_tiles = -(-num_points // tile)
    slots_per_tile = tile // seg
    n_streams = num_tiles * slots_per_tile

    if sort_key is not None:
        key = -np.asarray(sort_key, np.float64)[inst_of]   # descending y
        order = np.lexsort((key, segidx))
    else:
        order = np.argsort(segidx, kind="stable")
    segidx_s = segidx[order]
    lines_s = inst_of[order]

    stream_counts = np.bincount(segidx_s, minlength=n_streams)
    stream_chunks = -(-stream_counts // chunk)
    stream_pad = stream_chunks * chunk
    col_start = np.concatenate(([0], np.cumsum(stream_pad)[:-1]))
    total = int(stream_pad.sum())

    size = max(total, chunk)
    inst_line = np.full(size, -1, dtype=np.int64)
    seg0 = np.zeros(size, dtype=np.int64)
    if segidx_s.size:
        stream_first = np.concatenate(([0], np.cumsum(stream_counts)[:-1]))
        pos = np.arange(segidx_s.size, dtype=np.int64) \
            - stream_first[segidx_s]
        inst_line[col_start[segidx_s] + pos] = lines_s
    if total:
        seg0[:total] = np.repeat(
            np.arange(n_streams, dtype=np.int64) * seg, stream_pad)

    chunks_per_tile = stream_chunks.reshape(num_tiles,
                                            slots_per_tile).sum(axis=1)
    tile_start = np.concatenate(([0], np.cumsum(chunks_per_tile)[:-1]))
    slot_of_stream = np.arange(n_streams, dtype=np.int64) % slots_per_tile
    chunk_slot = np.repeat(slot_of_stream, stream_chunks).astype(np.int32)
    if chunk_slot.size == 0:
        chunk_slot = np.zeros(1, np.int32)
    return (inst_line, seg0, tile_start.astype(np.int32),
            chunks_per_tile.astype(np.int32), chunk_slot)


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
    inst_of, segidx = _core_instances(core_start, core_end, num_points, seg)
    num_tiles = -(-num_points // tile)
    slots_per_tile = tile // seg
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


# Dead-lane fills of a segment parameter block: empty window, zero
# strength, y above the pure-Lorentz threshold.
_SEG_FILLS = (0.0, 0.0, 1.0, 100.0, 0.0, 1.0, -1.0, 0.0)


def gather_segment_params(kernel_arrays, inst_line, seg0, slot=None,
                          dtype=np.float32):
    """Builds the ([B,] 8, I_pad) segment-parameter block on the host.

    Rows: seg0_rel = seg0 - c_int (exact small integer), c_frac,
    scaled_repwid, y, prefactor, s_rel = s_idx - seg0, e_rel = e_idx -
    seg0, and the slot row (``slot`` per instance for the mixed-slot
    kernel; zeros otherwise).  Dead lanes (inst_line < 0) get
    (0, 0, 1, 100, 0, 1, -1, 0).  C-contiguous, as the kernels take it.
    """
    fields = ("c_int", "c_frac", "scaled_repwid", "y", "prefactor", "s_idx",
              "e_idx")
    mat = np.stack(
        [kernel_arrays[name].astype(dtype) for name in fields]
        + [np.zeros_like(kernel_arrays["y"], dtype=dtype)],
        axis=-1)                                     # [..., N, 8]
    idx = np.maximum(np.asarray(inst_line), 0)
    g = mat[..., idx, :]                             # [..., I, 8]
    seg0f = np.asarray(seg0).astype(dtype)
    slotf = (np.zeros_like(seg0f) if slot is None
             else np.asarray(slot).astype(dtype))
    vals = np.stack([
        seg0f - g[..., 0],                           # seg0_rel
        g[..., 1],                                   # c_frac
        g[..., 2],                                   # srw
        g[..., 3],                                   # y
        g[..., 4],                                   # pref
        g[..., 5] - seg0f,                           # s_rel
        g[..., 6] - seg0f,                           # e_rel
        slotf + np.zeros_like(g[..., 7]),
    ], axis=-2)                                      # [..., 8, I]
    fills = np.asarray(_SEG_FILLS, dtype)
    dead = np.asarray(inst_line) < 0
    return np.ascontiguousarray(np.where(dead[..., None, :], fills[:, None],
                                         vals))


def segment_params(ka_inst, seg0f, slotf, dead):
    """[..., 8, I] segment parameters from INSTANCE-order kernel array
    tensors and the plan's per-instance seg0, slot row and dead mask
    (tensors on their device): the rows of :func:`gather_segment_params`,
    dead lanes filled."""
    dtype = ka_inst["c_frac"].dtype
    seg0f = seg0f.to(dtype)
    rows = (seg0f - ka_inst["c_int"].to(dtype),
            ka_inst["c_frac"],
            ka_inst["scaled_repwid"],
            ka_inst["y"],
            ka_inst["prefactor"],
            ka_inst["s_idx"].to(dtype) - seg0f,
            ka_inst["e_idx"].to(dtype) - seg0f,
            slotf.to(dtype))
    rows = torch.broadcast_tensors(*rows)
    # Python scalar fills: a fill made a card tensor would be a host copy
    # that waits for the card on every call.
    return torch.stack([torch.where(dead, float(f), r)
                        for f, r in zip(_SEG_FILLS, rows)], dim=-2)


def core_instance_windows(kernel_arrays, kin, num_points, n_per_v, cut_off):
    """Per-line core-correction point windows for instance grouping.

    Lines with (float32) y >= 70.55 are pure Lorentzian in the reference
    (voigt.c:17-27): their correction is identically zero, so they are
    dropped here instead of being skipped inside the kernel.
    """
    core_w = core_halfwidths(kin["repwid"], n_per_v, cut_off)
    s_idx = kernel_arrays["s_idx"].astype(np.int64)
    e_idx = kernel_arrays["e_idx"].astype(np.int64)
    center = np.rint(kernel_arrays["c_int"]).astype(np.int64)
    cs = np.maximum(center - core_w, s_idx)
    ce = np.minimum(center + core_w, e_idx)
    ce = np.where(kernel_arrays["y"].astype(np.float32) >= 70.55,
                  cs - 1, ce)
    return cs, ce


def build_core_groups(core_start, core_end, num_points, tile=DEFAULT_TILE,
                      chunk=ROWS_CHUNK, sort_key=None):
    """Packs per-line core windows into per-tile groups of 8 row instances.

    Each line becomes one instance per ``tile // 8``-point row its core
    window touches; instances are packed per tile into groups of 8, one
    per row slot (rows with fewer instances pad with dead slots), ordered
    by descending ``sort_key`` within each (tile, row) stream when given
    (nu order otherwise).

    Returns:
        (inst_line [8, G_total] int64 with -1 for dead slots,
         group_start [T] int32, group_chunks [T] int32); G_total is
        chunk-aligned per tile.
    """
    row_width = tile // 8
    cs = np.clip(core_start, 0, num_points - 1)
    ce = np.clip(core_end, 0, num_points - 1)
    valid = (np.asarray(core_end) >= np.asarray(core_start)) \
        & (np.asarray(core_end) >= 0) & (np.asarray(core_start) < num_points)
    r0 = cs // row_width
    r1 = ce // row_width
    counts = np.where(valid, r1 - r0 + 1, 0).astype(np.int64)
    num_tiles = -(-num_points // tile)

    inst_of = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    off = np.arange(inst_of.size, dtype=np.int64) - np.repeat(starts, counts)
    rows = r0[inst_of] + off

    if sort_key is not None:
        key = -np.asarray(sort_key, np.float64)[inst_of]   # descending y
        order = np.lexsort((key, rows))
    else:
        order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    lines_s = inst_of[order]

    rows_total = num_tiles * 8
    row_counts = np.bincount(rows_s, minlength=rows_total)
    per_tile = row_counts.reshape(num_tiles, 8)
    groups_t = per_tile.max(axis=1)
    padded_t = -(-groups_t // chunk) * chunk
    col_start = np.concatenate(([0], np.cumsum(padded_t)[:-1]))
    total = int(padded_t.sum())

    inst_line = np.full((8, max(total, chunk)), -1, dtype=np.int64)
    if rows_s.size:
        row_first = np.concatenate(([0], np.cumsum(row_counts)[:-1]))
        pos = np.arange(rows_s.size, dtype=np.int64) - row_first[rows_s]
        inst_line[rows_s % 8, col_start[rows_s // 8] + pos] = lines_s
    return (inst_line, col_start.astype(np.int32),
            (padded_t // chunk).astype(np.int32))


# Group-block fields in row order, with their dead-slot fills: an empty
# window, zero strength, and y above the pure-Lorentz threshold (a dead
# slot never drags a group's min y below a cheap class).
_GROUP_FIELDS = (("c_int", 0.0), ("c_frac", 0.0), ("scaled_repwid", 1.0),
                 ("y", 100.0), ("prefactor", 0.0), ("s_idx", -1.0),
                 ("e_idx", -2.0))


def gather_group_params(kernel_arrays, inst_line, dtype=np.float32):
    """Builds the ([B,] 64, G) group-parameter block on the host.

    Row f*8 + r holds field f of the instance in row slot r (f < 7); row
    56 holds the group's min y (dead-slot fills included); rows 57-63 are
    zero.  One row gather of a stacked [..., N, 8] matrix.  C-contiguous.
    """
    mat = np.stack(
        [kernel_arrays[name].astype(dtype) for name, _ in _GROUP_FIELDS]
        + [np.zeros_like(kernel_arrays["y"], dtype=dtype)],
        axis=-1)                                     # [..., N, 8]
    slots, num_groups = inst_line.shape
    idx = np.maximum(inst_line, 0).reshape(-1)
    taken = mat[..., idx, :].reshape(
        mat.shape[:-2] + (slots, num_groups, 8))     # [..., 8, G, 8]
    fills = np.asarray([fill for _, fill in _GROUP_FIELDS] + [0.0], dtype)
    taken = np.where((inst_line < 0)[..., None], fills, taken)
    blocks = np.moveaxis(taken, -1, -3)              # [..., field, slot, G]
    blocks = blocks.reshape(mat.shape[:-2]
                            + (GROUP_ROWS, num_groups))[..., :YMIN_ROW, :]
    ymin = np.min(blocks[..., Y_FIELD * 8:(Y_FIELD + 1) * 8, :], axis=-2,
                  keepdims=True)
    pad = np.zeros(ymin.shape[:-2] + (GROUP_ROWS - YMIN_ROW - 1,)
                   + ymin.shape[-1:], dtype)
    return np.ascontiguousarray(np.concatenate([blocks, ymin, pad], axis=-2))


def group_min_y(groups):
    """Per-group minimum y (row YMIN_ROW of the group block), ([B,] 1, G),
    a view."""
    return groups[..., YMIN_ROW:YMIN_ROW + 1, :]


def strided_line_ranges(assign, num_tiles, chunk=STRIDED_CHUNK):
    """Per-tile contiguous chunk ranges over a near-sorted tile assignment
    (the straddle CSR of the ownership-checked strided wings): running
    min/max envelopes give a contiguous superset range per tile, aligned
    down to the chunk, so neighbouring tiles read shared chunks and the
    kernel's ownership check drops the foreign lines."""
    if assign.size == 0:
        z = np.zeros(num_tiles, np.int32)
        return z, z
    amax = np.maximum.accumulate(assign)
    amin = np.minimum.accumulate(assign[::-1])[::-1]
    tiles = np.arange(num_tiles, dtype=np.int64)
    lo = np.searchsorted(amax, tiles, side="left")
    hi = np.searchsorted(amin, tiles, side="right")
    lo_aligned = (lo // chunk) * chunk
    nchunks = np.maximum(-(-(hi - lo_aligned) // chunk), 0)
    return lo_aligned.astype(np.int32), nchunks.astype(np.int32)


class CorePlan:
    """Host-built plan for a core pass (counterpart of the JAX
    ``CorePlan``)::

        plan = CorePlan(cs, ce, num_points, tile, sort_key=y)
        params = plan.gather(kernel_arrays)            # host numpy, or
        inst = plan.expand_line_arrays(line_tensors)   # once, then per layer
        params = plan.seg_params(line_kernel_arrays(inst, ...))
        out = plan.core_pass(params)

    ``mode``: "segmix" (per-tile mixed-slot streams, the production core),
    "seg" (per-(tile, slot) streams) or "rows" (per-tile groups of 8 row
    instances; parameters from :meth:`gather` on the host or
    :meth:`group_params` from per-line tensors).  ``kind``: "core"
    (Humlicek correction) or "wings" (Lorentzian; seg mode only,
    parameters from :meth:`wings_params`).
    """

    def __init__(self, core_start, core_end, num_points, tile,
                 sort_key=None, mode=None, chunk=ROWS_CHUNK, kind="core",
                 seg=SEG):
        self.mode = CORE_MODE if mode is None else mode
        self.kind = kind
        self.seg = seg
        self.num_points = int(num_points)
        self.tile = tile
        self.chunk = chunk
        if kind != "core" and self.mode != "seg":
            raise ValueError("wings-kind plans require seg mode")
        if self.mode == "seg":
            (self.inst_line, self.seg0, self.t_start, self.t_chunks,
             self.c_slot) = build_core_segments(
                core_start, core_end, num_points, tile=tile, seg=seg,
                chunk=chunk, sort_key=sort_key)
            self.slot = None
            self.streams = SegStreams(self.t_start, self.t_chunks,
                                      self.c_slot, tile // seg)
        elif self.mode == "segmix":
            (self.inst_line, self.seg0, self.slot, self.t_start,
             self.t_chunks) = build_core_segments_mixed(
                core_start, core_end, num_points, tile=tile, seg=seg,
                chunk=chunk, sort_key=sort_key)
            self.c_slot = None
            self.pieces = TilePieces.of_core(self.t_chunks)
        elif self.mode == "rows":
            self.inst_line, self.g_start, self.g_n = build_core_groups(
                core_start, core_end, num_points, tile, chunk,
                sort_key=sort_key)
            self.slot = self.seg0 = self.t_start = self.t_chunks = \
                self.c_slot = None
            self.walk = GroupWalk(self.g_start, self.g_n, chunk)
        else:
            raise ValueError(f"unknown core mode {self.mode!r}")
        self._dev = {}

    @property
    def num_instances(self):
        return int(self.inst_line.size)

    @property
    def _slotf(self):
        """Per-instance slot row (segmix) or zeros (seg), float32."""
        if self.slot is None:
            return np.zeros(self.inst_line.size, np.float32)
        return self.slot.astype(np.float32)

    def _device_consts(self, device):
        """Instance index, dead mask and (segment modes) seg0, the slot row
        and the chunk CSRs as tensors on ``device``, built once per
        device."""
        key = str(device)
        consts = self._dev.get(key)
        if consts is None:
            def dev(a):
                return None if a is None else torch.as_tensor(a,
                                                               device=device)
            consts = {"idx": dev(np.maximum(self.inst_line, 0).reshape(-1)),
                      "dead": dev(self.inst_line < 0)}
            if self.mode != "rows":
                consts.update(seg0f=dev(self.seg0.astype(np.float32)),
                              slotf=dev(self._slotf),
                              t_start=dev(self.t_start),
                              t_chunks=dev(self.t_chunks),
                              c_slot=dev(self.c_slot))
            self._dev[key] = consts
        return consts

    def _require_seg(self, what):
        if self.mode not in ("seg", "segmix"):
            raise ValueError(f"{what} requires seg or segmix mode")

    def expand_line_arrays(self, arrays):
        """Instance-order copy of per-line tensors (``q_table`` passes
        through), gathered once at build time so each layer's core
        parameters come from running the elementwise line physics directly
        in instance space.  Dead lanes point at line 0 and are overwritten
        by :meth:`seg_params`' fills.  Segment modes only (the rows block
        is gathered per layer by :meth:`group_params`)."""
        self._require_seg("expand_line_arrays")
        idx = self._device_consts(arrays["nu"].device)["idx"]
        return {k: (v if k == "q_table" else v.index_select(0, idx))
                for k, v in arrays.items()}

    def group_params(self, ka):
        """[..., 64, G] rows-core group block from PER-LINE kernel array
        tensors [..., N] (rows mode): the block :meth:`gather` builds on
        the host, as one row gather of the stacked [..., N, 8] matrix on
        the tensors' device, in their float dtype."""
        if self.mode != "rows":
            raise ValueError("group_params requires rows mode")
        c = self._device_consts(ka["c_frac"].device)
        dtype = ka["c_frac"].dtype
        ref = torch.broadcast_tensors(*(ka[name] for name, _ in
                                        _GROUP_FIELDS))
        mat = torch.stack([r.to(dtype) for r in ref]
                          + [torch.zeros_like(ref[1], dtype=dtype)], dim=-1)
        slots, num_groups = self.inst_line.shape
        taken = mat.index_select(-2, c["idx"]).reshape(
            mat.shape[:-2] + (slots, num_groups, 8))
        fills = torch.as_tensor([fill for _, fill in _GROUP_FIELDS] + [0.0],
                                dtype=dtype, device=mat.device)
        taken = torch.where(c["dead"][..., None], fills, taken)
        blocks = taken.movedim(-1, -3).reshape(
            mat.shape[:-2] + (GROUP_ROWS, num_groups))[..., :YMIN_ROW, :]
        ymin = blocks[..., Y_FIELD * 8:(Y_FIELD + 1) * 8, :].amin(
            dim=-2, keepdim=True)
        pad = ymin.new_zeros(ymin.shape[:-2] + (GROUP_ROWS - YMIN_ROW - 1,
                                                num_groups))
        return torch.cat([blocks, ymin, pad], dim=-2).contiguous()

    def seg_params(self, ka_inst):
        """[..., 8, I] core parameters from INSTANCE-order kernel arrays
        (tensors): the block :meth:`gather` builds, without the per-layer
        gather."""
        self._require_seg("seg_params")
        c = self._device_consts(ka_inst["c_frac"].device)
        return segment_params(ka_inst, c["seg0f"], c["slotf"], c["dead"])

    def wings_params(self, ka_inst):
        """[..., 8, I] wings parameters from INSTANCE-order host kernel
        arrays (wings-kind plans): the raw SoA rows C_INT..E_IDX in
        absolute grid coordinates, dead lanes with an empty window and
        zero strength."""
        if self.kind != "wings":
            raise ValueError("wings_params requires a wings-kind plan")
        dtype = ka_inst["c_frac"].dtype
        dead = self.inst_line < 0
        rows = (ka_inst["c_int"].astype(dtype),
                ka_inst["c_frac"],
                ka_inst["scaled_repwid"],
                ka_inst["y"],
                ka_inst["prefactor"],
                ka_inst["s_idx"].astype(dtype),
                ka_inst["e_idx"].astype(dtype),
                np.zeros_like(ka_inst["c_frac"]))
        return np.ascontiguousarray(np.stack(
            [np.where(dead, dtype.type(f), r)
             for f, r in zip(_SEG_FILLS, rows)], axis=-2))

    def gather(self, kernel_arrays):
        """Per-layer core parameters from host kernel arrays, in their
        float dtype: [..., 8, I] (segment modes) or [..., 64, G] (rows)."""
        dtype = kernel_arrays["c_frac"].dtype
        if self.mode == "rows":
            return gather_group_params(kernel_arrays, self.inst_line, dtype)
        return gather_segment_params(kernel_arrays, self.inst_line,
                                     self.seg0, slot=self._slotf,
                                     dtype=dtype)

    def seg_pass(self, params, plain=False):
        """This plan's segment pass: params [..., 8, I] -> spectrum
        [..., num_points]."""
        self._require_seg("seg_pass")
        c = self._device_consts(params.device)
        if self.mode == "segmix":
            if plain:
                return core_segmix_plain(params, c["t_start"], c["t_chunks"],
                                         self.num_points, self.tile,
                                         self.chunk, self.seg,
                                         self.pieces.piece)
            return core_segmix_pass(params, c["t_start"], c["t_chunks"],
                                    self.num_points, self.tile, self.chunk,
                                    self.seg, self.pieces)
        if plain:
            return seg_plain(params, c["t_start"], c["t_chunks"], c["c_slot"],
                             self.num_points, self.tile, self.chunk, self.seg,
                             self.kind)
        return seg_pass(params, self.streams, self.num_points, self.tile,
                        self.chunk, self.seg, self.kind)

    def core_pass(self, params, plain=False):
        """The core-correction pass alone, any mode."""
        if self.mode != "rows":
            return self.seg_pass(params, plain)
        if plain:
            return _rows_walk_plain(params, self.walk, self.num_points,
                                    self.tile)
        return rows_pass(params, self.walk, self.num_points, self.tile)


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
                       tile=DEFAULT_TILE, chunk=STRIDED_CHUNK,
                       core_mode=None, stride=None, tail=None):
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
    with metrics.timed("lines.layout"):
        lay = build_strided_layout(s_wide, stride, n_out, chunk=chunk,
                                   e_wide=e_wide, tile=tile, tail=tail)
        c_lo, c_hi = lay.gather_windows(core_lo, core_hi)
        sort_key = lay.gather(y_ref)
    with metrics.timed("lines.core_plan"):
        cp = CorePlan(c_lo, c_hi, n_out, tile, sort_key=sort_key,
                      mode=core_mode)
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
# The library's sources: the line-shape kernels and the pedestal remover's
# (csrc/pedestal.cu, bound by ops/pedestal_cuda.py).
CUDA_SOURCES = [CUDA_SOURCE, PACKAGE_DIR / "csrc" / "pedestal.cu"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Tile-kernel line functions by pass kind (lineshape_pallas.py
# _pass_line_fn): the kernel's line_fn id and the launch counter.  Line
# function 3 (OWN) is the ownership-checked raw Lorentzian of
# wings_strided_checked_pass.  The kernel walks 0 (PRE), 1 (RAW) and 3
# (OWN) as lorentz_walk_kernel and 2 (CORR) as corr_walk_kernel.
_TILE_LINES = {"wings_pre": (0, "wings_splat"), "wings": (1, "tile_lorentz"),
               "core": (2, "tile_correction")}
_LINE_OWN = 3
_SEG_KINDS = {"core": 0, "wings": 1}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else "nvcc"


def _nvcc_command(sources, out):
    return [nvcc_path(), *NVCC_FLAGS, *map(str, sources), "-o", str(out)]


# TilePieces.launch_args: piece tile, first, count and slot; pieces, scratch
# slots, K; scratch and counters.
_PIECE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p] * 2


def cuda_library():
    """The kernels' shared library, built with nvcc on first use."""
    return bind_library(load_library("liblineshape_cuda.so", CUDA_SOURCES,
                                     _nvcc_command))


def bind_library(lib):
    """Sets the argument types of the kernels' C entries on ``lib`` (a
    ctypes library built from ``csrc/lineshape.cu``, or from another
    version of it); returns ``lib``."""
    if not getattr(lib, "_pylbl_bound", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pylbl_wings.restype = ctypes.c_int
        lib.pylbl_wings.argtypes = [
            p, i64, i64,            # soa, batch stride, row stride
            p, p, p, p, i64,        # w_start, w_n, t_start, t_n, csr bstride
            p,                      # out [B, T, tile]
            i32, i32, i32, i32, i32, i32,  # B, T, tile, stride, chunk, tail
            i32,                    # line function
            *_PIECE_ARGS,
            p]                      # stream
        lib.pylbl_core_segmix.restype = ctypes.c_int
        lib.pylbl_core_segmix.argtypes = [
            p, i64, i64,            # params, batch stride, row stride
            p, p,                   # tile_start, tile_chunks
            p,                      # out [B, T, tile]
            i32, i32, i32, i32, i32,  # B, T, tile, chunk, seg
            *_PIECE_ARGS,
            p]                      # stream
        lib.pylbl_seg.restype = ctypes.c_int
        lib.pylbl_seg.argtypes = [
            p, i64, i64,            # params, batch stride, row stride
            p, p, i32, p,           # entry chunk, entry stream, E, ptr
            p, p,                   # sums [B, E, 32], out [B, T, tile]
            i32, i32, i32, i32, i32, i32,  # B, T, tile, chunk, seg, kind
            p,                      # stream
            i32]                    # core_piece
        lib.pylbl_rows.restype = ctypes.c_int
        lib.pylbl_rows.argtypes = [
            p, i64, i64,            # groups, batch stride, row stride
            p, i64,                 # separate min-y block or null, bstride
            p, p,                   # group_start, group_chunks
            p,                      # out [B, T, tile]
            i32, i32, i32, i32,     # B, T, tile, chunk
            *_PIECE_ARGS,
            p]                      # stream
        lib._pylbl_bound = True
    return lib


def _host(a):
    """An int64 numpy copy of a CSR given as numpy or as a tensor."""
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                      np.int64)


class TilePieces:
    """The piece split of the tile, mixed-slot core and rows kernels' walks
    (the port's own plan, built on top of the copied CSRs; the planners
    stay byte-identical to the JAX ones).

    Tile t's walk of ``counts[t]`` units (chunks, or groups for the rows
    core) is cut into ``max(1, ceil(counts[t] / K))`` pieces of ``K =
    piece`` units (:data:`PIECE_CHUNKS` by default); piece j walks units
    j*K .. min((j+1)*K, count) - 1, one block per (piece, layer).  For
    [B, T] counts the split follows the most over the layers and each
    layer's block clips the range to its own count (an empty piece adds
    +0.0).  Pieces of a split tile own consecutive scratch slots.
    """

    def __init__(self, counts, piece=PIECE_CHUNKS):
        counts = np.asarray(counts, np.int64)
        counts = counts.reshape(-1, counts.shape[-1]).max(axis=0) \
            if counts.size else np.zeros(counts.shape[-1], np.int64)
        self.piece = int(piece)
        self.counts = counts
        self.per_tile = np.maximum(-(-counts // self.piece), 1)
        self.first = np.cumsum(self.per_tile) - self.per_tile
        self.tile = np.repeat(np.arange(counts.size), self.per_tile)
        slots = np.where(self.per_tile > 1, self.per_tile, 0)
        self.slot = np.where(slots > 0, np.cumsum(slots) - slots, -1)
        self.num_slots = int(slots.sum())
        self._dev = {}

    @classmethod
    def of_core(cls, counts):
        """Pieces of the mixed-slot core's walk of ``counts`` chunks per
        tile, of :func:`core_piece_chunks` chunks."""
        counts = _host(counts)
        return cls(counts, piece=core_piece_chunks(counts))

    @classmethod
    def of_csr(cls, *counts, piece=WINGS_PIECE_CHUNKS):
        """Pieces of the walk over one or more chunk classes (the main and
        tail CSR counts, numpy or tensors, [T] or [B, T]), by default the
        tile kernel's (:data:`WINGS_PIECE_CHUNKS`)."""
        total = sum(_host(c) for c in counts if c is not None)
        return cls(total, piece=piece)

    @property
    def num_pieces(self):
        return int(self.tile.size)

    def stats(self, unit="chunks"):
        """Pieces, most units in one tile and in one piece (the records
        of chip_smoke.py), the keys named after ``unit``."""
        most = int(self.counts.max(initial=0))
        return {"pieces": self.num_pieces, f"most_{unit}_tile": most,
                f"most_{unit}_piece": min(most, self.piece)}

    def tensors(self, device):
        """(tile, first, count, slot) int32 tensors on ``device``, built
        once per device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=device)
                for a in (self.tile, self.first, self.per_tile, self.slot))
        return self._dev[key]

    def launch_args(self, batch, num_tiles, tile, device):
        """The kernels' trailing piece arguments: the piece tensors, the
        counts, a fresh scratch [B, num_slots, tile] and zeroed [B, T]
        counters.  Returns (ctypes args, tensors to keep alive)."""
        if self.counts.size != num_tiles:
            raise ValueError(f"pieces of {self.counts.size} tiles for a "
                             f"walk of {num_tiles}")
        scratch = torch.empty((batch, max(self.num_slots, 1), tile),
                              dtype=torch.float32, device=device)
        done = torch.zeros((batch, num_tiles), dtype=torch.int32,
                           device=device)
        keep = self.tensors(device) + (scratch, done)
        args = [_ptr(t) for t in keep[:4]] + [
            self.num_pieces, self.num_slots, self.piece, _ptr(scratch),
            _ptr(done)]
        return args, keep


def seg_core_piece(entries, layers=1):
    """Entries a segment core block walks for ``entries`` walked chunks a
    layer over ``layers`` layers: :data:`SEG_CORE_PIECE` from
    :data:`SEG_CORE_MANY` entries in all, else 1 (the launch passes it to
    the kernel)."""
    return SEG_CORE_PIECE if entries * layers >= SEG_CORE_MANY else 1


def core_piece_chunks(counts):
    """Chunks per piece of the mixed-slot core's walk of ``counts`` chunks
    per tile ([T] or [B, T], numpy or a tensor): 1 when the walk of one
    layer at one chunk a block fits one wave of the card
    (:data:`CORE_WAVE_BLOCKS`), where a block of 4 chunks would leave
    most SMs idle through its chunks' serial latency; else
    :data:`PIECE_CHUNKS`.  The plan decides once for every batch that
    uses it (a batch of B layers launches B times the blocks)."""
    one = TilePieces(_host(counts), piece=1)
    return 1 if one.num_pieces <= CORE_WAVE_BLOCKS else PIECE_CHUNKS


class GroupWalk:
    """The rows core's walk (the port's own plan over the copied group
    CSR): tile t walks groups ``g_start[t] .. g_start[t] + g_n[t] * chunk
    - 1`` in order, cut into :class:`TilePieces` of
    :data:`ROWS_PIECE_GROUPS` groups.  The kernel and the plain version
    both read the walk from here: the CSR (numpy, or tensors) and its
    pieces.
    """

    def __init__(self, g_start, g_n, chunk=ROWS_CHUNK):
        self.g_start = _host(g_start)
        self.g_n = _host(g_n)
        self.chunk = chunk
        self.pieces = TilePieces(self.g_n * chunk, piece=ROWS_PIECE_GROUPS)
        self._dev = {}

    @property
    def num_tiles(self):
        return int(self.g_n.size)

    def stats(self):
        """The pieces' counts in groups (the records of chip_smoke.py)."""
        return self.pieces.stats("groups")

    def tensors(self, device):
        """(g_start, g_n) int32 tensors on ``device``, built once per
        device."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=device)
                for a in (self.g_start, self.g_n))
        return self._dev[key]


class SegStreams:
    """The per-stream walk of the segment kernel (the port's own plan over
    the copied segment CSRs, which it keeps for the plain version).

    Chunk k of tile t's walk (chunk id ``tile_start[t] + k``) adds to
    stream ``t * slots + chunk_slot[id]``.  The walked chunks are listed
    by stream, walk order kept within a stream: entry e is chunk
    ``chunk[e]`` of stream ``stream[e]``, and stream s owns entries
    ``ptr[s] .. ptr[s + 1] - 1``.  The kernel sums entry e into scratch
    row e and folds each stream's rows in order.
    """

    def __init__(self, tile_start, tile_chunks, chunk_slot, slots):
        self.tile_start = _host(tile_start)
        self.tile_chunks = _host(tile_chunks)
        self.chunk_slot = _host(chunk_slot)
        self.slots = int(slots)
        count = self.tile_chunks
        tiles = np.repeat(np.arange(count.size), count)
        seq = np.arange(tiles.size) - (np.cumsum(count) - count)[tiles]
        chunk = self.tile_start[tiles] + seq
        slot = self.chunk_slot[chunk]
        if slot.size and (slot.min() < 0 or slot.max() >= slots):
            raise ValueError(f"a walked chunk's slot is outside 0..{slots-1}")
        stream = tiles * slots + slot
        order = np.argsort(stream, kind="stable")
        self.chunk = chunk[order]
        self.stream = stream[order]
        per = np.bincount(stream, minlength=count.size * slots)
        self.ptr = np.concatenate(([0], np.cumsum(per)))
        self.num_streams = count.size * slots
        self._dev = {}

    @property
    def num_tiles(self):
        return int(self.tile_chunks.size)

    @property
    def num_entries(self):
        return int(self.chunk.size)

    def stats(self, kind="core", layers=1):
        """Chunks, streams, the longest stream fold and the grid of the
        ``kind`` chunk kernel a layer over ``layers`` layers: the segment
        core's blocks of :func:`seg_core_piece` entries (the piece its
        launch passes), or the segment wings' warps, an entry a warp (the
        records of chip_smoke.py)."""
        grid = {"wings_warps": self.num_entries}
        if kind == "core":
            per_core = seg_core_piece(self.num_entries, layers)
            grid = {"core_piece": per_core,
                    "core_blocks": -(-self.num_entries // per_core)}
        return {"chunks": self.num_entries, **grid,
                "streams": self.num_streams,
                "most_chunks_stream": int(np.diff(self.ptr).max(initial=0))}

    def tensors(self, device):
        """(chunk, stream, ptr, tile_start, tile_chunks, chunk_slot) int32
        tensors on ``device``, built once per device: the kernel's stream
        walk and the plain version's CSR."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=device)
                for a in (self.chunk, self.stream, self.ptr, self.tile_start,
                          self.tile_chunks, self.chunk_slot))
        return self._dev[key]


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr()) if tensor is not None \
        else ctypes.c_void_p(0)


def _check_cuda_inputs(name, data, csr, num_tiles, rows=8):
    """Raises unless ``data`` is a contiguous float32 [B, rows, N] tensor
    and every CSR an int32 [T] or [B, T] tensor on its device, the [B, T]
    ones with one layer stride."""
    if data.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{data.dtype}")
    if data.dim() != 3 or data.shape[1] != rows or not data.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [B, {rows}, N] "
                         "tensor")
    if len({c.stride(0) for c in csr if c is not None and c.dim() == 2}) > 1:
        raise ValueError(f"{name}: [B, T] CSRs must share one layer stride")
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


def _check_vector_rows(name, data):
    """Raises unless ``data``'s rows start on 16-byte boundaries (the
    kernels' float4 loads and 16-byte copies)."""
    if data.data_ptr() % 16 or any(s % 4 for s in data.stride()[:-1]):
        raise ValueError(f"{name}: the CUDA kernel takes 16-byte aligned "
                         "rows")


def _as_batch(data):
    """([1, 8, N] view, True) for a single layer [8, N]; (data, False) for
    a layer batch [B, 8, N]."""
    if data.dim() == 2:
        return data[None], True
    return data, False


def _unbatch(out, single):
    return out[0] if single else out


def _refuse_device(name, data):
    if not data.is_cuda:
        raise ValueError(f"no {name} kernel for device {data.device}")


# --------------------------------------------------------------------------
# Tile kernel: strided wings (K1/K3), splat and scalar-line passes (K4, K5,
# K7).
# --------------------------------------------------------------------------

def _launch_wings(soa, w_start, w_n, t_start, t_n, num_tiles, tile,
                  stride, chunk, tail, line_fn, pieces=None):
    _check_cuda_inputs("wings", soa, [w_start, w_n, t_start, t_n],
                       num_tiles)
    if tile not in (256, 512, 1024) or chunk > MAX_CHUNK \
            or tail > MAX_CHUNK or chunk <= 0 or tail <= 0:
        raise ValueError("wings kernel takes tile 256/512/1024 and chunk, "
                         f"tail <= {MAX_CHUNK}")
    batch = soa.shape[0]
    csr_bstride = w_start.stride(0) if w_start.dim() == 2 else 0
    if pieces is None:
        pieces = TilePieces.of_csr(w_n, t_n)
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=soa.device)
    piece_args, _keep = pieces.launch_args(batch, num_tiles, tile,
                                           soa.device)
    err = cuda_library().pylbl_wings(
        _ptr(soa), soa.stride(0), soa.stride(1),
        _ptr(w_start), _ptr(w_n), _ptr(t_start), _ptr(t_n), csr_bstride,
        _ptr(out), batch, num_tiles, tile, stride, chunk,
        tail if t_start is not None else 0, line_fn, *piece_args,
        _stream_ptr(soa.device))
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


def _line_corrections(x, y, pref):
    """pref * (K_class - K_lorentz) with the class picked from each line's
    own y (``_correction_line``); lines with y >= 70.55 give 0, a NaN y
    takes the whole correction (0, so pref * 0).  x [..., n], y and pref
    [..., 1]."""
    flat_x = x.reshape(-1, x.shape[-1])
    flat_y = y.reshape(-1, 1)
    flat_p = pref.reshape(-1, 1)
    val = torch.zeros_like(flat_x)
    for cls, corr_fn in _classes_of(flat_y[:, 0]):
        idx = torch.nonzero(cls).flatten()
        if idx.numel():
            val[idx] = flat_p[idx] * corr_fn(flat_x[idx], flat_y[idx])
    return val.reshape(x.shape)


def _tile_partials_plain(soa, tiles, line0, width, tile, stride, line,
                         max_elems=1 << 23):
    """[B, P, tile] per-chunk partial sums: for each (tile, chunk) pair,
    the chunk's ``width`` lines summed in line order (the first level of
    the two-level summation), in slabs of pairs.  ``line``: "pre"
    (prepacked Lorentzian), "raw" (Lorentzian from raw rows), "own" (raw,
    with the strength zeroed unless the line's _PAD row equals the tile
    index) or "corr" (per-line Humlicek correction).

    The three Lorentzian kinds take the Lorentzian walk's term, the
    reciprocal of ``x^2 + y^2`` and then the product; "raw" and "own" form
    ``pref * y / sqrt(pi)`` and ``y^2`` from the raw rows first, in the
    kernel's float32 order.  Every line of the chunk is summed here; the
    kernel leaves out lines whose terms are all +0.0 at a point (a window
    that misses it), for "own" the foreign lines whose terms are all
    +/-0.0 (``own_drops`` in csrc/lineshape.cu), and for "corr" every
    point that needs no correction (``pair_item``'s need window, +/-0.0
    for a finite prefactor), which changes no bit of a sum that starts at
    +0.0."""
    batch = soa.shape[0]
    dtype = soa.dtype
    pairs = tiles.numel()
    out = soa.new_zeros((batch, pairs, tile))
    offs = torch.arange(tile, device=soa.device)
    slab = max(1, max_elems // max(batch * tile, 1))
    for lo in range(0, pairs, slab):
        hi = min(lo + slab, pairs)
        point = (tiles[lo:hi, None] * stride + offs[None, :]).to(dtype)
        tile_f = tiles[lo:hi, None].to(dtype)
        part = soa.new_zeros((batch, hi - lo, tile))
        for j in range(width):
            vals = soa[:, :, line0[lo:hi] + j, None]     # [B, 8, P, 1]
            x = ((point - vals[:, C_INT]) - vals[:, C_FRAC]) * vals[:, SRW]
            y, pref = vals[:, Y], vals[:, PREF]
            if line == "own":
                pref = torch.where(vals[:, _PAD] == tile_f, pref,
                                   torch.zeros_like(pref))
            if line == "corr":
                val = _line_corrections(x, y, pref)
            elif line in ("raw", "own"):
                # The walk's term: the reciprocal, then the product.
                val = ((pref * y) * RSQRPI) * (1.0 / (x * x + y * y))
            else:
                val = pref * (1.0 / (x * x + y))
            mask = (point >= vals[:, S_IDX]) & (point <= vals[:, E_IDX])
            part = part + torch.where(mask, val, torch.zeros_like(val))
        out[:, lo:hi] = part
    return out


def _fold_in_order(parts, targets, seq, shape):
    """acc[target] = ((0 + parts[seq 0]) + parts[seq 1]) + ... per target,
    in seq order (the second level of the two-level summation).  Each seq
    value names at most one part per target, so every step is a plain
    indexed add without collisions."""
    acc = parts.new_zeros(shape)
    if seq.numel() == 0:
        return acc
    for j in range(int(seq.max()) + 1):
        sel = torch.nonzero(seq == j).flatten()
        t = targets[sel]
        acc[:, t] = acc[:, t] + parts[:, sel]
    return acc


def _fold_pieces(parts, tiles, seq, shape, piece=PIECE_CHUNKS):
    """The split kernels' three-level order: each piece of ``piece``
    chunks of a tile's walk sums its chunk partials in walk order, and the
    tile is ((0 + piece 0) + piece 1) + ...  ``parts`` [B, M, ...] are the
    chunk partials, ``tiles``/``seq`` each chunk's tile and place in its
    tile's walk.  A tile of one piece comes out as that piece's sum (0 + P
    is P: a sum that starts at +0.0 is never -0.0)."""
    if seq.numel() == 0:
        return parts.new_zeros(shape)
    of = seq // piece
    span = int(of.max()) + 1
    keys, of_piece = torch.unique(tiles * span + of, return_inverse=True)
    sums = _fold_in_order(parts, of_piece, seq % piece,
                          (shape[0], keys.numel()) + tuple(shape[2:]))
    return _fold_in_order(sums, keys // span, keys % span, shape)


def wings_tiles_plain(soa, w_start, w_n, num_tiles, tile, stride, chunk,
                      t_start=None, t_n=None, tail=128, line="pre",
                      piece=WINGS_PIECE_CHUNKS):
    """Plain version of the tile kernel: [B, 8, N] SoA and a per-tile
    chunk CSR ([T], shared by every layer) -> [B, T, tile] tile sums;
    point = t * stride + offset, main chunks then tail chunks, folded in
    the kernel's pieces of ``piece`` chunks (:func:`_fold_pieces`)."""
    device = soa.device
    zero = torch.zeros(num_tiles, dtype=torch.int64, device=device)
    tiles, line0, seq = _chunk_pairs(w_start, w_n, chunk, zero, device)
    parts = _tile_partials_plain(soa, tiles, line0, chunk, tile, stride,
                                 line)
    if t_start is not None:
        tt, tl, ts = _chunk_pairs(t_start, t_n, tail,
                                  w_n.to(torch.int64), device)
        tparts = _tile_partials_plain(soa, tt, tl, tail, tile, stride, line)
        tiles = torch.cat([tiles, tt])
        seq = torch.cat([seq, ts])
        parts = torch.cat([parts, tparts], dim=1)
    return _fold_pieces(parts, tiles, seq, (soa.shape[0], num_tiles, tile),
                        piece)


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


def _tile_plain(soa, w_start, w_n, num_points, tile, stride, chunk,
                t_start, t_n, tail, line, piece=WINGS_PIECE_CHUNKS):
    """The tile kernel's plain version over [T] CSRs or [B, T] ones
    (numpy or torch); layers whose [B, T] rows differ run one by one, each
    with its own row, as the kernel's blocks do; ``piece``: the kernel's
    chunks per piece."""
    soa, single = _as_batch(soa)
    num_tiles = (num_points - 1) // stride + 1
    csr = [None if c is None else torch.as_tensor(c, device=soa.device)
           for c in (w_start, w_n, t_start, t_n)]
    per_layer = any(c is not None and c.dim() == 2
                    and not bool((c == c[:1]).all()) for c in csr)
    outs = []
    for b in range(soa.shape[0]) if per_layer else [None]:
        rows = [None if c is None else c if c.dim() == 1
                else c[0 if b is None else b] for c in csr]
        block = soa if b is None else soa[b:b + 1]
        tiles = wings_tiles_plain(block, rows[0], rows[1], num_tiles, tile,
                                  stride, chunk, rows[2], rows[3], tail,
                                  line, piece)
        outs.append(strided_combine(tiles, num_points, tile, stride))
    return _unbatch(torch.cat(outs), single)


def _tile(soa, w_start, w_n, num_points, tile, stride, chunk, t_start,
          t_n, tail, line, line_fn, counter, pieces=None):
    if soa.device.type == "cpu":
        return _tile_plain(soa, w_start, w_n, num_points, tile, stride,
                           chunk, t_start, t_n, tail, line)
    _refuse_device("wings", soa)
    soa, single = _as_batch(soa)
    num_tiles = (num_points - 1) // stride + 1
    tiles = _launch_wings(soa, w_start, w_n, t_start, t_n, num_tiles, tile,
                          stride, chunk, tail, line_fn, pieces)
    LAUNCHES[counter] += 1
    return _unbatch(strided_combine(tiles, num_points, tile, stride), single)


def _strided_counter(soa, t_start):
    if soa.dim() == 3:
        return "wings_strided"
    return "wings_strided_single" if t_start is None \
        else "wings_strided_tail_single"


def wings_strided_pass(soa, w_start, w_n, num_points, tile, stride,
                       chunk=STRIDED_CHUNK, t_start=None, t_n=None,
                       tail=128, pieces=None):
    """Strided overlapped-tile prepacked wings -> [B, num_points] (or
    [num_points] for a single layer [8, N]).

    ``soa`` carries y^2 in the Y row and pref*y/sqrt(pi) in the PREF row;
    ``w_start``/``w_n`` (and optionally the tail class ``t_start``/``t_n``)
    are [T] int32 CSRs over the private per-tile chunks of
    :func:`padded_strided_layout_tail`.  ``pieces``: the walk's
    :class:`TilePieces`, built once by a plan (from the CSR counts when
    None, which reads them back from the card)."""
    if t_start is not None and tail % 128 != 0:
        raise ValueError("tail width must be a multiple of 128")
    return _tile(soa, w_start, w_n, num_points, tile, stride, chunk,
                 t_start, t_n, tail, "pre", 0,
                 _strided_counter(soa, t_start), pieces)


def wings_strided_plain(soa, w_start, w_n, num_points, tile, stride,
                        chunk=STRIDED_CHUNK, t_start=None, t_n=None,
                        tail=128, piece=WINGS_PIECE_CHUNKS):
    """:func:`wings_strided_pass` through the plain version on any device
    and float dtype (``piece``: the pieces' chunks, as the kernel's
    :class:`TilePieces`)."""
    return _tile_plain(soa, w_start, w_n, num_points, tile, stride, chunk,
                       t_start, t_n, tail, "pre", piece)


def wings_strided_checked_pass(soa, start, nchunks, num_points, tile, stride,
                               chunk=STRIDED_CHUNK, pieces=None):
    """Ownership-checked strided wings (``_pallas_pass_strided`` with
    ``prepacked=False``) -> [B, num_points] or [num_points].

    ``soa`` carries the raw rows (Y = y, PREF = pref) and, in its _PAD
    row, each line's assigned tile as float32 (-1 for pad lines);
    ``start``/``nchunks`` are the straddle CSR of
    :func:`strided_line_ranges` ([T], shared by every layer), so
    neighbouring tiles read shared chunks and each tile zeroes the
    strength of the lines it does not own.  The kernel is the Lorentzian
    walk (OWN): it leaves out a foreign line before its ballot where every
    term of it is +/-0.0 (``y^2`` finite and normal, ``x`` never NaN), and
    keeps any other foreign line at strength 0, so that it gives the plain
    version's NaN (``y = 0`` at ``x = 0``, a non-finite ``y``).
    ``pieces`` as :func:`wings_strided_pass`."""
    counter = "wings_strided_checked" if soa.dim() == 3 \
        else "wings_strided_checked_single"
    return _tile(soa, start, nchunks, num_points, tile, stride, chunk, None,
                 None, 128, "own", _LINE_OWN, counter, pieces)


def wings_strided_checked_plain(soa, start, nchunks, num_points, tile,
                                stride, chunk=STRIDED_CHUNK,
                                piece=WINGS_PIECE_CHUNKS):
    """:func:`wings_strided_checked_pass` through the plain version on any
    device and float dtype (``piece`` as :func:`wings_strided_plain`)."""
    return _tile_plain(soa, start, nchunks, num_points, tile, stride, chunk,
                       None, None, 128, "own", piece)


_PLAIN_LINES = {"wings_pre": "pre", "wings": "raw", "core": "corr"}


def tile_pass(soa, start, nchunks, num_points, tile, chunk=DEFAULT_CHUNK,
              pass_kind="wings_pre", pieces=None):
    """Tile pass at stride = tile (``_pallas_pass(_batched)``) ->
    [B, num_points] or [num_points]: tile t sums its CSR line range
    (:func:`tile_line_ranges`) over points t*tile + offset, window-masked.

    ``pass_kind``: "wings_pre" (prepacked Lorentzian, ``_lorentz_line_pre``),
    "wings" (Lorentzian from raw rows, ``_lorentz_line``) or "core" (the
    per-line Humlicek correction, ``_correction_line``).  The two
    Lorentzians take the Lorentzian walk (PRE, RAW: the raw kind forms
    each line's ``y^2`` and ``pref*y/sqrt(pi)`` first, and both take the
    term ``pref_y * rcp(x^2 + y^2)``); the correction the unit walk,
    which evaluates only the points that need a correction, by Humlicek
    region, and sums in the plain version's order.  The CSR is [T] or
    [B, T]; ``pieces`` as :func:`wings_strided_pass`."""
    line_fn, counter = _TILE_LINES[pass_kind]
    return _tile(soa, start, nchunks, num_points, tile, tile, chunk, None,
                 None, 128, _PLAIN_LINES[pass_kind], line_fn, counter,
                 pieces)


def tile_plain(soa, start, nchunks, num_points, tile, chunk=DEFAULT_CHUNK,
               pass_kind="wings_pre", piece=WINGS_PIECE_CHUNKS):
    """:func:`tile_pass` through the plain version on any device and float
    dtype (``piece`` as :func:`wings_strided_plain`)."""
    return _tile_plain(soa, start, nchunks, num_points, tile, tile, chunk,
                       None, None, 128, _PLAIN_LINES[pass_kind], piece)


# --------------------------------------------------------------------------
# Segment-32 passes: mixed-slot core (K2, K5) and per-stream core or wings
# (K8).
# --------------------------------------------------------------------------

def _chunk_refs(tile_start, tile_chunks, num_tiles, device):
    """(tile, seq within the tile, chunk id) of every chunk a tile walks,
    in tile-major order."""
    count = tile_chunks.to(torch.int64)
    chunk_tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=device), count)
    chunk_seq = torch.arange(chunk_tile.numel(), device=device) \
        - (torch.cumsum(count, 0) - count)[chunk_tile]
    chunk_id = tile_start.to(torch.int64)[chunk_tile] + chunk_seq
    return chunk_tile, chunk_seq, chunk_id


def _warp_sums(val, chunk):
    """[M, chunk, ...] per-instance values -> [M, chunk // 32, ...]: warp
    w's 32 instances added in order from 0."""
    val = val.reshape((val.shape[0], chunk // 32, 32) + val.shape[2:])
    part = torch.zeros_like(val[:, :, 0])
    for j in range(32):
        part = part + val[:, :, j]
    return part


def _in_warp_order(part):
    """((p0 + p1) + p2) + p3 over the warp axis 1."""
    total = part[:, 0]
    for w in range(1, part.shape[1]):
        total = total + part[:, w]
    return total


def _core_values(row, offs, corr_fn):
    """pref * (K_class - K_lorentz) at seg0-relative offsets, window-masked
    (``_seg_chunk_accumulate``): rows [M, chunk, 1] -> [M, chunk, seg]."""
    x = ((row[SR_SEG0REL] + offs) - row[SR_CFRAC]) * row[SR_SRW]
    val = corr_fn(x, row[SR_Y])
    mask = (offs >= row[SR_SREL]) & (offs <= row[SR_EREL])
    return torch.where(mask, row[SR_PREF] * val, torch.zeros_like(val))


def _classes_of(y):
    """(mask over y, correction) per Humlicek class, picked by y as the
    JAX conds pick it: y >= 70.55 is in none, and a NaN y fails every
    test and takes the last class, the whole correction."""
    taken = y >= _CORE_SKIP_Y
    last = len(_CORE_CLASSES) - 1
    for k, (threshold, corr_fn) in enumerate(_CORE_CLASSES):
        cls = ~taken if k == last else (~taken) & (y >= threshold)
        taken = taken | cls
        yield cls, corr_fn


def _class_chunks(blocks):
    """:func:`_classes_of` over [B, C] chunks by the chunk's min y (a NaN
    y: amin keeps it, and the chunk takes the whole correction)."""
    return _classes_of(blocks[:, :, SR_Y].amin(dim=-1))


def _launch_core(params, tile_start, tile_chunks, num_tiles, tile, chunk,
                 seg, pieces=None):
    _check_cuda_inputs("core", params, [tile_start, tile_chunks], num_tiles)
    if chunk != 128 or seg != 32 or tile % 128 or not 128 <= tile <= 1024 \
            or params.shape[2] % chunk:
        raise ValueError("core kernel takes chunk 128, seg 32, a tile of "
                         "128..1024 points and whole chunks of instances")
    batch = params.shape[0]
    if pieces is None:
        pieces = TilePieces.of_core(tile_chunks)
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=params.device)
    piece_args, _keep = pieces.launch_args(batch, num_tiles, tile,
                                           params.device)
    err = cuda_library().pylbl_core_segmix(
        _ptr(params), params.stride(0), params.stride(1),
        _ptr(tile_start), _ptr(tile_chunks), _ptr(out), batch, num_tiles,
        tile, chunk, seg, *piece_args, _stream_ptr(params.device))
    _check_launch("core", err)
    return out


def core_tiles_plain(params, tile_start, tile_chunks, num_tiles, tile,
                     chunk=ROWS_CHUNK, seg=SEG, max_elems=1 << 22,
                     piece=None):
    """Plain version of the mixed-slot core kernel: [B, 8, I] params ->
    [B, T, tile].

    Per (layer, chunk): class from the chunk's min y (skip at >= 70.55),
    ``pref * (K_class - K_lorentz)`` on the [instance, offset] block,
    window-masked; warp w (instances 32w..32w+31) adds its instances in
    order into a private [slot, offset] partial through a one-hot slot
    select; the chunk sum is ((p0 + p1) + p2) + p3; tiles fold their
    chunks in the kernel's pieces of ``piece`` chunks (by default
    :func:`core_piece_chunks`'s, as the kernel's) (:func:`_fold_pieces`)."""
    if piece is None:
        piece = core_piece_chunks(tile_chunks)
    device = params.device
    dtype = params.dtype
    batch = params.shape[0]
    slots = tile // seg
    warps = chunk // 32
    chunk_tile, chunk_seq, chunk_id = _chunk_refs(tile_start, tile_chunks,
                                                  num_tiles, device)
    blocks = params.reshape(batch, SEGP_ROWS, -1, chunk)
    blocks = blocks.index_select(2, chunk_id).permute(0, 2, 1, 3)
    sums = params.new_zeros((batch, chunk_id.numel(), slots, seg))
    offs = torch.arange(seg, device=device).to(dtype)
    onehot_slots = torch.arange(slots, device=device).to(dtype)
    per = max(1, max_elems // (chunk * seg))
    for cls, corr_fn in _class_chunks(blocks):
        idx = torch.nonzero(cls)                            # [M, 2]
        for lo in range(0, idx.shape[0], per):
            sel = idx[lo:lo + per]
            blk = blocks[sel[:, 0], sel[:, 1]]              # [M, 8, chunk]
            row = {r: blk[:, r, :, None] for r in range(SEGP_ROWS)}
            val = _core_values(row, offs, corr_fn)          # [M, chunk, seg]
            val = val.reshape(-1, warps, 32, seg)
            slot = blk[:, SR_SLOT].reshape(-1, warps, 32)
            part = val.new_zeros((val.shape[0], warps, slots, seg))
            for j in range(32):
                onehot = (slot[:, :, j, None] == onehot_slots).to(dtype)
                part = part + onehot[..., None] * val[:, :, j, None, :]
            sums[sel[:, 0], sel[:, 1]] = _in_warp_order(part)
    acc = _fold_pieces(sums, chunk_tile, chunk_seq,
                       (batch, num_tiles, slots, seg), piece)
    return acc.reshape(batch, num_tiles, tile)


def _core_out(tiles, num_points):
    batch, num_tiles, tile = tiles.shape
    return tiles.reshape(batch, num_tiles * tile)[:, :num_points]


def core_segmix_pass(params, tile_start, tile_chunks, num_points, tile,
                     chunk=ROWS_CHUNK, seg=SEG, pieces=None):
    """Mixed-slot core pass -> [B, num_points] or [num_points] (point =
    t*tile + seg*slot + offset).  ``params`` [B, 8, I] or [8, I] from
    :meth:`CorePlan.seg_params` / :meth:`CorePlan.gather`; ``pieces`` as
    :func:`wings_strided_pass` (by default :meth:`TilePieces.of_core`)."""
    if params.device.type == "cpu":
        return core_segmix_plain(params, tile_start, tile_chunks, num_points,
                                 tile, chunk, seg,
                                 None if pieces is None else pieces.piece)
    _refuse_device("core", params)
    p, single = _as_batch(params)
    tiles = _launch_core(p, tile_start, tile_chunks,
                         -(-num_points // tile), tile, chunk, seg, pieces)
    LAUNCHES["core_segmix_single" if single else "core_segmix"] += 1
    return _unbatch(_core_out(tiles, num_points), single)


def core_segmix_plain(params, tile_start, tile_chunks, num_points, tile,
                      chunk=ROWS_CHUNK, seg=SEG, piece=None):
    """:func:`core_segmix_pass` through the plain version on any device
    and float dtype (``piece``: the kernel's chunks per piece, by default
    :func:`core_piece_chunks`'s)."""
    p, single = _as_batch(params)
    num_tiles = -(-num_points // tile)
    return _unbatch(_core_out(core_tiles_plain(p, tile_start, tile_chunks,
                                               num_tiles, tile, chunk, seg,
                                               piece=piece),
                              num_points), single)


def _launch_seg(params, streams, num_tiles, tile, chunk, seg, kind):
    _check_cuda_inputs("seg", params, [], num_tiles)
    if chunk != 128 or seg != 32 or tile % 32 or not 32 <= tile <= 1024 \
            or params.shape[2] % chunk:
        raise ValueError("segment kernel takes chunk 128, seg 32, a tile of "
                         "32..1024 points and whole chunks of instances")
    _check_vector_rows("seg", params)
    if streams.num_tiles != num_tiles or streams.slots != tile // seg or (
            streams.num_entries
            and int(streams.chunk.max()) >= params.shape[2] // chunk):
        raise ValueError("seg: the stream walk does not fit the tiles or "
                         "the parameter block")
    batch = params.shape[0]
    sums = torch.empty((batch, max(streams.num_entries, 1), seg),
                       dtype=torch.float32, device=params.device)
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=params.device)
    ent_chunk, ent_stream, ptr = streams.tensors(params.device)[:3]
    err = cuda_library().pylbl_seg(
        _ptr(params), params.stride(0), params.stride(1), _ptr(ent_chunk),
        _ptr(ent_stream), streams.num_entries, _ptr(ptr), _ptr(sums),
        _ptr(out), batch, num_tiles, tile, chunk, seg, _SEG_KINDS[kind],
        _stream_ptr(params.device),
        seg_core_piece(streams.num_entries, batch))
    _check_launch("seg", err)
    return out


def seg_tiles_plain(params, tile_start, tile_chunks, chunk_slot, num_tiles,
                    tile, chunk=ROWS_CHUNK, seg=SEG, kind="core",
                    max_elems=1 << 22):
    """Plain version of the segment kernel: [B, 8, I] params -> [B, T,
    tile].

    Per (layer, chunk), on the chunk's one segment slot: "core" picks the
    class from the chunk's min y (skip at >= 70.55) and evaluates
    ``pref * (K_class - K_lorentz)`` at seg0-relative offsets; "wings"
    evaluates the Lorentzian of the raw rows at the absolute points
    t*tile + seg*slot + offset.  Warp w (instances 32w..32w+31) adds its
    instances in order, the chunk sum is ((w0 + w1) + w2) + w3, and each
    (tile, slot) folds its chunks in order."""
    device = params.device
    dtype = params.dtype
    batch = params.shape[0]
    slots = tile // seg
    chunk_tile, chunk_seq, chunk_id = _chunk_refs(tile_start, tile_chunks,
                                                  num_tiles, device)
    slot = torch.as_tensor(chunk_slot, device=device).to(
        torch.int64)[chunk_id]
    blocks = params.reshape(batch, SEGP_ROWS, -1, chunk)
    blocks = blocks.index_select(2, chunk_id).permute(0, 2, 1, 3)
    sums = params.new_zeros((batch, chunk_id.numel(), seg))
    offs = torch.arange(seg, device=device).to(dtype)
    if kind == "core":
        classes = _class_chunks(blocks)
    else:
        every = torch.ones(blocks.shape[:2], dtype=torch.bool, device=device)
        classes = [(every, None)]
    per = max(1, max_elems // (chunk * seg))
    for cls, corr_fn in classes:
        idx = torch.nonzero(cls)                            # [M, 2]
        for lo in range(0, idx.shape[0], per):
            sel = idx[lo:lo + per]
            blk = blocks[sel[:, 0], sel[:, 1]]              # [M, 8, chunk]
            row = {r: blk[:, r, :, None] for r in range(SEGP_ROWS)}
            if kind == "core":
                val = _core_values(row, offs, corr_fn)
            else:
                c = sel[:, 1]
                point = ((chunk_tile[c] * tile + seg * slot[c]).to(dtype)
                         [:, None, None] + offs)            # [M, 1, seg]
                y = row[Y]
                pref_y = (row[PREF] * y) * RSQRPI
                x = ((point - row[C_INT]) - row[C_FRAC]) * row[SRW]
                val = pref_y / (x * x + y * y)
                mask = (point >= row[S_IDX]) & (point <= row[E_IDX])
                val = torch.where(mask, val, torch.zeros_like(val))
            sums[sel[:, 0], sel[:, 1]] = _in_warp_order(
                _warp_sums(val, chunk))
    acc = _fold_in_order(sums, chunk_tile * slots + slot, chunk_seq,
                         (batch, num_tiles * slots, seg))
    return acc.reshape(batch, num_tiles, tile)


def seg_pass(params, streams, num_points, tile, chunk=ROWS_CHUNK, seg=SEG,
             kind="core"):
    """Per-stream segment pass (``_pallas_seg_pass``) -> [B, num_points]
    or [num_points], natural point order, over the plan's
    :class:`SegStreams` (which keeps its chunk CSR for the plain version).
    ``kind``: "core" (params from :meth:`CorePlan.gather` /
    :meth:`CorePlan.seg_params`) or "wings" (params from
    :meth:`CorePlan.wings_params`)."""
    if kind not in _SEG_KINDS:
        raise ValueError(f"unknown segment pass kind {kind!r}")
    if params.device.type == "cpu":
        return seg_plain(params, *streams.tensors(params.device)[3:],
                         num_points, tile, chunk, seg, kind)
    _refuse_device("segment", params)
    p, single = _as_batch(params)
    tiles = _launch_seg(p, streams, -(-num_points // tile), tile, chunk, seg,
                        kind)
    LAUNCHES["seg_" + kind] += 1
    return _unbatch(_core_out(tiles, num_points), single)


def seg_plain(params, tile_start, tile_chunks, chunk_slot, num_points, tile,
              chunk=ROWS_CHUNK, seg=SEG, kind="core"):
    """:func:`seg_pass` through the plain version on any device and float
    dtype."""
    p, single = _as_batch(params)
    num_tiles = -(-num_points // tile)
    return _unbatch(_core_out(seg_tiles_plain(p, tile_start, tile_chunks,
                                              chunk_slot, num_tiles, tile,
                                              chunk, seg, kind),
                              num_points), single)


# --------------------------------------------------------------------------
# Rows core (K9): 8 instances per group, one per row of the tile.
# --------------------------------------------------------------------------

def _launch_rows(groups, walk, num_tiles, tile, ymin=None):
    _check_cuda_inputs("rows", groups, [], num_tiles, rows=GROUP_ROWS)
    if walk.chunk != ROWS_CHUNK or tile not in (256, 512, 1024) \
            or groups.shape[2] % walk.chunk:
        raise ValueError("rows kernel takes chunk 128, tile 256/512/1024 "
                         "and whole chunks of groups")
    end = walk.g_start + walk.g_n * walk.chunk
    if walk.num_tiles != num_tiles or (walk.g_start % 4).any() \
            or int(end.max(initial=0)) > groups.shape[2]:
        raise ValueError("rows: the group walk does not fit the tiles or "
                         "the group block, or a tile's walk does not start "
                         "on a multiple of 4 groups")
    batch = groups.shape[0]
    if ymin is not None and (
            ymin.dtype != torch.float32 or ymin.device != groups.device
            or tuple(ymin.shape) != (batch, 1, groups.shape[2])
            or ymin.stride(-1) != 1):
        raise ValueError("rows: the min-y block must be a float32 [B, 1, G] "
                         "tensor with unit stride along G on the groups' "
                         "device")
    _check_vector_rows("rows", groups)
    if ymin is not None:
        _check_vector_rows("rows min-y block", ymin)
    out = torch.empty((batch, num_tiles, tile), dtype=torch.float32,
                      device=groups.device)
    g_start, g_n = walk.tensors(groups.device)
    piece_args, _keep = walk.pieces.launch_args(batch, num_tiles, tile,
                                                groups.device)
    err = cuda_library().pylbl_rows(
        _ptr(groups), groups.stride(0), groups.stride(1), _ptr(ymin),
        0 if ymin is None else ymin.stride(0), _ptr(g_start), _ptr(g_n),
        _ptr(out), batch, num_tiles, tile, walk.chunk, *piece_args,
        _stream_ptr(groups.device))
    _check_launch("rows", err)
    return out


def rows_tiles_plain(groups, g_start, g_n, num_tiles, tile,
                     chunk=ROWS_CHUNK, ymin=None, max_elems=1 << 24,
                     piece=ROWS_PIECE_GROUPS):
    """Plain version of the rows kernel: [B, 64, G] groups -> [B, T, tile].

    Tile t walks its groups g_start[t] .. g_start[t] + g_n[t]*chunk - 1 in
    order; point p = r * (tile/8) + c of the tile sits in row r, and a
    group's instance r applies to row r only.  A group whose min y (row
    56, or ``ymin`` [B, 1, G]) is >= 70.55 is skipped; otherwise its class
    (k1, k12, k123 or the full form, a NaN min y the full form) is picked
    from that min y and
    ``pref * (K_class - K_lorentz)``, window-masked, is added to a running
    sum per point and piece of ``piece`` groups of the walk, from +0.0 in
    group order, and the tile is ((0 + piece 0) + piece 1) + ...  (the
    JAX kernels keep one running sum through the whole walk).  Groups are
    evaluated in slabs; a skipped or absent group adds +0.0, which leaves
    the (never negative-zero) sums unchanged."""
    device = groups.device
    dtype = groups.dtype
    batch = groups.shape[0]
    row_w = tile // 8
    start = torch.as_tensor(g_start, device=device).to(torch.int64)
    count = torch.as_tensor(g_n, device=device).to(torch.int64) * chunk
    ymin_rows = (groups[:, YMIN_ROW] if ymin is None else ymin[:, 0])
    point = (torch.arange(num_tiles, device=device)[:, None] * tile
             + torch.arange(tile, device=device)).to(dtype).reshape(
                 num_tiles, 8, row_w)
    acc = groups.new_zeros((batch, num_tiles, 8, row_w))
    part = torch.zeros_like(acc)
    gmax = int(count.max()) if count.numel() else 0
    per = max(1, max_elems // max(batch * num_tiles * tile, 1))
    for lo in range(0, gmax, per):
        gs = torch.arange(lo, min(lo + per, gmax), device=device)
        live = gs[None, :] < count[:, None]                  # [T, S]
        col = torch.where(live, start[:, None] + gs[None, :], 0)
        blk = groups[:, :YMIN_ROW][:, :, col].permute(0, 2, 3, 1)
        ym = torch.where(live, ymin_rows[:, col], _CORE_SKIP_Y)  # [B, T, S]
        vals = groups.new_zeros((batch, num_tiles, gs.numel(), 8, row_w))
        for cls, corr_fn in _classes_of(ym):
            idx = torch.nonzero(cls)                         # [M, 3]
            if not idx.numel():
                continue
            fld = blk[idx[:, 0], idx[:, 1], idx[:, 2]].reshape(
                -1, N_FIELDS, 8, 1)
            c_int, c_frac, srw, y, pref, s, e = fld.unbind(1)
            pt = point[idx[:, 1]]                            # [M, 8, row_w]
            x = ((pt - c_int) - c_frac) * srw
            val = pref * corr_fn(x, y)
            mask = (pt >= s) & (pt <= e)
            vals[idx[:, 0], idx[:, 1], idx[:, 2]] = torch.where(
                mask, val, torch.zeros_like(val))
        for j in range(gs.numel()):
            if (lo + j) % piece == 0 and lo + j:
                acc = acc + part
                part = torch.zeros_like(acc)
            part = part + vals[:, :, j]
    return (acc + part).reshape(batch, num_tiles, tile)


def _rows_walk_plain(groups, walk, num_points, tile, ymin=None):
    """The plain version over a :class:`GroupWalk`."""
    return rows_plain(groups, *walk.tensors(groups.device), num_points, tile,
                      walk.chunk, ymin)


def rows_pass(groups, walk, num_points, tile):
    """Rows core pass (``_pallas_rows_pass``) -> [B, num_points] or
    [num_points] (point = t*tile + r*(tile/8) + c): ``groups`` [B, 64, G]
    or [64, G] from :meth:`CorePlan.gather` / :meth:`CorePlan.group_params`
    and the plan's :class:`GroupWalk` over the [T] group CSR of
    :func:`build_core_groups`."""
    if groups.device.type == "cpu":
        return _rows_walk_plain(groups, walk, num_points, tile)
    _refuse_device("rows", groups)
    g, single = _as_batch(groups)
    tiles = _launch_rows(g, walk, -(-num_points // tile), tile)
    LAUNCHES["core_rows_single" if single else "core_rows"] += 1
    return _unbatch(_core_out(tiles, num_points), single)


def rows_plain(groups, g_start, g_n, num_points, tile, chunk=ROWS_CHUNK,
               ymin=None, piece=ROWS_PIECE_GROUPS):
    """:func:`rows_pass` (with ``ymin``: :func:`rows_vmem_pass`) through
    the plain version on any device and float dtype."""
    g, single = _as_batch(groups)
    y = None if ymin is None else _as_batch(ymin)[0]
    return _unbatch(_core_out(rows_tiles_plain(
        g, g_start, g_n, -(-num_points // tile), tile, chunk, y,
        piece=piece), num_points), single)


def rows_vmem_pass(groups, ymin, walk, num_points, tile):
    """The rows core with the class read from a separate [.., 1, G] min-y
    block (:func:`group_min_y`; ``_pallas_rows_pass_vmem``), the same
    kernel staging that block instead of row 56."""
    if groups.device.type == "cpu":
        return _rows_walk_plain(groups, walk, num_points, tile, ymin)
    _refuse_device("rows", groups)
    g, single = _as_batch(groups)
    y = _as_batch(ymin)[0]
    tiles = _launch_rows(g, walk, -(-num_points // tile), tile, y)
    LAUNCHES["core_rows_vmem"] += 1
    return _unbatch(_core_out(tiles, num_points), single)


# --------------------------------------------------------------------------
# Single-layer device plan (lineshape_pallas.py:2588-2735).
# --------------------------------------------------------------------------

class DevicePlan:
    """Device-resident plan for one (line set, grid, layer): the SoA line
    block (or a seg wings plan's parameter block), the wings CSR and the
    core parameters live on ``device``; ``plan()`` runs the wings pass and
    the core pass with no host transfer.

    The wings pass is the strided prepacked pass when ``wings_stride`` is
    set, the segment-32 wings pass when ``wings_plan`` is, and the raw
    Lorentz splat otherwise; the core pass is ``core_plan``'s.
    ``plain``: run the plain versions instead of the wrappers.
    """

    def __init__(self, soa, w_start, w_n, core_plan, core_params,
                 num_points, tile, chunk, wings_plan=None, wings_stride=None,
                 device="cuda", plain=False):
        device = resolve_device(device)
        self.soa = torch.as_tensor(soa, device=device)
        self.w_start = torch.as_tensor(w_start, device=device)
        self.w_n = torch.as_tensor(w_n, device=device)
        self.wings_pieces = TilePieces.of_csr(w_n)
        self.core = core_plan
        self.wings = wings_plan
        self.wings_stride = wings_stride
        self.groups = torch.as_tensor(core_params, device=device)
        self.num_points = int(num_points)
        self.tile = tile
        self.chunk = chunk
        self.plain = plain

    def __call__(self):
        return self.run_with(self.soa, self.groups)

    def wings_pass(self, soa=None, plain=None):
        soa = self.soa if soa is None else soa
        plain = self.plain if plain is None else plain
        if self.wings is not None:
            return self.wings.seg_pass(soa, plain)
        if self.wings_stride is not None:
            if plain:
                return wings_strided_plain(soa, self.w_start, self.w_n,
                                           self.num_points, self.tile,
                                           self.wings_stride)
            return wings_strided_pass(soa, self.w_start, self.w_n,
                                      self.num_points, self.tile,
                                      self.wings_stride,
                                      pieces=self.wings_pieces)
        if plain:
            return tile_plain(soa, self.w_start, self.w_n, self.num_points,
                              self.tile, self.chunk, "wings")
        return tile_pass(soa, self.w_start, self.w_n, self.num_points,
                         self.tile, self.chunk, "wings", self.wings_pieces)

    def core_pass(self, groups=None, plain=None):
        groups = self.groups if groups is None else groups
        return self.core.core_pass(groups,
                                   self.plain if plain is None else plain)

    def run_with(self, soa, groups):
        """The spectrum [num_points] from given wings and core blocks."""
        return self.wings_pass(soa) + self.core_pass(groups)


def make_device_plan(kernel_arrays, kin, num_points, n_per_v, cut_off,
                     tile=DEFAULT_TILE, chunk=DEFAULT_CHUNK, core_mode=None,
                     wings_mode=None, device="cuda", plain=False):
    """Builds a :class:`DevicePlan` from host kernel arrays (see
    :func:`accumulate_device`).

    ``wings_mode``: None/"auto" picks the strided overlapped-tile wings
    pass when the windows fit (:func:`pick_wings_stride`); "seg" forces the
    segment-32 variant, "tile" the raw Lorentz splat.  ``core_mode``:
    "segmix" (default), "seg" or "rows" (rows core; with ``wings_mode``
    "seg" it takes the strided branch, as the JAX planner does).  The
    blocks take the kernel arrays' float dtype (float32 for the kernels).
    ``device``: the card by default; without one it raises
    (runtime/device.resolve_device), and the CPU is taken only when asked
    for.
    """
    dtype = np.dtype(kernel_arrays["c_frac"].dtype)
    s_idx = kernel_arrays["s_idx"].astype(np.int64)
    e_idx = kernel_arrays["e_idx"].astype(np.int64)
    cs, ce = core_instance_windows(kernel_arrays, kin, num_points, n_per_v,
                                   cut_off)
    num0 = int(kernel_arrays["prefactor"].shape[-1])
    mode = CORE_MODE if core_mode is None else core_mode
    wings_stride = None
    if mode in ("seg", "segmix") and wings_mode == "seg":
        pass                           # segment-32 wings handled below
    elif wings_mode != "tile" and num0:
        wings_stride = pick_wings_stride(
            tile, int((e_idx - s_idx).max(initial=0)) + 1)
    if wings_stride is not None:
        # Chunk-aligned per-tile line layout: each tile reads only its own
        # chunks.
        lay = build_strided_layout(s_idx, wings_stride, num_points)
        for k, v in kernel_arrays.items():
            if v.ndim != 1 or v.shape[0] != num0:
                raise ValueError(
                    f"make_device_plan: kernel array {k!r} has shape "
                    f"{v.shape}, expected 1-D of the line count {num0}")
        kernel_arrays = {k: lay.gather(v) for k, v in kernel_arrays.items()}
        # Dead slots mirror pack_lines_soa's pad fills: zero prefactor,
        # empty wings windows, empty core windows.
        for key, fill in (("prefactor", 0.0), ("s_idx", -1),
                          ("e_idx", -2)):
            v = kernel_arrays[key]
            kernel_arrays[key] = np.where(lay.dead, fill, v).astype(v.dtype)
        w_start, w_n = lay.w_start, lay.w_n
        cs, ce = lay.gather_windows(cs, ce)
    plan = CorePlan(cs, ce, int(num_points), tile,
                    sort_key=kernel_arrays["y"], mode=core_mode)
    params = plan.gather(kernel_arrays)
    wings_plan = None
    soa, _ = pack_lines_soa(kernel_arrays, chunk, dtype=dtype)
    if plan.mode in ("seg", "segmix") and wings_mode == "seg":
        # Segment-32 wings (A/B).  Single fixed layer: the exact per-line
        # windows are the instance windows.
        wp = CorePlan(s_idx, e_idx, int(num_points), tile, mode="seg",
                      kind="wings")
        idx = np.maximum(wp.inst_line, 0)
        ka_inst = {k: kernel_arrays[k][idx]
                   for k in ("c_int", "c_frac", "scaled_repwid", "y",
                             "prefactor", "s_idx", "e_idx")}
        soa = wp.wings_params(ka_inst)
        wings_plan = wp
        w_start = w_n = np.zeros(1, np.int32)  # unused in this mode
    elif wings_stride is not None:
        # Prepacked wings rows for the strided pass (chunks are private per
        # tile; dead slots carry zero strength): PREF row = pref*y/sqrt(pi)
        # from the raw y, then Y row = y^2.
        soa[PREF, :] = soa[PREF, :] * soa[Y, :] * dtype.type(RSQRPI)
        soa[Y, :] = soa[Y, :] * soa[Y, :]
    else:
        w_start, w_n = tile_line_ranges(s_idx, e_idx, num_points, tile,
                                        chunk)
    return DevicePlan(soa, w_start, w_n, plan, params, num_points, tile,
                      chunk, wings_plan=wings_plan, wings_stride=wings_stride,
                      device=device, plain=plain)


def accumulate_device(kernel_arrays, kin, num_points, n_per_v, cut_off,
                      tile=DEFAULT_TILE, chunk=DEFAULT_CHUNK, device="cuda",
                      plain=False):
    """Two-pass single-layer accumulation (``accumulate_tpu``).

    Args:
        kernel_arrays: [N] host arrays from prepare_kernel_arrays (float32
            for the kernels; float64 runs the plain versions).
        kin: float64 physics dict (for core-window sizing).
        num_points: internal grid size.
        n_per_v / cut_off: grid convention parameters.
        device: torch device of the plan and the result (the card by
            default; "cpu" runs the plain versions on the host).
        plain: run the plain versions instead of the wrappers.

    Returns:
        [num_points] tensor of absorption cross sections on ``device``.
    """
    device = resolve_device(device)
    if kernel_arrays["prefactor"].shape[-1] == 0:
        return torch.zeros(int(num_points), device=device,
                           dtype=torch.from_numpy(
                               kernel_arrays["c_frac"][:0]).dtype)
    plan = make_device_plan(kernel_arrays, kin, int(num_points), n_per_v,
                            cut_off, tile, chunk, device=device, plain=plain)
    return plan()


def accumulate_batched(kernel_arrays, kin, num_points, n_per_v, cut_off,
                       tile=DEFAULT_TILE, chunk=DEFAULT_CHUNK, device="cuda",
                       plain=False):
    """Layer-batched two-pass accumulation (``accumulate_tpu_batched``):
    one launch of each pass for every layer of a gas.

    The raw-Lorentz splat wings run over per-layer tile CSRs ([B, T]); the
    core plan (the default mode) is shared by the layers, its instances
    covering the union of the per-layer core windows sized for the widest
    Doppler width, and the per-layer masks keep each layer exact.

    Args:
        kernel_arrays: [B, N] host arrays from prepare_kernel_arrays.
        kin: float64 physics dict ([B, N] leaves; core-window sizing).
        device: as :func:`accumulate_device`.

    Returns:
        [B, num_points] tensor on ``device``.
    """
    device = resolve_device(device)
    num_layers, num = kernel_arrays["prefactor"].shape
    if num == 0:
        return torch.zeros((num_layers, int(num_points)), device=device,
                           dtype=torch.from_numpy(
                               kernel_arrays["c_frac"][:, :0]).dtype)
    soa, _ = pack_lines_soa(kernel_arrays, chunk,
                            dtype=kernel_arrays["c_frac"].dtype)
    core_w = core_halfwidths(np.asarray(kin["repwid"]).min(axis=0), n_per_v,
                             cut_off)
    s_idx = kernel_arrays["s_idx"].astype(np.int64)
    e_idx = kernel_arrays["e_idx"].astype(np.int64)
    w_start, w_n = (np.stack(a) for a in zip(*(
        tile_line_ranges(s_idx[b], e_idx[b], num_points, tile, chunk)
        for b in range(num_layers))))
    center = np.rint(kernel_arrays["c_int"]).astype(np.int64)
    cs = np.maximum(center - core_w, s_idx).min(axis=0)
    ce = np.minimum(center + core_w, e_idx).max(axis=0)
    all_lorentz = (kernel_arrays["y"].astype(np.float32) >= 70.55).all(
        axis=0)
    ce = np.where(all_lorentz, cs - 1, ce)
    plan = CorePlan(cs, ce, int(num_points), tile,
                    sort_key=np.asarray(kernel_arrays["y"]).min(axis=0))
    pieces = TilePieces.of_csr(w_n)
    soa, w_start, w_n, params = (torch.as_tensor(a, device=device) for a in
                                 (soa, w_start, w_n,
                                  plan.gather(kernel_arrays)))
    if plain:
        wings = tile_plain(soa, w_start, w_n, int(num_points), tile, chunk,
                           "wings")
    else:
        wings = tile_pass(soa, w_start, w_n, int(num_points), tile, chunk,
                          "wings", pieces)
    return wings + plan.core_pass(params, plain)
