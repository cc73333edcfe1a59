"""A census of the Humlicek cores' work, by class and Humlicek region.

Labels every (instance, offset) pair of every chunk the mixed-slot core
walks (``csrc/lineshape.cu`` ``core_segmix_kernel``) as the kernel does, in
its float32 arithmetic: the chunk's class from its min y (skipped at >=
70.55), the offset in or out of the instance's window, and an in-window
offset's correction needed or not (|x| < xlim0; x^2 < k1_limit in class 1)
and, if needed, its list: K1 (class 1) or region 1, 2, 3 or CPF12 (split
by |x| <= xlim4 into its regions I and II), by ``region_limits``.  The
unit walk's two kernels (``corr_walk_kernel``, CORR, and ``rows_kernel``)
are counted the same way over their (item, point) pairs: CORR's lines of
each tile's walk against the tile's points, with the class from the
line's own y (:func:`corr_census`); the rows core's instance r of each
walked group against row r's points, with the class from the group's min
y (:func:`rows_census`).  It runs on any device (the CPU too) on the
inputs of ``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.core_census
        [--cells A16,A,B,C,D,F,G,Cc,Rc,R16,Sc,S16] [--device cpu|cuda]
        [--json OUT]

Cells of the mixed-slot core, built by ``wings_ab``'s builders: ``A16`` /
``A`` the 7-gas column at 0.1 cm-1, 16 layers / the first 2; ``B`` the
same at 0.01 cm-1 over 1-1000 cm-1, layers 0 and 5; ``C`` the 300k-line
headline layer's single-layer device plan; ``D`` the same layer at 0.01
cm-1 over 1-1000 cm-1; ``F`` config 5's first block of 4 layers (0.01 cm-1
over 1-5000 cm-1); ``G`` rank 0's balanced shard of a (2, 2) mesh on A.
Of the unit walk: ``Cc`` CORR on C's layer over its core-window CSR
(``tile_pass(..., "core")``, as ``chip_smoke.py`` phase 11 builds it: the
raw SoA, whose windows are the wing windows); ``Rc`` the rows core of C's
``core_mode="rows"`` device plan; ``R16`` the rows core of C's pack over
the canonical 16-layer column (E x 16, ``make_batched_fn(core_mode=
"rows")``).  Of the segment core (``seg_core_kernel``, which runs the
mixed-slot core's phases on chunks whose instances are all in slot 0, so
that the mixed-slot census counts it): ``Sc`` C's plan with
``core_mode="seg"``, ``S16`` E x 16 through ``make_batched_fn(core_mode=
"seg")``; their bytes are the 7 parameter rows read, the stream walk and
the output (:func:`pylbl_tpu_torch.tools.seg_bytes`).

Per cell it prints the walked chunks (or items) by class, the in-window
points, the needed points by list, the instances with an in-window point
and those of them that need nothing, the instances with a point of each
list, the evaluation rounds of 32 pairs the mixed-slot core's lists take
(the unit walk: the point groups it classifies, and the lane evaluations
of the earlier lane-per-point walks), and the operation count of
:func:`pylbl_tpu_torch.tools.census_ops` with its bound
(:func:`pylbl_tpu_torch.tools.census_bound`: the larger of the operations
at the FP32 peak and the bytes) beside the 41-operation one (``core_ops``;
``tile_ops`` and the rows' count of ``chip_smoke.py`` for the unit walk).
The census leaves out what a plan never holds: a non-finite prefactor or
a slot outside the tile.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from . import (CUT_OFF, OPS_LORENTZ, PEAK_BYTES, PEAK_OPS,
               canonical_layers, census_bound, census_ops, core_bytes,
               core_ops, headline_pack, headline_workload, layer_workload,
               pair_bytes, rows_ops, run_main, seg_bytes, seg_wings_evals,
               tile_ops)
from . import wings_ab
from ..ops import lineshape_cuda as lc
from ..ops.voigt import region_limits

CORE_CELLS = ("A16", "A", "B", "C", "D", "F", "G")
# The unit walk's cells: CORR on C's core CSR, the rows core on C and
# on E x 16.
PAIR_CELLS = ("Cc", "Rc", "R16")
# The segment core's cells: C's plan with core_mode="seg", and E x 16
# through make_batched_fn(core_mode="seg").
SEG_CELLS = ("Sc", "S16")
CELLS = CORE_CELLS + PAIR_CELLS + SEG_CELLS
# Pair labels: offset outside the window, in the window with a +0.0
# correction, then the lists.
OUT, NONE, K1, R1, R2, R3, CPF_I, CPF_II = range(8)
LISTS = {"k1": (K1,), "r1": (R1,), "r2": (R2,), "r3": (R3,),
         "cpf12": (CPF_I, CPF_II)}
CLASS_NAMES = ("skip", "k1", "c2", "c3", "c4")
SLAB = 512


def chunk_classes(blocks):
    """[M] class of each chunk [M, 8, 128] from its min y: 0 (>= 70.55,
    skipped), 1 (>= 8.425, K1), 2 (>= 6.8), 3 (>= 2.0), else 4."""
    ymin = blocks[:, lc.SR_Y].amin(dim=-1)
    cls = torch.full(ymin.shape, 4, dtype=torch.int64, device=ymin.device)
    for threshold, value in ((2.0, 3), (6.8, 2), (8.425, 1), (70.55, 0)):
        cls = torch.where(ymin >= threshold, value, cls)
    return cls


def pair_labels(blocks):
    """([M, 128, 32] int8 labels, [M] classes) of chunks [M, 8, 128] in
    their float dtype (float32: the kernel's arithmetic)."""
    cls = chunk_classes(blocks)
    c = cls[:, None, None]
    row = {r: blocks[:, r, :, None] for r in range(lc.SEGP_ROWS)}
    o = torch.arange(lc.SEG, device=blocks.device).to(blocks.dtype)
    x = ((row[lc.SR_SEG0REL] + o) - row[lc.SR_CFRAC]) * row[lc.SR_SRW]
    inside = (o >= row[lc.SR_SREL]) & (o <= row[lc.SR_EREL])
    y = row[lc.SR_Y]
    xlim0, xlim1, xlim2, xlim3, xlim4, _ = region_limits(y)
    abx = x.abs()
    k1_need = x * x < torch.clamp_min(15100.0 + y * (40.0 - y * 3.6), 0.0)
    need = torch.where(c == 1, k1_need, abx < xlim0) & (y < 70.55) \
        & inside & (c > 0)
    region = torch.where(
        abx >= xlim1, R1, torch.where(
            (c == 2) | (abx >= xlim2), R2, torch.where(
                (c == 3) | (abx < xlim3), R3,
                torch.where(abx <= xlim4, CPF_I, CPF_II))))
    label = torch.where(need, torch.where(c == 1, K1, region),
                        torch.where(inside, NONE, OUT))
    return label.to(torch.int8), cls


def walked_blocks(params, t_start, t_chunks):
    """The [B * n, 8, 128] blocks of the chunks every layer walks (tile
    t's chunks t_start[t] .. t_start[t] + t_chunks[t] - 1), tile-major."""
    params = params if params.dim() == 3 else params[None]
    device = params.device
    t_start = torch.as_tensor(t_start, device=device)
    t_chunks = torch.as_tensor(t_chunks, device=device)
    _, _, ids = lc._chunk_refs(t_start, t_chunks, t_chunks.numel(), device)
    blocks = params.reshape(params.shape[0], lc.SEGP_ROWS, -1, lc.ROWS_CHUNK)
    return blocks.index_select(2, ids).permute(0, 2, 1, 3).reshape(
        -1, lc.SEGP_ROWS, lc.ROWS_CHUNK)


def census(params, t_start, t_chunks, slab=SLAB):
    """The census of a core parameter block [B, 8, I] or [8, I] walked
    through the chunk CSR (``t_start``, ``t_chunks``, [T], numpy or
    tensors): a dict of int counts (see the module's note)."""
    blocks = walked_blocks(params, t_start, t_chunks)
    pairs = torch.zeros(8, dtype=torch.int64, device=blocks.device)
    classes = torch.zeros(5, dtype=torch.int64, device=blocks.device)
    inst = {k: 0 for k in LISTS}
    out = dict(instances=0, instances_needing_nothing=0,
               needing_k1_chunks=0, needing_region_chunks=0, rounds=0)
    for lo in range(0, blocks.shape[0], slab):
        label, cls = pair_labels(blocks[lo:lo + slab])
        pairs += torch.bincount(label.reshape(-1).long(), minlength=8)
        classes += torch.bincount(cls, minlength=5)
        live = (label != OUT).any(dim=-1)
        needing = (label >= K1).any(dim=-1)
        out["instances"] += int(live.sum())
        out["instances_needing_nothing"] += int((live & ~needing).sum())
        k1_chunk = (cls == 1)[:, None]
        out["needing_k1_chunks"] += int((needing & k1_chunk).sum())
        out["needing_region_chunks"] += int((needing & ~k1_chunk).sum())
        for key, labels in LISTS.items():
            hit = sum((label == v).long() for v in labels)
            inst[key] += int((hit.sum(dim=-1) > 0).sum())
            per_chunk = hit.sum(dim=(1, 2))
            out["rounds"] += int(((per_chunk + 31) // 32).sum())
    pairs = pairs.tolist()
    classes = classes.tolist()
    chunks = sum(classes)
    out.update(
        chunks=chunks,
        chunks_by_class=dict(zip(CLASS_NAMES, classes)),
        lane_evals=chunks * lc.ROWS_CHUNK * lc.SEG,
        in_window=chunks * lc.ROWS_CHUNK * lc.SEG - pairs[OUT],
        needed={"k1": pairs[K1], "r1": pairs[R1], "r2": pairs[R2],
                "r3": pairs[R3], "cpf12_i": pairs[CPF_I],
                "cpf12_ii": pairs[CPF_II]},
        needed_total=sum(pairs[K1:]),
        instances_by_list=inst,
        parent_warp_iterations=(chunks - classes[0]) * lc.ROWS_CHUNK)
    return out


# ---- The unit walk (CORR and the rows core) ----

# The bound csrc pair_item puts on |c_int|, |c_frac| and the need window's
# half width before it narrows a window.
FAR = 2.0 ** 21
# The unit walk's point groups (a warp's lanes).
GROUP = 32


def item_class(y):
    """[...] class of pair-walk items from y (csrc ``pair_class``; CORR:
    the line's own y, the rows core: the group's min y): 0 (y >= 70.55,
    skipped), 1 (>= 8.425, K1), 2 (>= 6.8), 3 (>= 2.0), else 4, NaN
    included (it fails every test of the JAX conds)."""
    cls = torch.full(y.shape, 4, dtype=torch.int64, device=y.device)
    for threshold, value in ((2.0, 3), (6.8, 2), (8.425, 1), (70.55, 0)):
        cls = torch.where(y >= threshold, value, cls)
    return cls


def pair_items(ws, we, c_int, c_frac, srw, y, pref, cls):
    """The unit walk's items (csrc ``pair_item``) in their float dtype
    (float32: the kernel's arithmetic), every input a tensor of one shape:
    a dict of the inputs and the need window ``lo``/``hi``, ``any`` (a
    non-finite prefactor in a walked class: every in-window point takes
    the whole correction), ``live`` (a walked class with y < 70.55 and a
    finite prefactor), ``lim0`` (class 1: k1_limit, the bound of x^2;
    else xlim0), ``xlim1`` .. ``xlim4``."""
    any_pref = (cls > 0) & ~torch.isfinite(pref)
    live = (cls > 0) & (y < 70.55) & ~any_pref
    k1 = cls == 1
    k1_lim = torch.clamp_min(15100.0 + y * (40.0 - y * 3.6), 0.0)
    xlim0, xlim1, xlim2, xlim3, xlim4, _ = region_limits(y)
    half = (torch.where(k1, torch.sqrt(k1_lim), xlim0) / srw.abs()) \
        * 1.0009765625
    near = (half <= FAR) & (c_int.abs() <= FAR) & (c_frac.abs() <= FAR)
    c = c_int + c_frac
    lo = torch.floor(c - half) - 1.0
    hi = torch.ceil(c + half) + 1.0
    lo = torch.where(near & (lo > ws), lo, ws)
    hi = torch.where(near & (hi < we), hi, we)
    return dict(ws=ws, we=we, c_int=c_int, c_frac=c_frac, srw=srw, y=y,
                pref=pref, cls=cls, any=any_pref, live=live,
                lo=torch.where(any_pref, ws, torch.where(live, lo, 0.0)),
                hi=torch.where(any_pref, we, torch.where(live, hi, -1.0)),
                lim0=torch.where(k1, k1_lim, xlim0), xlim1=xlim1,
                xlim2=xlim2, xlim3=xlim3, xlim4=xlim4)


def item_labels(items, p):
    """[M, P] labels of items ([M] tensors of :func:`pair_items`) at their
    points ``p`` [M, P] (or [P]): OUT (outside the item's window), NONE
    (in it, needing no correction; a non-finite prefactor's points too,
    which a plan never holds), K1, R1, R2, R3, CPF_I, CPF_II, as the
    kernels' classifier (csrc ``unit_needs``) lists them."""
    col = {k: v[:, None] for k, v in items.items()}
    inside = (p >= col["ws"]) & (p <= col["we"])
    x = ((p - col["c_int"]) - col["c_frac"]) * col["srw"]
    abx = x.abs()
    cls = col["cls"]
    k1 = cls == 1
    need = torch.where(k1, x * x < col["lim0"], abx < col["lim0"]) \
        & col["live"] & inside
    region = torch.where(
        abx >= col["xlim1"], R1, torch.where(
            (cls == 2) | (abx >= col["xlim2"]), R2, torch.where(
                (cls == 3) | (abx < col["xlim3"]), R3,
                torch.where(abx <= col["xlim4"], CPF_I, CPF_II))))
    return torch.where(need, torch.where(k1, K1, region),
                       torch.where(inside, NONE, OUT)).to(torch.int8)


def _pair_totals(device):
    return {"pairs": torch.zeros(8, dtype=torch.int64, device=device),
            "classes": torch.zeros(5, dtype=torch.int64, device=device),
            "inst": {k: 0 for k in LISTS}, "instances": 0,
            "instances_needing_nothing": 0, "needing_k1_chunks": 0,
            "needing_region_chunks": 0, "visits": 0, "rows": 0,
            "parent_groups": 0, "needed_outside": 0}


def _pair_add(tot, items, p):
    """Adds the labels of items [M] at points p [M, P] (P whole groups of
    32) into the totals ``tot``."""
    label = item_labels(items, p)
    tot["pairs"] += torch.bincount(label.reshape(-1).long(), minlength=8)
    tot["classes"] += torch.bincount(items["cls"], minlength=5)
    needed = label >= K1
    live = (label != OUT).any(dim=-1)
    needing = needed.any(dim=-1)
    tot["instances"] += int(live.sum())
    tot["instances_needing_nothing"] += int((live & ~needing).sum())
    k1 = items["cls"] == 1
    tot["needing_k1_chunks"] += int((needing & k1).sum())
    tot["needing_region_chunks"] += int((needing & ~k1).sum())
    for key, labels in LISTS.items():
        hit = sum((label == v).long() for v in labels)
        tot["inst"][key] += int((hit.sum(dim=-1) > 0).sum())
    glo = p[:, ::GROUP] if p.dim() == 2 else p[None, ::GROUP]
    ghi = glo + (GROUP - 1)
    col = {k: items[k][:, None] for k in ("lo", "hi", "ws", "we")}
    tot["visits"] += int(((col["hi"] >= glo) & (col["lo"] <= ghi)).sum())
    walked = (items["cls"] > 0)[:, None]
    tot["parent_groups"] += int(((col["we"] >= glo) & (col["ws"] <= ghi)
                                 & walked).sum())
    tot["rows"] += int(needed.reshape(needed.shape[0], -1, GROUP)
                       .any(dim=-1).sum())
    outside = needed & ~((p >= col["lo"]) & (p <= col["hi"]))
    tot["needed_outside"] += int(outside.sum())


def _pair_result(tot):
    pairs = tot["pairs"].tolist()
    classes = tot["classes"].tolist()
    items = sum(classes)
    return dict(
        items=items, items_by_class=dict(zip(CLASS_NAMES, classes)),
        pairs=sum(pairs), in_window=sum(pairs) - pairs[OUT],
        needed={"k1": pairs[K1], "r1": pairs[R1], "r2": pairs[R2],
                "r3": pairs[R3], "cpf12_i": pairs[CPF_I],
                "cpf12_ii": pairs[CPF_II]},
        needed_total=sum(pairs[K1:]), instances=tot["instances"],
        instances_needing_nothing=tot["instances_needing_nothing"],
        instances_by_list=tot["inst"],
        needing_k1_chunks=tot["needing_k1_chunks"],
        needing_region_chunks=tot["needing_region_chunks"],
        visits=tot["visits"], rows=tot["rows"],
        parent_lane_evals=GROUP * tot["parent_groups"],
        needed_outside=tot["needed_outside"])


def corr_census(soa, start, nchunks, tile, chunk, slab=1 << 22):
    """The census of CORR (``tile_pass(..., "core")`` at stride = tile)
    over a raw SoA [B, 8, N] or [8, N] and its tile CSR (``start``,
    ``nchunks``: [T] or [B, T], numpy or tensors): every line of each
    tile's walk against the tile's points, the class from the line's own
    y; a dict of int counts.  Beside the mixed-slot core's keys it counts
    the items (line visits) by class, ``visits`` (the (item, point group)
    pairs the walk classifies: the need window meets the group), ``rows``
    (those with a needed point), ``parent_lane_evals`` (the earlier
    walk's: 32 lanes of each group a walked line's window meets) and
    ``needed_outside`` (needed points outside the need window: 0).  The
    ``needing_*_chunks`` keys count the items needing a correction, in
    class 1 and in the others."""
    soa = soa if soa.dim() == 3 else soa[None]
    device = soa.device
    tot = _pair_totals(device)
    offs = torch.arange(tile, device=device)
    for b in range(soa.shape[0]):
        rows = [torch.as_tensor(a, device=device) for a in (start, nchunks)]
        rows = [r if r.dim() == 1 else r[b] for r in rows]
        zero = torch.zeros(rows[0].numel(), dtype=torch.int64, device=device)
        tiles, line0, _ = lc._chunk_pairs(rows[0], rows[1], chunk, zero,
                                          device)
        lines = (line0[:, None] + torch.arange(chunk, device=device))
        tiles = tiles[:, None].expand_as(lines).reshape(-1)
        lines = lines.reshape(-1)
        per = max(1, slab // tile)
        for lo in range(0, lines.numel(), per):
            rows_ = soa[b][:, lines[lo:lo + per]]
            y = rows_[lc.Y]
            items = pair_items(rows_[lc.S_IDX], rows_[lc.E_IDX],
                               rows_[lc.C_INT], rows_[lc.C_FRAC],
                               rows_[lc.SRW], y, rows_[lc.PREF],
                               item_class(y))
            p = (tiles[lo:lo + per, None] * tile + offs).to(soa.dtype)
            _pair_add(tot, items, p)
    return _pair_result(tot)


def rows_census(groups, g_start, g_n, tile, ymin=None, chunk=lc.ROWS_CHUNK,
                slab=1 << 22):
    """The census of the rows core over a group block [B, 64, G] or [64,
    G] and its group CSR (``g_start``, ``g_n``: [T]): instance r of every
    walked group against the points of row r of its tile, the class from
    the group's min y (row 56, or ``ymin`` [B, 1, G]); the counts of
    :func:`corr_census`, its items the instances."""
    groups = groups if groups.dim() == 3 else groups[None]
    device = groups.device
    start = torch.as_tensor(g_start, device=device).long()
    count = torch.as_tensor(g_n, device=device).long() * chunk
    tiles = torch.repeat_interleave(torch.arange(count.numel(),
                                                 device=device), count)
    cols = start[tiles] + (torch.arange(tiles.numel(), device=device)
                           - (torch.cumsum(count, 0) - count)[tiles])
    row_w = tile // 8
    offs = torch.arange(row_w, device=device)
    tot = _pair_totals(device)
    per = max(1, slab // row_w)
    for b in range(groups.shape[0]):
        ym = groups[b, lc.YMIN_ROW] if ymin is None else ymin[b, 0]
        for r in range(8):
            for lo in range(0, cols.numel(), per):
                col = cols[lo:lo + per]
                fld = groups[b, r::8][:lc.N_FIELDS][:, col]
                c_int, c_frac, srw, y, pref, s, e = fld
                items = pair_items(s, e, c_int, c_frac, srw, y, pref,
                                   item_class(ym[col]))
                p = (tiles[lo:lo + per, None] * tile + r * row_w
                     + offs).to(groups.dtype)
                _pair_add(tot, items, p)
    return _pair_result(tot)


# Synthetic chunks by class: (y low, y high) of the instances and the min
# y one instance takes (the class's threshold or a tiny y).
_SYNTH_Y = {0: (70.6, 95.0, 70.55), 1: (8.5, 80.0, 8.425),
            2: (6.9, 30.0, 6.8), 3: (2.1, 12.0, 2.0), 4: (0.0, 3.0, 1e-7)}


def synthetic_core(seed=0, layers=2, tile=256, tile_chunks=(3, 0, 6),
                   classes=(0, 1, 2, 3, 4), dead=0.1):
    """A mixed-slot core input made from ``seed`` with numpy: ([B, 8, I]
    float32 parameters, t_start, t_chunks int32 [T], num_points), the
    chunks' classes cycling through ``classes`` (0: every y >= 70.55).
    Instances take windows inside, across and outside offsets 0..31 (some
    empty), x over the Humlicek regions (srw log-uniform 0.02-20), a
    ``dead`` share of dead fills (y = 100, empty window, zero prefactor),
    y inside a non-skip chunk up to past 70.55, one tiny or threshold y a
    chunk; layer b > 0 scales y by 1 + 0.1 b."""
    rng = np.random.default_rng(seed)
    t_chunks = np.asarray(tile_chunks, np.int32)
    t_start = (np.cumsum(t_chunks) - t_chunks).astype(np.int32)
    n = int(t_chunks.sum()) * lc.ROWS_CHUNK
    rows = np.zeros((lc.SEGP_ROWS, n), np.float32)
    cls = np.repeat([classes[k % len(classes)]
                     for k in range(int(t_chunks.sum()))], lc.ROWS_CHUNK)
    lo = np.asarray([_SYNTH_Y[c][0] for c in cls])
    hi = np.asarray([_SYNTH_Y[c][1] for c in cls])
    y = lo + (hi - lo) * rng.random(n) ** 2
    y[::lc.ROWS_CHUNK] = [_SYNTH_Y[c][2] for c in cls[::lc.ROWS_CHUNK]]
    y[cls > 0] = np.where(rng.random(int((cls > 0).sum())) < 0.03, 72.0,
                          y[cls > 0])
    y[cls == 4] = np.where(rng.random(int((cls == 4).sum())) < 0.05, 0.0,
                           y[cls == 4])
    s_rel = rng.integers(-12, 36, n).astype(np.float32)
    rows[lc.SR_SEG0REL] = rng.uniform(-40.0, 8.0, n)
    rows[lc.SR_CFRAC] = rng.random(n)
    rows[lc.SR_SRW] = np.exp(rng.uniform(np.log(0.02), np.log(20.0), n))
    rows[lc.SR_Y] = y
    rows[lc.SR_PREF] = rng.uniform(0.1, 2.0, n)
    rows[lc.SR_SREL] = s_rel
    rows[lc.SR_EREL] = s_rel + rng.integers(-3, 40, n)
    rows[lc.SR_SLOT] = rng.integers(0, tile // lc.SEG, n)
    gone = rng.random(n) < dead
    fills = np.asarray(lc._SEG_FILLS, np.float32)
    rows[:, gone] = fills[:, None]
    params = np.stack([rows] * layers)
    for b in range(1, layers):
        params[b, lc.SR_Y] = np.where(gone, rows[lc.SR_Y],
                                      rows[lc.SR_Y] * np.float32(1 + 0.1 * b))
    return params, t_start, t_chunks, t_chunks.size * tile


def synthetic_segment(seed=0, kind="core", layers=2, tile=256,
                      tile_chunks=(3, 0, 6), odd=True,
                      classes=(0, 1, 2, 3, 4), slots_used=None):
    """A segment pass input made from ``seed`` with numpy: ([B, 8, I]
    float32 parameters, t_start, t_chunks, chunk_slot int32, num_points),
    each walked chunk in a random slot of its tile (streams of several
    chunks and empty ones).  "core": :func:`synthetic_core`'s chunks (every
    class and Humlicek region, dead instances) with the slot row zero;
    "wings": raw rows in absolute coordinates around each chunk's segment
    (windows that hold it or end inside it; in two chunks of three also
    windows that miss it, some empty, and a tenth dead; srw log-uniform
    0.05-5, y 1e-3-30, prefactors of both signs).
    With ``odd``: an infinite and a NaN prefactor, a NaN y, y = 0 at x = 0
    in its window (core: in a class-4 chunk), and in the wings a NaN
    window start.  ``classes``: the core chunks' classes in turn
    (:func:`synthetic_core`); ``slots_used``: the chunks' slots are drawn
    from the first ``slots_used`` of the tile's (longer streams)."""
    rng = np.random.default_rng(seed)
    t_chunks = np.asarray(tile_chunks, np.int32)
    t_start = (np.cumsum(t_chunks) - t_chunks).astype(np.int32)
    chunks = int(t_chunks.sum())
    slots = tile // lc.SEG
    chunk_slot = rng.integers(0, min(slots, slots_used or slots),
                              chunks).astype(np.int32)
    n = chunks * lc.ROWS_CHUNK
    if kind == "core":
        params = synthetic_core(seed, layers, tile, tile_chunks,
                                classes)[0]
        params[:, lc.SR_SLOT] = 0.0
        if odd:
            # Chunk 1 (K1): an infinite prefactor in offsets 3..9; chunk 4
            # (class 4): a NaN prefactor and y = 0 at x = 0 (offset 5);
            # chunk 3: a NaN y, whose NaN min y takes class 4 (the whole
            # correction), as in the JAX conds.
            c = lc.ROWS_CHUNK
            for i, rows, vals in (
                    (c + 40, (lc.SR_PREF, lc.SR_SREL, lc.SR_EREL),
                     (np.inf, 3.0, 9.0)),
                    (4 * c + 7, (lc.SR_PREF, lc.SR_SREL, lc.SR_EREL),
                     (np.nan, 0.0, 31.0)),
                    (4 * c + 9, range(lc.SR_SLOT),
                     (-5.0, 0.0, 1.0, 0.0, 1.0, 2.0, 12.0)),
                    (3 * c + 100, (lc.SR_Y,), (np.nan,))):
                for r, v in zip(rows, vals):
                    params[:, r, i] = v
        return params, t_start, t_chunks, chunk_slot, t_chunks.size * tile
    tiles = np.repeat(np.arange(t_chunks.size), t_chunks)
    lo = np.repeat(tiles * tile + lc.SEG * chunk_slot,
                   lc.ROWS_CHUNK).astype(np.float64)
    center = lo + rng.integers(-40, 72, n)
    # Windows that reach the segment (holding it or ending inside it); in
    # every chunk but each third, also misses, random ones and dead fills.
    start = lo + rng.integers(-60, 17, n)
    end = lo + rng.integers(15, 80, n)
    mixed = np.repeat(np.arange(chunks) % 3 != 0, lc.ROWS_CHUNK)
    odd_w = mixed & (rng.random(n) < 0.3)
    start = np.where(odd_w, lo + rng.integers(-20, 40, n), start)
    end = np.where(odd_w, start + rng.integers(-3, 60, n), end)
    rows = np.stack([center, rng.uniform(-0.5, 0.5, n),
                     np.exp(rng.uniform(np.log(0.05), np.log(5.0), n)),
                     np.exp(rng.uniform(np.log(1e-3), np.log(30.0), n)),
                     rng.uniform(0.1, 2.0, n)
                     * np.where(rng.random(n) < 0.2, -1.0, 1.0),
                     start, end, np.zeros(n)]).astype(np.float32)
    fills = np.asarray(lc._SEG_FILLS, np.float32)
    rows[:, mixed & (rng.random(n) < 0.1)] = fills[:, None]
    if odd:
        rows[lc.PREF, 130] = np.inf
        rows[lc.PREF, 260] = np.nan
        rows[lc.Y, 300] = np.nan
        rows[lc.S_IDX, 420] = np.nan
        rows[:, 520] = (lo[520] + 5, 0.0, 1.0, 0.0, 1.0, lo[520] - 4,
                        lo[520] + 40, 0.0)
    params = np.stack([rows] * layers)
    for b in range(1, layers):
        params[b, lc.Y] = rows[lc.Y] * np.float32(1 + 0.1 * b)
    return params, t_start, t_chunks, chunk_slot, t_chunks.size * tile


# Synthetic pair-walk lines by class: y from (low, high), beside y = 0, a
# tiny y and the classes' thresholds.
_LINE_Y = ((70.55, 95.0), (8.425, 70.5), (6.8, 8.424), (2.0, 6.799),
           (0.0, 1.999))
_LINE_CLASS_SHARE = (0.1, 0.25, 0.15, 0.2, 0.3)


def synthetic_lines(seed, num_lines, num_points, layers=1,
                    shares=_LINE_CLASS_SHARE):
    """Kernel arrays of ``num_lines`` lines made from ``seed`` with numpy
    over ``num_points`` points, in center order, [N] (``layers`` = 1) or
    [B, N]: y over the classes (:func:`item_class`) in ``shares`` of the
    lines, a twentieth of the lines at y = 0, 1e-7 or a threshold, wing
    windows of 3-300 points around the center (some past the grid), srw
    log-uniform 0.3-40 (need windows of a few to a few hundred points),
    prefactors of both signs; layer b > 0 scales y by
    1 + 0.1 b."""
    rng = np.random.default_rng(seed)
    cls = rng.choice(5, num_lines, p=shares)
    lo = np.asarray([_LINE_Y[c][0] for c in cls])
    hi = np.asarray([_LINE_Y[c][1] for c in cls])
    y = (lo + (hi - lo) * rng.random(num_lines)).astype(np.float32)
    odd = rng.random(num_lines) < 0.05
    y[odd] = rng.choice(np.asarray([0.0, 1e-7, 2.0, 6.8, 8.425, 70.55],
                                   np.float32), int(odd.sum()))
    center = np.sort(rng.uniform(-20.0, num_points + 20.0, num_lines))
    c_int = np.rint(center).astype(np.int32)
    half = rng.integers(3, 300, num_lines)
    out = {"c_int": c_int,
           "c_frac": (center - c_int).astype(np.float32),
           "scaled_repwid": np.exp(rng.uniform(np.log(0.3), np.log(40.0),
                                               num_lines)).astype(np.float32),
           "y": y,
           "prefactor": (rng.uniform(0.1, 2.0, num_lines)
                         * np.where(rng.random(num_lines) < 0.2, -1, 1)
                         ).astype(np.float32),
           "s_idx": (c_int - half).astype(np.int32),
           "e_idx": (c_int + half).astype(np.int32)}
    if layers == 1:
        return out
    out = {k: np.stack([v] * layers) for k, v in out.items()}
    for b in range(1, layers):
        out["y"][b] = y * np.float32(1 + 0.1 * b)
    return out


def synthetic_core_windows(arrays):
    """The lines' core windows: the center -/+ the points of |x| <
    XLIM0_MAX (the layers' widest), within the wing window, empty for y >=
    70.55 in every layer (as ``core_instance_windows``)."""
    from ..ops.voigt import XLIM0_MAX

    srw = np.atleast_2d(arrays["scaled_repwid"]).min(axis=0)
    half = np.ceil(XLIM0_MAX / srw).astype(np.int64) + 1
    c_int = np.atleast_2d(arrays["c_int"])[0].astype(np.int64)
    cs = np.maximum(c_int - half, np.atleast_2d(arrays["s_idx"])[0])
    ce = np.minimum(c_int + half, np.atleast_2d(arrays["e_idx"])[0])
    dead = (np.atleast_2d(arrays["y"]) >= np.float32(70.55)).all(axis=0)
    return cs, np.where(dead, cs - 1, ce)


def synthetic_corr(seed=0, layers=2, tile=256, num_tiles=5, num_lines=700,
                   chunk=64, csr="core", shares=_LINE_CLASS_SHARE):
    """A CORR input made from ``seed`` (:func:`synthetic_lines`): ([B, 8,
    N] or [8, N] float32 raw SoA in chunks of ``chunk`` with dead pad
    lines, start, nchunks int32 [T], num_points); the tile CSR of the core
    windows (``csr="core"``, as the scalar core pass) or of the wing
    windows (``"wings"``: tiles whose lines need nothing); ``shares`` as
    :func:`synthetic_lines`."""
    n = num_tiles * tile
    arrays = synthetic_lines(seed, num_lines, n, layers, shares)
    soa = lc.pack_lines_soa(arrays, chunk)[0]
    if csr == "core":
        lo, hi = synthetic_core_windows(arrays)
    else:
        lo = np.atleast_2d(arrays["s_idx"])[0].astype(np.int64)
        hi = np.atleast_2d(arrays["e_idx"])[0].astype(np.int64)
    start, nchunks = lc.tile_line_ranges(lo, hi, n, tile, chunk)
    return soa, start, nchunks, n


def synthetic_rows(seed=0, layers=2, tile=256, num_tiles=4,
                   num_lines=500, shares=_LINE_CLASS_SHARE):
    """A rows-core input made from ``seed`` (:func:`synthetic_lines`):
    ([B, 64, G] or [64, G] float32 group block, its rows ``CorePlan``,
    num_points), the groups of each (tile, row) in descending y, so that
    a tile's groups run through the classes by their min y; ``shares`` as
    :func:`synthetic_lines`."""
    n = num_tiles * tile
    arrays = synthetic_lines(seed, num_lines, n, layers, shares)
    cs, ce = synthetic_core_windows(arrays)
    plan = lc.CorePlan(cs, ce, n, tile,
                       sort_key=np.atleast_2d(arrays["y"])[0], mode="rows")
    return plan.gather(arrays), plan, n


class CoreCell:
    """One cell's core inputs: ``params`` [B, 8, I] (or [8, I] for a
    single layer) and the plan's chunk CSR and pieces."""

    def __init__(self, name, plan, params):
        self.name = name
        self.plan = plan
        self.params = params
        consts = plan._device_consts(params.device)
        self.t_start, self.t_chunks = consts["t_start"], consts["t_chunks"]
        self.nbytes = core_bytes(params, self.t_chunks.numel(),
                                 plan.num_points)

    def census(self):
        return census(self.params, self.t_start, self.t_chunks)

    @property
    def ops41(self):
        return core_ops(self.params)


def layer_cell(name, device, grid):
    """A single-layer device plan's core (C, D): the headline layer."""
    work = layer_workload(headline_pack(), grid)
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device)
    return CoreCell(name, plan.core, plan.groups)


class PairCell:
    """One cell of the unit walk: ``kind`` "corr" (``data`` a raw SoA
    [B, 8, N] or [8, N], ``csr`` its tile CSR), "rows" or "rows_vmem"
    (``data`` a group block, ``walk`` its :class:`GroupWalk`, ``ymin`` the
    separate min-y block of "rows_vmem"); ``run(piece)`` launches its pass
    through the current library (CORR at ``piece`` chunks a piece, None:
    :data:`WINGS_PIECE_CHUNKS`; the rows core's pieces are fixed),
    ``plain(piece)`` its plain version; ``kernel`` its kernels' names in
    a profiler trace (this build's and the earlier CORR's)."""

    KERNELS = {"corr": ("corr_walk_kernel", "wings_kernel"),
               "rows": "rows_kernel", "rows_vmem": "rows_kernel"}

    def __init__(self, name, kind, data, num_points, tile, csr=None,
                 walk=None, ymin=None, chunk=lc.DEFAULT_CHUNK):
        self.name = name
        self.kind = kind
        self.data = data
        self.num_points = num_points
        self.tile = tile
        self.csr = csr
        self.walk = walk
        self.ymin = ymin
        self.chunk = chunk
        self.kernel = self.KERNELS[kind]
        self.nbytes = pair_bytes(kind, data,
                                 csr or walk.tensors(data.device),
                                 num_points)
        if kind == "corr":
            self.ops41 = tile_ops(data, num_points, "corr")
        else:
            self.ops41 = rows_ops(data, walk.g_n, tile)
        self._pieces = {}

    def census(self):
        if self.kind == "corr":
            return corr_census(self.data, *self.csr, self.tile, self.chunk)
        g_start, g_n = self.walk.tensors(self.data.device)
        return rows_census(self.data, g_start, g_n, self.tile,
                           None if self.ymin is None else
                           self.ymin if self.ymin.dim() == 3
                           else self.ymin[None])

    def run(self, piece=None):
        n, tile = self.num_points, self.tile
        if self.kind == "corr":
            piece = lc.WINGS_PIECE_CHUNKS if piece is None else piece
            if piece not in self._pieces:
                self._pieces[piece] = lc.TilePieces.of_csr(self.csr[1],
                                                           piece=piece)
            return lc.tile_pass(self.data, *self.csr, n, tile, self.chunk,
                                "core", self._pieces[piece])
        if self.kind == "rows":
            return lc.rows_pass(self.data, self.walk, n, tile)
        return lc.rows_vmem_pass(self.data, self.ymin, self.walk, n, tile)

    def plain(self, piece=None):
        n, tile = self.num_points, self.tile
        if self.kind == "corr":
            piece = lc.WINGS_PIECE_CHUNKS if piece is None else piece
            return lc.tile_plain(self.data, *self.csr, n, tile, self.chunk,
                                 "core", piece=piece)
        return lc.rows_plain(self.data, *self.walk.tensors(self.data.device),
                             n, tile, ymin=self.ymin)


class SegCell:
    """One cell of the segment pass (``pylbl_seg``): its seg-mode
    :class:`CorePlan` (``kind`` "core" or "wings") and parameters [B, 8, I]
    or [8, I]; ``run(piece)`` launches the pass through the current
    library (the chunk kernel's grid is the library's own: ``piece`` is
    not read), ``plain(piece)`` its plain version; ``kernel`` the pass's
    kernels' names in a profiler trace (this build's chunk kernel and the
    fold, and the earlier builds' chunk kernel); ``nbytes`` its bytes
    (:func:`seg_bytes`: 7 rows).  The core's census is the mixed-slot
    core's over the plan's chunk CSR (its instances are all in slot 0);
    the wings carry their terms ``evals``, ``ops`` (7 a term, the
    Lorentzian's) and ``bound_ms``."""

    KERNELS = {"core": ("seg_core_kernel", "seg_fold_kernel",
                        "seg_chunk_kernel"),
               "wings": ("seg_wings_kernel", "seg_fold_kernel",
                         "seg_chunk_kernel")}

    def __init__(self, name, plan, params):
        self.name = name
        self.plan = plan
        self.params = params
        self.kind = plan.kind
        self.line = "seg"
        self.kernel = self.KERNELS[self.kind]
        self.nbytes = seg_bytes(self.kind, params, plan.streams,
                                plan.num_points)
        if self.kind == "wings":
            self.evals = seg_wings_evals(params, plan.streams)
            self.ops = OPS_LORENTZ * self.evals
            self.bound_ms = max(self.ops / PEAK_OPS,
                                self.nbytes / PEAK_BYTES) * 1e3

    def census(self):
        consts = self.plan._device_consts(self.params.device)
        return census(self.params, consts["t_start"], consts["t_chunks"])

    @property
    def ops41(self):
        return core_ops(self.params)

    def run(self, piece=None):
        return self.plan.seg_pass(self.params)

    def plain(self, piece=None):
        return self.plan.seg_pass(self.params, plain=True)


def seg_layer_cell(name, device, work=None, **modes):
    """Sc (``core_mode="seg"``) or Sw (``wings_mode="seg"``): the segment
    pass of a layer's device plan (``chip_smoke.py`` phase 11)."""
    work = work or headline_workload()
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device, **modes)
    if "core_mode" in modes:
        return SegCell(name, plan.core, plan.groups)
    return SegCell(name, plan.wings, plan.soa)


def seg_column_cell(device, work=None, layers=16):
    """S16: the segment core of a layer's pack over the canonical column
    of ``layers`` layers (E x 16, ``make_batched_fn(core_mode="seg")``,
    ``chip_smoke.py`` phase 12)."""
    from ..parallel.lines import make_batched_fn

    work = work or headline_workload()
    fn = make_batched_fn(work["pack"], work["grid"], core_mode="seg",
                         device=device)
    t, p, vmr = canonical_layers(layers)
    _, core = fn.stage.assemble(*(torch.as_tensor(a, dtype=torch.float32,
                                                  device=device)
                                  for a in (t, p, vmr["H2O"])))
    return SegCell("S16", fn.core_plan, core)


def corr_cell(device, work=None):
    """Cc: CORR over a layer's raw SoA and the tile CSR of its core windows
    (``chip_smoke.py`` phase 11; ``work``: a ``layer_workload``, the
    headline layer by default)."""
    from ..ops.lineshape import core_halfwidth

    work = work or headline_workload()
    arrays, n = work["arrays"], work["n"]
    s = arrays["s_idx"].astype(np.int64)
    e = arrays["e_idx"].astype(np.int64)
    core_w = core_halfwidth(work["kin"], work["npv"], CUT_OFF)
    center = np.rint(arrays["c_int"]).astype(np.int64)
    csr = lc.tile_line_ranges(np.maximum(center - core_w, s),
                              np.minimum(center + core_w, e), n,
                              lc.DEFAULT_TILE, lc.DEFAULT_CHUNK)
    soa = lc.pack_lines_soa(arrays, lc.DEFAULT_CHUNK)[0]
    return PairCell("Cc", "corr", torch.as_tensor(soa, device=device), n,
                    lc.DEFAULT_TILE,
                    csr=[torch.as_tensor(a, device=device) for a in csr])


def rows_layer_cell(name, device, vmem=False, work=None):
    """Rc (Rv: with the separate min-y block): the rows core of a layer's
    ``core_mode="rows"`` device plan (``chip_smoke.py`` phase 12)."""
    work = work or headline_workload()
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device,
                               core_mode="rows")
    groups = plan.groups
    return PairCell(name, "rows_vmem" if vmem else "rows", groups,
                    work["n"], plan.tile, walk=plan.core.walk,
                    ymin=lc.group_min_y(groups) if vmem else None)


def rows_column_cell(device, work=None, layers=16):
    """R16: the rows core of a layer's pack over the canonical column of
    ``layers`` layers (E x 16, ``make_batched_fn(core_mode="rows")``,
    ``chip_smoke.py`` phase 12)."""
    from ..parallel.lines import make_batched_fn

    work = work or headline_workload()
    fn = make_batched_fn(work["pack"], work["grid"], core_mode="rows",
                         device=device)
    t, p, vmr = canonical_layers(layers)
    _, core = fn.stage.assemble(*(torch.as_tensor(a, dtype=torch.float32,
                                                  device=device)
                                  for a in (t, p, vmr["H2O"])))
    return PairCell("R16", "rows", core, work["n"], fn.stage.tile,
                    walk=fn.core_plan.walk)


def build_cells(names, device, work=None):
    """The core cells ``names`` on ``device`` (one stacked pipeline per
    grid, shared by the cells on it; ``work``: the unit walk's layer, the
    headline layer by default)."""
    packs = wings_ab.column_packs() \
        if set(names) & {"A16", "A", "B", "F", "G"} else None
    grid = {k: np.arange(*v) for k, v in wings_ab.GRIDS.items()}
    layers = {"A16": ("A", slice(0, 16)), "A": ("A", slice(0, 2)),
              "B": ("B", [0, 5]), "F": ("F", slice(0, 4))}
    if set(names) & {"Cc", "Rc", "Rv", "R16", "Sc", "S16"}:
        work = work or headline_workload()
    cells = []
    for name in names:
        if name in layers:
            key, rows = layers[name]
            stage, _, core = wings_ab.stacked_stage(packs, grid[key], rows,
                                                    device)
            cells.append(CoreCell(name, stage.core_plan, core))
        elif name == "G":
            stage, _, core = wings_ab.shard_stage(packs, grid["A"], device)
            cells.append(CoreCell(name, stage.core_plan, core))
        elif name == "C":
            cells.append(layer_cell(name, device,
                                    np.arange(1.0, 5000.0, 0.1)))
        elif name == "D":
            cells.append(layer_cell(name, device,
                                    np.arange(1.0, 1000.0, 0.01)))
        elif name == "Cc":
            cells.append(corr_cell(device, work))
        elif name in ("Rc", "Rv"):
            cells.append(rows_layer_cell(name, device, name == "Rv", work))
        elif name == "R16":
            cells.append(rows_column_cell(device, work))
        elif name == "Sc":
            cells.append(seg_layer_cell(name, device, work,
                                        core_mode="seg"))
        elif name == "S16":
            cells.append(seg_column_cell(device, work))
        else:
            raise ValueError(f"unknown cell {name!r}")
    return cells


def describe(name, counts, params, nbytes):
    """The census's lines for one cell (``nbytes``: the bytes its pass
    must move)."""
    need = counts["needed"]
    total = counts["needed_total"]
    by_class = "/".join(str(counts["chunks_by_class"][k])
                        for k in CLASS_NAMES)
    ops41 = core_ops(params)
    bound, bound_by = census_bound(counts, nbytes)
    return "\n".join([
        f"{name}: {counts['chunks']} chunks (skip/K1/2/3/4 class "
        f"{by_class}), {counts['lane_evals']} lane evaluations, "
        f"{counts['in_window']} in-window points",
        f"  needed {total} ({total / max(counts['in_window'], 1):.4f} of "
        f"in-window): K1 {need['k1']}, r1 {need['r1']}, r2 {need['r2']}, "
        f"r3 {need['r3']}, CPF12 {need['cpf12_i']} (region I) + "
        f"{need['cpf12_ii']} (region II)",
        f"  instances {counts['instances']} with an in-window point, "
        f"{counts['instances_needing_nothing']} of them needing nothing; "
        "with a point of K1/r1/r2/r3/CPF12 "
        + "/".join(str(counts["instances_by_list"][k]) for k in LISTS),
        f"  rounds of 32 pairs {counts['rounds']}, lane-per-offset warp "
        f"iterations {counts['parent_warp_iterations']}",
        f"  census operations {census_ops(counts):.6e}, bound {bound:.6f} "
        f"ms ({bound_by}, {nbytes} bytes); core_ops {ops41:.6e}, bound "
        f"{max(ops41 / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3:.6f} ms"])


def describe_pair(name, counts, ops41, nbytes):
    """The unit walk's census lines for one cell (``ops41``: the
    41-operation count, ``nbytes``: the bytes its pass must move)."""
    need = counts["needed"]
    total = counts["needed_total"]
    by_class = "/".join(str(counts["items_by_class"][k])
                        for k in CLASS_NAMES)
    bound, bound_by = census_bound(counts, nbytes)
    return "\n".join([
        f"{name}: {counts['items']} items (skip/K1/2/3/4 class {by_class}), "
        f"{counts['pairs']} (item, point) pairs, {counts['in_window']} "
        "in-window points",
        f"  needed {total} ({total / max(counts['in_window'], 1):.4f} of "
        f"in-window): K1 {need['k1']}, r1 {need['r1']}, r2 {need['r2']}, "
        f"r3 {need['r3']}, CPF12 {need['cpf12_i']} (region I) + "
        f"{need['cpf12_ii']} (region II)",
        f"  items {counts['instances']} with an in-window point, "
        f"{counts['instances_needing_nothing']} of them needing nothing; "
        "with a point of K1/r1/r2/r3/CPF12 "
        + "/".join(str(counts["instances_by_list"][k]) for k in LISTS),
        f"  point groups classified {counts['visits']} ({counts['rows']} "
        f"with a needed point); lane-per-point evaluations "
        f"{counts['parent_lane_evals']}; needed points outside the need "
        f"window {counts['needed_outside']}",
        f"  census operations {census_ops(counts):.6e}, bound {bound:.6f} "
        f"ms ({bound_by}, {nbytes} bytes); 41-operation count "
        f"{ops41:.6e}, bound "
        f"{max(ops41 / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3:.6f} ms"])


def describe_cell(cell, counts):
    if isinstance(cell, PairCell):
        return describe_pair(cell.name, counts, cell.ops41, cell.nbytes)
    return describe(cell.name, counts, cell.params, cell.nbytes)


def run(cells=CELLS, device="cpu", out=None):
    report = {}
    for cell in build_cells(list(cells), torch.device(device)):
        counts = cell.census()
        counts["census_ops"] = census_ops(counts)
        counts["bound_ms"], counts["bound_by"] = census_bound(counts,
                                                              cell.nbytes)
        counts["ops41"] = cell.ops41
        report[cell.name] = counts
        print(describe_cell(cell, counts), flush=True)
    if out:
        Path(out).write_text(json.dumps(report, indent=1))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    return run_main("core_census", run, args.cells.split(","), args.device,
                    args.json)


if __name__ == "__main__":
    raise SystemExit(main())
