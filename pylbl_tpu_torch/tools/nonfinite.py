"""Poisoned inputs for every kernel family: lines with non-finite values.

:func:`family_case` makes one family's input from a numpy seed
(``core_census.synthetic_lines``; ``synthetic_segment`` for the segment
and mixed-slot passes), poisons a few lines in every layer
(:data:`POISONS`) and packs them as the family's plans pack their lines.
The CSRs and plans come from the clean windows, as a host plan built
before the values went bad would.  Its ``run()`` calls the kernel's
wrapper and ``plain()`` the plain version: on CPU tensors both are the
plain version, on the card ``chip_smoke.py`` holds each kernel to its
plain version bit for bit.  :func:`nan_y_corr` and :func:`nan_y_rows`
are the inputs on which CORR and the rows core once skipped a NaN y that
the JAX conds send to the whole correction.  The port's tests hold the
plain versions against the JAX Pallas kernels on the same inputs
(tests/test_torch_nonfinite.py).
"""
import numpy as np
import torch

from ..ops import lineshape_cuda as lc
from . import core_census as cc

RSQRPI = np.float32(1.0 / np.sqrt(np.pi))
NUM_LINES = 300
# (field, value) of each poisoned line, in turn: a prefactor of +inf, -inf
# and NaN, a NaN y (finite prefactor), a NaN y with an infinite
# prefactor, y = 0 at x = 0, a NaN srw, a NaN window start and end.
POISONS = ((("prefactor", np.inf),), (("prefactor", -np.inf),),
           (("prefactor", np.nan),), (("y", np.nan),),
           (("y", np.nan), ("prefactor", np.inf)),
           (("y", 0.0), ("c_frac", 0.0)), (("scaled_repwid", np.nan),),
           (("s_idx", np.nan),), (("e_idx", np.nan),))
# Family -> the launch counter of one layer and of a layer batch.
FAMILIES = {
    "pre_strided": ("wings_strided_single", "wings_strided"),
    "pre_strided_tail": ("wings_strided_tail_single", "wings_strided"),
    "pre_splat": ("wings_splat", "wings_splat"),
    "raw": ("tile_lorentz", "tile_lorentz"),
    "own": ("wings_strided_checked_single", "wings_strided_checked"),
    "corr": ("tile_correction", "tile_correction"),
    "rows": ("core_rows_single", "core_rows"),
    "rows_vmem": ("core_rows_vmem", "core_rows_vmem"),
    "segmix": ("core_segmix_single", "core_segmix"),
    "seg_core": ("seg_core", "seg_core"),
    "seg_wings": ("seg_wings", "seg_wings"),
}
# (family, layers) of every kernel wrapper's launch, each counter at least
# once.
KERNEL_CASES = (("pre_strided", 1), ("pre_strided", 2),
                ("pre_strided_tail", 1), ("pre_strided_tail", 2),
                ("pre_splat", 1), ("pre_splat", 2), ("raw", 1), ("raw", 2),
                ("own", 1), ("own", 2), ("corr", 1), ("corr", 2),
                ("rows", 1), ("rows", 2), ("rows_vmem", 1),
                ("segmix", 1), ("segmix", 2), ("seg_core", 2),
                ("seg_wings", 2))


def poisoned_lines(seed, num_points, layers, poison=True):
    """Kernel arrays of :data:`NUM_LINES` lines over ``num_points`` points
    ([N] or [B, N]; windows as float32 so that they can hold NaN) and the
    clean integer windows (s, e); with ``poison`` each of :data:`POISONS`
    on its own line of y in (0.5, 8) and a window of at most 100 points
    inside the grid, spread over the grid, in every layer."""
    arrays = cc.synthetic_lines(seed, NUM_LINES, num_points, layers)
    s = np.atleast_2d(arrays["s_idx"])[0].astype(np.int64)
    e = np.atleast_2d(arrays["e_idx"])[0].astype(np.int64)
    out = {k: np.array(v, np.float32) if k in ("s_idx", "e_idx")
           else np.array(v) for k, v in arrays.items()}
    if poison:
        y0 = np.atleast_2d(arrays["y"])[0]
        ok = np.nonzero((s >= 0) & (e < num_points) & (e - s <= 100)
                        & (y0 > 0.5) & (y0 < 8.0))[0]
        pick = ok[np.linspace(0, ok.size - 1, len(POISONS)).round()
                  .astype(np.int64)]
        if np.unique(pick).size != len(POISONS):
            raise ValueError("too few lines to poison")
        for i, changes in zip(pick, POISONS):
            for field, value in changes:
                out[field][..., i] = value
    return out, s, e


def prepacked(soa):
    """The prepacked rows of a raw SoA (Y: y^2, PREF: pref*y/sqrt(pi)),
    in float32 as the pipeline forms them."""
    soa = soa.copy()
    y = soa[..., lc.Y, :]
    soa[..., lc.PREF, :] = soa[..., lc.PREF, :] * y * RSQRPI
    soa[..., lc.Y, :] = y * y
    return soa


def strided_soa(arrays, lay):
    """The prepacked SoA of a :class:`StridedLayout`, dead slots with no
    strength and an empty window."""
    rows = lc.pack_lines_soa({k: v[..., lay.idx] for k, v in
                              arrays.items()}, 1)[0]
    for row, fill in ((lc.PREF, 0.0), (lc.S_IDX, -1.0), (lc.E_IDX, -2.0)):
        rows[..., row, :] = np.where(lay.dead, fill, rows[..., row, :])
    return prepacked(rows)


def _clean_core_windows(seed, num_points, layers, s, e):
    clean = poisoned_lines(seed, num_points, layers, False)[0]
    clean["s_idx"], clean["e_idx"] = s, e
    return cc.synthetic_core_windows(clean), clean["y"]


class Case:
    """One family's input: ``inputs`` the numpy arrays and sizes (what the
    JAX launchers take), ``counter`` the launch counter of its kernel,
    ``run()`` the kernel's wrapper and ``plain()`` the plain version on
    the case's device."""

    def __init__(self, family, layers, inputs, run, plain):
        self.family = family
        self.layers = layers
        self.counter = FAMILIES[family][layers > 1]
        self.inputs = inputs
        self.run = run
        self.plain = plain


def family_case(family, layers=1, device="cpu", poison=True, seed=3):
    """:class:`Case` of ``family`` (a key of :data:`FAMILIES`) over
    ``layers`` layers on ``device``: PRE strided (with the tail class:
    ``pre_strided_tail``) and OWN at tile 1024 over 2048 points, the splat
    families (PRE, RAW, CORR) at tile 256 over 1280 points in chunks of
    64, the rows core (``rows_vmem``: the class from the separate min-y
    block) at tile 256 over 1024 points, each with :data:`POISONS`; the
    segment passes and the mixed-slot core on ``synthetic_segment``'s
    input (an infinite and a NaN prefactor, a NaN y, y = 0 at x = 0, in
    the wings a NaN window start; the mixed-slot core's instances in
    slots drawn from ``seed``)."""
    if family in ("pre_strided", "pre_strided_tail", "own"):
        n, tile = 2048, 1024
        arrays, s, e = poisoned_lines(seed, n, layers, poison)
        stride = lc.pick_wings_stride(tile, int((e - s).max()) + 1)
        if family == "own":
            soa, num = lc.pack_lines_soa(arrays, 128)
            assign = np.clip(s, 0, None) // stride
            soa[..., lc._PAD, :num] = assign.astype(np.float32)
            soa[..., lc._PAD, num:] = -1.0
            csr = lc.strided_line_ranges(assign, (n - 1) // stride + 1,
                                         chunk=128)
            data, st, nc = _on(device, soa, *csr)
            args = (data, st, nc, n, tile, stride, 128)
            return Case(family, layers, dict(
                soa=soa, csr=csr, n=n, tile=tile, stride=stride, chunk=128),
                lambda: lc.wings_strided_checked_pass(*args),
                lambda: lc.wings_strided_checked_plain(*args))
        tail = 128 if family == "pre_strided_tail" else None
        lay = lc.build_strided_layout(s, stride, n, chunk=256, e_wide=e,
                                      tile=tile, tail=tail)
        soa = strided_soa(arrays, lay)
        data, ws, wn, ts, tn = _on(device, soa, lay.w_start, lay.w_n,
                                   lay.t_start, lay.t_n)
        args = (data, ws, wn, n, tile, stride, 256, ts, tn)
        return Case(family, layers, dict(
            soa=soa, csr=(lay.w_start, lay.w_n), tail_csr=(lay.t_start,
                                                           lay.t_n),
            n=n, tile=tile, stride=stride, chunk=256),
            lambda: lc.wings_strided_pass(*args),
            lambda: lc.wings_strided_plain(*args))
    if family in ("pre_splat", "raw", "corr"):
        n, tile, chunk = 1280, 256, 64
        arrays, s, e = poisoned_lines(seed, n, layers, poison)
        if family == "corr":
            (s, e), _ = _clean_core_windows(seed, n, layers, s, e)
        soa = lc.pack_lines_soa(arrays, chunk)[0]
        if family == "pre_splat":
            soa = prepacked(soa)
        return _tile_case(family, layers, soa,
                          lc.tile_line_ranges(s, e, n, tile, chunk), n, tile,
                          chunk, device)
    if family in ("rows", "rows_vmem"):
        n, tile = 1024, 256
        arrays, s, e = poisoned_lines(seed, n, layers, poison)
        (cs, ce), y = _clean_core_windows(seed, n, layers, s, e)
        plan = lc.CorePlan(cs, ce, n, tile, sort_key=np.atleast_2d(y)[0],
                           mode="rows")
        groups = plan.gather(arrays)
        return _rows_case(family, layers, groups, plan.walk, n, tile,
                          device)
    if family in ("segmix", "seg_core", "seg_wings"):
        tile = 256
        kind = "wings" if family == "seg_wings" else "core"
        params, t_start, t_chunks, c_slot, n = cc.synthetic_segment(
            seed, kind, layers, tile=tile, odd=poison)
        if layers == 1:
            params = params[0]
        if family == "segmix":
            params[..., lc.SR_SLOT, :] = np.random.default_rng(seed).integers(
                0, tile // lc.SEG, params.shape[-1])
            p, ts, tc = _on(device, params, t_start, t_chunks)
            args = (p, ts, tc, n, tile)
            return Case(family, layers, dict(
                params=params, csr=(t_start, t_chunks), n=n, tile=tile),
                lambda: lc.core_segmix_pass(*args),
                lambda: lc.core_segmix_plain(*args))
        streams = lc.SegStreams(t_start, t_chunks, c_slot, tile // lc.SEG)
        (p,) = _on(device, params)
        return Case(family, layers, dict(
            params=params, csr=(t_start, t_chunks, c_slot), n=n, tile=tile),
            lambda: lc.seg_pass(p, streams, n, tile, kind=kind),
            lambda: lc.seg_plain(p, *streams.tensors(p.device)[3:], n,
                                 tile, kind=kind))
    raise ValueError(f"unknown kernel family {family!r}")


def _on(device, *arrays):
    return [None if a is None else torch.as_tensor(a, device=device)
            for a in arrays]


def _tile_case(family, layers, soa, csr, n, tile, chunk, device):
    """:class:`Case` of a tile pass (PRE splat, RAW, CORR)."""
    kind = {"pre_splat": "wings_pre", "raw": "wings", "corr": "core"}[family]
    args = (*_on(device, soa, *csr), n, tile, chunk, kind)
    return Case(family, layers, dict(soa=soa, csr=csr, n=n, tile=tile,
                                     chunk=chunk, kind=kind),
                lambda: lc.tile_pass(*args), lambda: lc.tile_plain(*args))


def _rows_case(family, layers, groups, walk, n, tile, device):
    """:class:`Case` of the rows core (``rows_vmem``: with the separate
    min-y block)."""
    ymin = lc.group_min_y(groups) if family == "rows_vmem" else None
    g, y = _on(device, groups, ymin)
    g_start, g_n = walk.tensors(g.device)

    def run():
        if y is None:
            return lc.rows_pass(g, walk, n, tile)
        return lc.rows_vmem_pass(g, y, walk, n, tile)

    return Case(family, layers, dict(
        groups=groups, ymin=ymin,
        csr=tuple(a.astype(np.int32) for a in (walk.g_start, walk.g_n)),
        n=n, tile=tile, chunk=walk.chunk), run,
        lambda: lc.rows_plain(g, g_start, g_n, n, tile, walk.chunk, y))


def nan_y_corr(layers=1, device="cpu"):
    """:class:`Case` of CORR on ``synthetic_corr``'s class-4-heavy input
    (seed 5, tile 256, 3 tiles, 300 lines, chunks of 64) with a NaN y and
    an infinite prefactor on the first line of tile 1's walk with 0.5 < y
    < 8, in every layer: JAX's conds take the whole correction there,
    correction(x, NaN) is 0, and so the line's window is NaN."""
    soa, start, nchunks, n = cc.synthetic_corr(
        5, layers=layers, tile=256, num_tiles=3, num_lines=300, chunk=64,
        shares=(0.05, 0.05, 0.05, 0.05, 0.8))
    line0 = int(start[1])
    y = np.atleast_2d(soa[..., lc.Y, :].reshape(layers, -1))[0]
    i = line0 + int(np.nonzero((y[line0:line0 + 64] > 0.5)
                               & (y[line0:line0 + 64] < 8.0))[0][0])
    soa[..., lc.Y, i] = np.nan
    soa[..., lc.PREF, i] = np.inf
    return _tile_case("corr", layers, soa, (start, nchunks), n, 256, 64,
                      device)


def nan_y_rows(layers=1, device="cpu", vmem=False):
    """:class:`Case` of the rows core (``vmem``: with the separate min-y
    block) on ``synthetic_rows``' class-4-heavy input (seed 6, tile 256, 3
    tiles, 250 lines) with slot 0's y NaN in the first group of 2 < min y
    < 8, its min y (row 56) NaN with it, in every layer: JAX's conds take
    the whole correction for the group, each other instance its own."""
    groups, plan, n = cc.synthetic_rows(
        6, layers=layers, tile=256, num_tiles=3, num_lines=250,
        shares=(0.05, 0.05, 0.05, 0.05, 0.8))
    ym = np.atleast_2d(groups[..., lc.YMIN_ROW, :].reshape(layers, -1))[0]
    col = int(np.nonzero((ym > 2.0) & (ym < 8.0))[0][0])
    groups[..., 3 * 8 + 0, col] = np.nan
    groups[..., lc.YMIN_ROW, col] = np.nan
    return _rows_case("rows_vmem" if vmem else "rows", layers, groups,
                      plan.walk, n, 256, device)
