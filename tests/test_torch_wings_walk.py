"""The wings kernel's walk (csrc/lineshape.cu lorentz_walk_kernel) on the CPU.

The kernel cannot run here, so its host inputs and its arithmetic are
held through models of what its blocks compute, for each of its line
kinds: the prepacked Lorentzian (PRE: the stacked strided, tail and splat
layouts), the raw Lorentzian (RAW: the splat of a "seg" core plan, whose
rows stay raw) and the ownership-checked raw Lorentzian (OWN: a straddle
CSR, neighbouring tiles reading shared chunks):

- the walk: every block (piece, layer) finds its tile, its piece and its
  chunks from the piece list (:class:`TilePieces`) and the chunk CSRs, as
  the kernel does; the walk covers every (layer, tile, chunk, line) once,
  in walk order, and names the chunks the plain version sums;
- the warp lists: a warp of 32 lanes owns 32 * points consecutive points,
  skips a line whose window misses them, drops the window mask for a line
  whose window holds them all, and keeps the per-group test and the mask
  for the rest; RAW and OWN form each line's y^2 and pref*y/sqrt(pi)
  first, and OWN leaves out the foreign lines whose terms are all +/-0.0
  (``own_drops``).  The model sums in that way and equals the plain
  partials bit for bit (a skipped line adds +/-0.0; no sum holds -0.0),
  and keeps a foreign line that gives the plain version's NaN;
- the plain version at any piece size against the Pallas kernels in
  interpret mode (``_pallas_pass_strided``, ``_pallas_pass_batched``) at
  rel < 5e-6 of tests/test_lineshape_pallas.py.

The kernel itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn
from pylbl_tpu_torch.tools import layer_workload

torch.set_num_threads(1)

T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04], [4.2e-06, 3.9e-04]])
# Grid steps at which a stride fits each tile's windows (the strided
# layouts), and at which none does (the splat).
STRIDED_STEP = {256: 0.5, 512: 0.2, 1024: 0.2}
SPLAT_STEP = {256: 0.2, 512: 0.05, 1024: 0.02}
# The walk's line kind of each layout: the stacked pipeline's prepacked
# rows, its raw splat rows under a "seg" core plan, the straddle CSR of
# the ownership-checked wings.
KIND = {"strided": "pre", "tail": "pre", "splat": "pre", "raw_splat": "raw",
        "straddle": "own"}
F32 = torch.finfo(torch.float32)


def dense_packs():
    """4000 H2O lines within 100-103 cm-1 beside a sparse CO2 pack: tiles
    of many chunks (several pieces) next to tiles of none."""
    return {
        "H2O": synthetic_line_pack("H2O", num_lines=4000, nu_min=100.0,
                                   nu_max=103.0, seed=31,
                                   band_centers=(101.5,)),
        "CO2": synthetic_line_pack("CO2", num_lines=200, nu_min=0.6,
                                   nu_max=260.0, seed=22,
                                   band_centers=(60.0, 200.0)),
    }


def stage_of(layout, tile):
    """(stage, SoA) of a small stacked pipeline: "strided", "tail" (the
    strided layout with the tail class), "splat" or "raw_splat" (the
    splat of a "seg" core plan, raw rows); or "straddle"
    (:func:`straddle_stage`)."""
    if layout == "straddle":
        return straddle_stage(tile)
    splat = layout in ("splat", "raw_splat")
    step = (SPLAT_STEP if splat else STRIDED_STEP)[tile]
    tail = 128 if layout == "tail" else None
    core_mode = "seg" if layout == "raw_splat" else None
    fn = make_multigas_batched_fn(dense_packs(), np.arange(1.0, 220.0, step),
                                  tile=tile, chunk=128, wings_tail=tail,
                                  core_mode=core_mode, device="cpu")
    stage = fn.stage
    assert (stage.wings_stride is None) == splat
    assert stage.prepacked == (layout != "raw_splat")
    assert (len(stage.csr) == 4) == (layout == "tail")
    soa, _ = fn.assemble(T, P, VMR)
    return stage, soa


def straddle_stage(tile):
    """The ownership-checked wings' inputs on the dense packs' H2O lines
    over two layers: raw rows with each line's tile in _PAD (-1 for pad
    lines) and the straddle CSR ([T], both layers; chunks of 128 lines, so
    that a tile walks many) at the stride that fits the windows, as the
    ``stage_of`` stages carry them."""
    pack = dense_packs()["H2O"]
    grid = np.arange(1.0, 220.0, STRIDED_STEP[tile])
    works = [layer_workload(pack, grid, (T[b], P[b], VMR[b, 0]))
             for b in range(2)]
    arrays = {k: np.stack([w["arrays"][k] for w in works])
              for k in works[0]["arrays"]}
    soa, num = lc.pack_lines_soa(arrays, 512)
    s = arrays["s_idx"].min(axis=0).astype(np.int64)
    e = arrays["e_idx"].max(axis=0).astype(np.int64)
    n = works[0]["n"]
    stride = lc.pick_wings_stride(tile, int((e - s).max()) + 1)
    assert stride is not None
    assign = np.clip(s, 0, None) // stride
    soa[:, lc._PAD, :num] = assign.astype(np.float32)
    soa[:, lc._PAD, num:] = -1.0
    csr = lc.strided_line_ranges(assign, (n - 1) // stride + 1, chunk=128)
    stage = SimpleNamespace(csr=list(csr), wings_chunk=128,
                            wings_tail=None, wings_stride=stride, tile=tile,
                            n_out=n)
    return stage, torch.as_tensor(soa)


def per_layer(csr, layers):
    """[B, T] rows of a [T] CSR that differ by layer: layer b walks b
    chunks fewer of every tile's main class (never below 0)."""
    w_start, w_n, *rest = (np.asarray(a, np.int64) for a in csr)
    w_n = np.stack([np.maximum(w_n - b, 0) for b in range(layers)])
    out = [np.broadcast_to(w_start, w_n.shape).copy(), w_n]
    for a in rest:
        out.append(np.broadcast_to(a, w_n.shape).copy())
    return out


def kernel_walk(pieces, csr, chunk, tail, layers):
    """[(layer, block, tile, k, first line, width)] in launch order, each
    block's chunks computed as lorentz_walk_kernel computes them."""
    w_start, w_n = csr[0], csr[1]
    t_start, t_n = (csr[2], csr[3]) if len(csr) == 4 else (None, None)

    def row(a, b):
        return a[b] if a.ndim == 2 else a

    walk = []
    for b in range(layers):
        for x in range(pieces.num_pieces):
            t = int(pieces.tile[x])
            piece = x - int(pieces.first[t])
            n_main = int(row(w_n, b)[t])
            n_walk = n_main + (0 if t_n is None else int(row(t_n, b)[t]))
            k0 = piece * pieces.piece
            for k in range(k0, min(k0 + pieces.piece, n_walk)):
                if k < n_main:
                    first, width = int(row(w_start, b)[t]) + k * chunk, chunk
                else:
                    first = int(row(t_start, b)[t]) + (k - n_main) * tail
                    width = tail
                walk.append((b, x, t, k, first, width))
    return walk


@pytest.mark.parametrize("csr_kind", ["shared", "per_layer"])
@pytest.mark.parametrize("layout", ["strided", "tail", "splat", "raw_splat",
                                    "straddle"])
@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_walk_covers_every_chunk_line_once_in_order(tile, layout, csr_kind):
    """Every (layer, tile, chunk, line) of the CSR once, each tile's chunks
    in walk order (main, then tail) across its pieces in piece order,
    pieces of at most WINGS_PIECE_CHUNKS chunks, an empty piece only for
    a tile that walks nothing; and the chunks are those the plain version
    sums (``_chunk_pairs``).  Every line kind walks its chunks so: PRE
    (strided, tail, splat), RAW (raw_splat) and OWN (straddle, where
    neighbouring tiles walk shared chunks)."""
    stage, soa = stage_of(layout, tile)
    layers = soa.shape[0]
    csr = [np.asarray(a, np.int64) for a in stage.csr]
    if csr_kind == "per_layer":
        csr = per_layer(csr, layers)
    chunk, tail = stage.wings_chunk, stage.wings_tail or 128
    pieces = lc.TilePieces.of_csr(*csr[1::2])
    assert pieces.piece == lc.WINGS_PIECE_CHUNKS
    counts = sum(csr[1::2])
    counts = np.broadcast_to(counts, (layers, counts.shape[-1]))
    assert counts.max() > 2 * pieces.piece   # some tile takes 3+ pieces
    walk = kernel_walk(pieces, csr, chunk, tail, layers)
    seen = {}
    for b, x, t, k, first, width in walk:
        seen.setdefault((b, t), []).append((k, first, width))
    for b in range(layers):
        for t in range(counts.shape[1]):
            got = seen.get((b, t), [])
            assert [k for k, _, _ in got] == list(range(counts[b, t]))
            lines = np.concatenate([np.arange(f, f + w) for _, f, w in got]
                                   or [np.zeros(0, np.int64)])
            assert lines.size == np.unique(lines).size
            assert lines.size == sum(w for _, _, w in got)
            blocks = [x for bb, x, tt, *_ in walk if (bb, tt) == (b, t)]
            assert blocks == sorted(blocks)
            assert len(set(blocks)) == -(-counts[b, t] // pieces.piece)
    # The plain version's chunk pairs: the same chunks per layer.
    for b in range(layers):
        rows = [torch.as_tensor(a[b] if a.ndim == 2 else a) for a in csr]
        zero = torch.zeros(rows[0].numel(), dtype=torch.int64)
        tiles, line0, seq = lc._chunk_pairs(rows[0], rows[1], chunk, zero,
                                            "cpu")
        pairs = set(zip(tiles.tolist(), seq.tolist(), line0.tolist()))
        if len(rows) == 4:
            tt, tl, ts = lc._chunk_pairs(rows[2], rows[3], tail, rows[1],
                                         "cpu")
            pairs |= set(zip(tt.tolist(), ts.tolist(), tl.tolist()))
        assert pairs == {(t, k, f) for bb, _, t, k, f, _ in walk if bb == b}


def own_drops(v, tile_f):
    """csrc/lineshape.cu ``own_drops`` on lines ``v`` [B, 8, P, 1] for
    tiles ``tile_f``: a foreign line whose every term (0 * y / sqrt(pi)) *
    rcp(x^2 + y^2) is +/-0.0, y^2 finite and normal and x never NaN."""
    ysq = v[:, lc.Y] * v[:, lc.Y]
    return ((v[:, lc._PAD] != tile_f) & (ysq >= F32.tiny) & (ysq <= F32.max)
            & (v[:, lc.C_INT].abs() <= F32.max)
            & (v[:, lc.C_FRAC].abs() <= F32.max)
            & (v[:, lc.SRW].abs() <= F32.max) & (v[:, lc.SRW] != 0))


def raw_line(v, tile_f, kind):
    """csrc/lineshape.cu ``raw_line``: (y^2, pref*y/sqrt(pi)) of lines
    ``v`` from their raw rows, the strength of OWN's foreign lines zeroed;
    the prepacked rows as they are for PRE."""
    if kind == "pre":
        return v[:, lc.Y], v[:, lc.PREF]
    y, strength = v[:, lc.Y], v[:, lc.PREF]
    if kind == "own":
        strength = torch.where(v[:, lc._PAD] == tile_f, strength,
                               torch.zeros_like(strength))
    return y * y, (strength * y) * lc.RSQRPI


def warp_walk_partials(soa, tiles, line0, width, tile, stride, points,
                       kind="pre"):
    """The kernel's per-chunk partials [B, P, tile] for (tile, chunk)
    pairs, summed as its warps sum them: warp w owns the points
    w*32*points .. of the tile; per line in order it skips a line whose
    window misses them (OWN also a foreign line ``own_drops`` leaves
    out), adds the unmasked term where the window holds them all, and
    else tests each group of 32 points and adds the masked term
    (``kind``'s Lorentzian, as ``_tile_partials_plain``)."""
    span = 32 * points
    batch = soa.shape[0]
    offs = torch.arange(tile)
    point = (tiles[:, None] * stride + offs[None, :]).to(soa.dtype)
    tile_f = tiles[:, None].to(soa.dtype)
    warp_lo = point[:, ::span]                         # [P, warps]
    group_lo = point[:, ::32]                          # [P, groups]
    part = soa.new_zeros((batch, tiles.numel(), tile))
    for j in range(width):
        v = soa[:, :, line0 + j, None]                 # [B, 8, P, 1]
        ws, we = v[:, lc.S_IDX], v[:, lc.E_IDX]
        x = ((point - v[:, lc.C_INT]) - v[:, lc.C_FRAC]) * v[:, lc.SRW]
        ysq, pref_y = raw_line(v, tile_f, kind)
        val = pref_y * (1.0 / (x * x + ysq))
        meet = ~((we < warp_lo) | (ws > warp_lo + (span - 1)))
        if kind == "own":
            meet = meet & ~own_drops(v, tile_f)
        full = (ws <= warp_lo) & (we >= warp_lo + (span - 1))
        group = ~((we < group_lo) | (ws > group_lo + 31))
        meet = meet.repeat_interleave(span, dim=-1)
        full = full.repeat_interleave(span, dim=-1)
        group = group.repeat_interleave(32, dim=-1)
        inside = (point >= ws) & (point <= we)
        masked = part + torch.where(inside, val, torch.zeros_like(val))
        term = torch.where(full, part + val, masked)
        part = torch.where(meet & (full | group), term, part)
    return part


@pytest.mark.parametrize("points", [4, 8])
@pytest.mark.parametrize("layout,tile", [("tail", 512), ("strided", 1024),
                                          ("strided", 256), ("splat", 256),
                                          ("splat", 1024),
                                          ("raw_splat", 256),
                                          ("raw_splat", 1024),
                                          ("straddle", 256),
                                          ("straddle", 1024)])
def test_warp_lists_equal_plain_partials(layout, tile, points):
    """The warp-list sum equals the plain partials bit for bit on every
    chunk the walk visits, with lines whose windows start and end inside a
    warp's points, warps wholly inside a window and wholly outside, and
    the dead lines of padded chunks; for each line kind (``KIND``), OWN
    with the foreign lines of the shared chunks that it leaves out."""
    kind = KIND[layout]
    stage, soa = stage_of(layout, tile)
    stride = stage.wings_stride or tile
    csr = [torch.as_tensor(a) for a in stage.csr]
    zero = torch.zeros(csr[0].numel(), dtype=torch.int64)
    span = 32 * points
    edges = pads = dropped = 0
    # Each chunk class: the main chunks, then the tail chunks.
    for start, count, width in ((csr[0], csr[1], stage.wings_chunk),
                                (*csr[2:], stage.wings_tail or 128)):
        tiles, line0, _ = lc._chunk_pairs(start, count, width, zero, "cpu")
        want = lc._tile_partials_plain(soa, tiles, line0, width, tile,
                                       stride, kind)
        got = warp_walk_partials(soa, tiles, line0, width, tile, stride,
                                 points, kind)
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
        lines = line0[:, None] + torch.arange(width)
        ws, we = soa[:, lc.S_IDX, lines], soa[:, lc.E_IDX, lines]
        lo = (tiles * stride).to(soa.dtype)[:, None]
        # Windows that start or end inside a warp's points.
        edges += int((((ws > lo) & (ws < lo + tile - 1) & (ws % span != 0))
                      | ((we > lo) & (we < lo + tile - 1)
                         & ((we + 1) % span != 0))).sum())
        # Padding: dead lines (empty windows) on the splat, zero-strength
        # copies of a line on the strided layouts.
        pads += int(((we < ws) | (soa[:, lc.PREF, lines] == 0)).sum())
        if kind == "own":
            v = soa[:, :, lines]                       # [B, 8, P, width]
            dropped += int((own_drops(v, lo) & (we >= lo)
                            & (ws <= lo + tile - 1)).sum())
        if len(csr) == 2:
            break
    assert edges > 0 and (pads > 0 or kind == "own")
    assert (dropped > 0) == (kind == "own")


def hand_case(kind):
    """One tile of 256 points (tile 1 of stride 256), 4 points a lane (two
    warps of 128): lines holding every point, none, windows ending and
    starting inside a warp and on its edges, a zero-strength line and a
    dead line, in ``kind``'s rows (y = 0.9); OWN's lines alternate between
    this tile and tile 0.  Returns (soa [1, 8, n], tiles, line0, n)."""
    windows = [(0, 255), (300, 400), (-50, 10), (127, 128), (128, 255),
               (5, 126), (40, 40), (0, 127), (-1, -2), (200, 1000)]
    n = len(windows)
    soa = torch.zeros((1, 8, n))
    soa[0, lc.C_INT] = torch.tensor([356.0 + 13 * i for i in range(n)])
    soa[0, lc.C_FRAC] = 0.25
    soa[0, lc.SRW] = 0.37
    soa[0, lc.Y] = 0.81 if kind == "pre" else 0.9
    soa[0, lc.PREF] = torch.tensor([0.0 if i == 6 else 1.0 + i
                                    for i in range(n)])
    soa[0, lc.S_IDX] = torch.tensor([256.0 + s for s, _ in windows])
    soa[0, lc.E_IDX] = torch.tensor([256.0 + e for _, e in windows])
    soa[0, lc.S_IDX, 8], soa[0, lc.E_IDX, 8] = -1.0, -2.0      # dead
    soa[0, lc._PAD] = torch.tensor([1.0 - i % 2 for i in range(n)])
    return soa, torch.tensor([1]), torch.tensor([0]), n


@pytest.mark.parametrize("kind", ["pre", "raw", "own"])
def test_warp_lists_hand_cases(kind):
    """The hand case (:func:`hand_case`): the warp-list sum equals the
    plain partial bit for bit and never holds -0.0; OWN leaves out the
    foreign lines, and the owned ones alone give its sum."""
    soa, tiles, line0, n = hand_case(kind)
    want = lc._tile_partials_plain(soa, tiles, line0, n, 256, 256, kind)
    got = warp_walk_partials(soa, tiles, line0, n, 256, 256, 4, kind)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got).any())          # never -0.0
    if kind == "own":
        v = soa[:, :, line0[:, None] + torch.arange(n)]
        assert int(own_drops(v, tiles[:, None].float()).sum()) == n // 2
        owned = soa.clone()
        owned[0, lc.PREF, 1::2] = 0.0
        raw = lc._tile_partials_plain(owned, tiles, line0, n, 256, 256,
                                      "raw")
        assert torch.equal(got, raw)


def same_bits(got, want):
    """NaN where ``want`` is NaN, and the same bits everywhere else."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32),
        torch.where(nan, 0.0, want).view(torch.int32))


def test_own_keeps_a_foreign_line_that_gives_nan():
    """Foreign lines that OWN cannot leave out: y = 0 with its center on a
    point of the tile (0 * rcp(0) is NaN there), and y = 1e-20, whose y^2
    is finite and > 0 but subnormal (rcp(y^2) overflows to inf at x = 0).
    The model keeps both at strength 0 and gives the plain version's NaN
    at those points and its bits elsewhere; a foreign y = 0 line whose
    center lies off the tile's points adds +0.0 and drops nothing."""
    soa, tiles, line0, n = hand_case("own")
    soa[0, lc.C_FRAC] = 0.0
    soa[0, lc.C_INT, 7], soa[0, lc.Y, 7] = 260.0, 0.0     # foreign, x = 0
    soa[0, lc.C_INT, 3], soa[0, lc.Y, 3] = 383.0, 1e-20   # foreign, x = 0
    soa[0, lc.C_INT, 5], soa[0, lc.Y, 5] = 100.5, 0.0     # foreign, x != 0
    v = soa[:, :, line0[:, None] + torch.arange(n)]
    drops = own_drops(v, tiles[:, None].float())[0, 0]
    assert not bool(drops[[3, 5, 7]].any()) and bool(drops[[1, 9]].all())
    want = lc._tile_partials_plain(soa, tiles, line0, n, 256, 256, "own")
    got = warp_walk_partials(soa, tiles, line0, n, 256, 256, 4, "own")
    nan = torch.nonzero(torch.isnan(want[0, 0])).flatten().tolist()
    assert nan == [4, 127]
    assert same_bits(got, want)
    # Left out anyway, the two lines would lose the NaN.
    kept = soa.clone()
    kept[0, lc.Y, [3, 7]] = 0.5
    assert not bool(torch.isnan(warp_walk_partials(
        kept, tiles, line0, n, 256, 256, 4, "own")).any())


def test_own_model_drops_foreign_lines_in_every_chunk():
    """A synthetic straddle CSR where every chunk holds lines of two or
    more tiles (20 lines a tile, chunks of 32, stride 256, tile 1024):
    each tile reads chunks of foreign lines, the model leaves some of them
    out in every (tile, chunk) it visits, and equals the plain "own"
    partials bit for bit."""
    rng = np.random.default_rng(5)
    tile, stride, chunk, num_tiles, per = 1024, 256, 32, 8, 20
    assign = np.repeat(np.arange(num_tiles), per)
    total = -(-assign.size // chunk) * chunk
    soa = np.zeros((2, 8, total), np.float32)
    for b in range(2):
        center = assign * stride + rng.integers(-100, tile + 100, assign.size)
        soa[b, lc.C_INT, :assign.size] = center
        soa[b, lc.C_FRAC, :assign.size] = rng.random(assign.size)
        soa[b, lc.SRW, :assign.size] = rng.uniform(0.02, 0.6, assign.size)
        soa[b, lc.Y, :assign.size] = rng.uniform(0.05, 3.0, assign.size)
        soa[b, lc.PREF, :assign.size] = rng.uniform(0.1, 3.0, assign.size)
        soa[b, lc.S_IDX, :assign.size] = center - rng.choice([5, 90, 700],
                                                             assign.size)
        soa[b, lc.E_IDX, :assign.size] = center + rng.choice([5, 90, 700],
                                                             assign.size)
    soa[:, lc._PAD, :assign.size] = assign
    soa[:, lc.S_IDX, assign.size:], soa[:, lc.E_IDX, assign.size:] = -1, -2
    soa[:, lc._PAD, assign.size:] = -1.0
    start, count = (torch.as_tensor(a) for a in
                    lc.strided_line_ranges(assign, num_tiles, chunk))
    soa = torch.as_tensor(soa)
    zero = torch.zeros(num_tiles, dtype=torch.int64)
    tiles, line0, _ = lc._chunk_pairs(start, count, chunk, zero, "cpu")
    v = soa[:, :, line0[:, None] + torch.arange(chunk)]   # [B, 8, P, chunk]
    tile_f = tiles[:, None].float()
    point_lo = (tiles * stride).float()[:, None]
    reach = (v[:, lc.E_IDX] >= point_lo) & (v[:, lc.S_IDX]
                                            <= point_lo + tile - 1)
    foreign = v[:, lc._PAD] != tile_f
    assert bool(foreign.any(dim=-1).all())
    assert bool((own_drops(v, tile_f) & reach).any(dim=-1).all())
    want = lc._tile_partials_plain(soa, tiles, line0, chunk, tile, stride,
                                   "own")
    got = warp_walk_partials(soa, tiles, line0, chunk, tile, stride, 4,
                             "own")
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


def dense_stage(layout):
    return stage_of(layout, 512 if layout == "tail" else 256)


@pytest.mark.parametrize("piece", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["tail", "splat", "raw_splat",
                                    "straddle"])
def test_plain_at_piece_size_matches_pallas(layout, piece):
    """The plain version folding pieces of ``piece`` chunks (the kernel's
    walk at that piece size: 1 is ``WINGS_PIECE_CHUNKS``, 4 the earlier
    one) against ``_pallas_pass_strided`` (the strided tail layout; the
    straddle CSR with ``prepacked=False``, OWN) and
    ``_pallas_pass_batched`` with the prepacked line function (the splat)
    or the raw one (the raw splat, RAW), rel < 5e-6 with the 1e-7 * max
    floor."""
    stage, soa = dense_stage(layout)
    csr = stage.csr
    assert int(sum(np.asarray(c) for c in csr[1::2]).max()) > 2 * piece
    n = stage.n_out
    if layout == "straddle":
        got = lc.wings_strided_checked_plain(soa, *csr, n, stage.tile,
                                             stage.wings_stride,
                                             stage.wings_chunk, piece=piece)
        want = jlp._pallas_pass_strided(
            jnp.asarray(soa.numpy()), csr[0], csr[1], n, stage.tile,
            stage.wings_stride, chunk=stage.wings_chunk, interpret=True)
    elif layout == "tail":
        got = lc.wings_strided_plain(soa, *csr[:2], n, stage.tile,
                                     stage.wings_stride, stage.wings_chunk,
                                     *csr[2:], tail=128, piece=piece)
        want = jlp._pallas_pass_strided(
            jnp.asarray(soa.numpy()), csr[0], csr[1], n, stage.tile,
            stage.wings_stride, chunk=stage.wings_chunk, interpret=True,
            prepacked=True, t_start=csr[2], t_n=csr[3], tail=128)
    else:
        kind = "wings_pre" if layout == "splat" else "wings"
        got = lc.tile_plain(soa, *csr, n, stage.tile, stage.wings_chunk,
                            kind, piece=piece)
        batch = soa.shape[0]
        want = jlp._pallas_pass_batched(
            jnp.asarray(soa.numpy()),
            np.broadcast_to(csr[0], (batch,) + csr[0].shape),
            np.broadcast_to(csr[1], (batch,) + csr[1].shape), n, stage.tile,
            stage.wings_chunk, kind, interpret=True)
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want),
                                          np.abs(want).max() * 1e-7)
    assert float(rel.max()) < 5e-6


def test_reciprocal_term_matches_lorentz_line_pre():
    """The walk's term, pref_y * (1 / (x^2 + y^2)) (the kernel's IEEE
    reciprocal and product), summed over a chunk against the JAX
    package's ``_lorentz_line_pre`` (its quotient) in line order, rel <
    5e-6 with the 1e-7 * max floor; with windows that start and end
    inside the tile, on its first and last points, hold all of it or
    miss it, and a dead line."""
    rng = np.random.default_rng(12)
    tile, n = 512, 64
    center = rng.uniform(-200.0, 700.0, n).round()
    ws = center - rng.choice([5, 40, 300, 900], n)
    we = center + rng.choice([5, 40, 300, 900], n)
    ws[:4], we[:4] = [0, 100, -10, 600], [511, 100, 0, 700]
    ws[4], we[4] = -1.0, -2.0                           # dead
    rows = np.zeros((1, 8, n), np.float32)
    rows[0, lc.C_INT] = center
    rows[0, lc.C_FRAC] = rng.random(n)
    rows[0, lc.SRW] = rng.uniform(0.02, 0.6, n)
    rows[0, lc.Y] = rng.uniform(1e-3, 9.0, n)           # y^2
    rows[0, lc.PREF] = np.where(np.arange(n) == 4, 0.0,
                                rng.uniform(0.1, 3.0, n))
    rows[0, lc.S_IDX], rows[0, lc.E_IDX] = ws, we
    got = lc._tile_partials_plain(torch.as_tensor(rows), torch.tensor([0]),
                                  torch.tensor([0]), n, tile, tile,
                                  "pre")[0, 0].numpy()
    point = jnp.arange(tile, dtype=jnp.float32)
    acc = jnp.zeros(tile, jnp.float32)
    for j in range(n):
        c_int, c_frac, srw, ysq, pref, s, e = (
            jnp.float32(rows[0, r, j]) for r in (
                lc.C_INT, lc.C_FRAC, lc.SRW, lc.Y, lc.PREF, lc.S_IDX,
                lc.E_IDX))
        acc = jlp._lorentz_line_pre(point, c_int, c_frac, srw, ysq, pref, s,
                                    e, acc)
    want = np.asarray(acc, np.float64)
    assert want.max() > 0
    rel = np.abs(got - want) / np.maximum(np.abs(want), want.max() * 1e-7)
    assert float(rel.max()) < 5e-6


def test_reciprocal_term_matches_lorentz_line():
    """The raw walk's term, ((pref * y) / sqrt(pi)) * (1 / (x^2 + y^2))
    (its prologue from the raw rows, then the kernel's IEEE reciprocal and
    product), summed over a chunk against the JAX package's
    ``_lorentz_line`` (its quotient) in line order, rel < 5e-6 with the
    1e-7 * max floor; with windows that start and end inside the tile, on
    its first and last points, hold all of it or miss it, and a dead line.
    OWN on lines that the tile owns gives the same sum bit for bit."""
    rng = np.random.default_rng(13)
    tile, n = 512, 64
    center = rng.uniform(-200.0, 700.0, n).round()
    ws = center - rng.choice([5, 40, 300, 900], n)
    we = center + rng.choice([5, 40, 300, 900], n)
    ws[:4], we[:4] = [0, 100, -10, 600], [511, 100, 0, 700]
    ws[4], we[4] = -1.0, -2.0                           # dead
    rows = np.zeros((1, 8, n), np.float32)
    rows[0, lc.C_INT] = center
    rows[0, lc.C_FRAC] = rng.random(n)
    rows[0, lc.SRW] = rng.uniform(0.02, 0.6, n)
    rows[0, lc.Y] = rng.uniform(0.03, 3.0, n)           # y
    rows[0, lc.PREF] = np.where(np.arange(n) == 4, 0.0,
                                rng.uniform(0.1, 3.0, n))
    rows[0, lc.S_IDX], rows[0, lc.E_IDX] = ws, we
    got = lc._tile_partials_plain(torch.as_tensor(rows), torch.tensor([0]),
                                  torch.tensor([0]), n, tile, tile,
                                  "raw")[0, 0]
    own = lc._tile_partials_plain(torch.as_tensor(rows), torch.tensor([0]),
                                  torch.tensor([0]), n, tile, tile,
                                  "own")[0, 0]
    assert torch.equal(own, got)                        # _PAD 0: owned
    point = jnp.arange(tile, dtype=jnp.float32)
    acc = jnp.zeros(tile, jnp.float32)
    for j in range(n):
        c_int, c_frac, srw, y, pref, s, e = (
            jnp.float32(rows[0, r, j]) for r in (
                lc.C_INT, lc.C_FRAC, lc.SRW, lc.Y, lc.PREF, lc.S_IDX,
                lc.E_IDX))
        acc = jlp._lorentz_line(point, c_int, c_frac, srw, y, pref, s, e,
                                acc)
    want = np.asarray(acc, np.float64)
    got = got.numpy()
    assert want.max() > 0
    rel = np.abs(got - want) / np.maximum(np.abs(want), want.max() * 1e-7)
    assert float(rel.max()) < 5e-6
