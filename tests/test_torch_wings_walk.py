"""The wings kernel's walk (csrc/lineshape.cu lorentz_walk_kernel) on the CPU.

The kernel cannot run here, so its host inputs and its arithmetic are
held through models of what its blocks compute:

- the walk: every block (piece, layer) finds its tile, its piece and its
  chunks from the piece list (:class:`TilePieces`) and the chunk CSRs, as
  the kernel does; the walk covers every (layer, tile, chunk, line) once,
  in walk order, and names the chunks the plain version sums;
- the warp lists: a warp of 32 lanes owns 32 * points consecutive points,
  skips a line whose window misses them, drops the window mask for a line
  whose window holds them all, and keeps the per-group test and the mask
  for the rest.  The model sums in that way and equals the plain
  partials bit for bit (a skipped line adds +0.0; no sum holds -0.0);
- the plain version at any piece size against the Pallas kernels in
  interpret mode (``_pallas_pass_strided``, ``_pallas_pass_batched``) at
  rel < 5e-6 of tests/test_lineshape_pallas.py.

The kernel itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn

torch.set_num_threads(1)

T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04], [4.2e-06, 3.9e-04]])
# Grid steps at which a stride fits each tile's windows (the strided
# layouts), and at which none does (the splat).
STRIDED_STEP = {256: 0.5, 512: 0.2, 1024: 0.2}
SPLAT_STEP = {256: 0.2, 512: 0.05, 1024: 0.02}


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
    strided layout with the tail class) or "splat"."""
    step = (SPLAT_STEP if layout == "splat" else STRIDED_STEP)[tile]
    tail = 128 if layout == "tail" else None
    fn = make_multigas_batched_fn(dense_packs(), np.arange(1.0, 220.0, step),
                                  tile=tile, chunk=128, wings_tail=tail,
                                  device="cpu")
    stage = fn.stage
    assert (stage.wings_stride is None) == (layout == "splat")
    assert (len(stage.csr) == 4) == (layout == "tail")
    soa, _ = fn.assemble(T, P, VMR)
    return stage, soa


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
@pytest.mark.parametrize("layout", ["strided", "tail", "splat"])
@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_walk_covers_every_chunk_line_once_in_order(tile, layout, csr_kind):
    """Every (layer, tile, chunk, line) of the CSR once, each tile's chunks
    in walk order (main, then tail) across its pieces in piece order,
    pieces of at most WINGS_PIECE_CHUNKS chunks, an empty piece only for
    a tile that walks nothing; and the chunks are those the plain version
    sums (``_chunk_pairs``)."""
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


def warp_walk_partials(soa, tiles, line0, width, tile, stride, points):
    """The kernel's per-chunk partials [B, P, tile] for (tile, chunk)
    pairs, summed as its warps sum them: warp w owns the points
    w*32*points .. of the tile; per line in order it skips a line whose
    window misses them, adds the unmasked term where the window holds them
    all, and else tests each group of 32 points and adds the masked term
    (the prepacked Lorentzian, as ``_tile_partials_plain``)."""
    span = 32 * points
    batch = soa.shape[0]
    offs = torch.arange(tile)
    point = (tiles[:, None] * stride + offs[None, :]).to(soa.dtype)
    warp_lo = point[:, ::span]                         # [P, warps]
    group_lo = point[:, ::32]                          # [P, groups]
    part = soa.new_zeros((batch, tiles.numel(), tile))
    for j in range(width):
        v = soa[:, :, line0 + j, None]                 # [B, 8, P, 1]
        ws, we = v[:, lc.S_IDX], v[:, lc.E_IDX]
        x = ((point - v[:, lc.C_INT]) - v[:, lc.C_FRAC]) * v[:, lc.SRW]
        val = v[:, lc.PREF] * (1.0 / (x * x + v[:, lc.Y]))
        meet = ~((we < warp_lo) | (ws > warp_lo + (span - 1)))
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
                                          ("splat", 1024)])
def test_warp_lists_equal_plain_partials(layout, tile, points):
    """The warp-list sum equals the plain partials bit for bit on every
    chunk the walk visits, with lines whose windows start and end inside a
    warp's points, warps wholly inside a window and wholly outside, and
    the dead lines of padded chunks."""
    stage, soa = stage_of(layout, tile)
    stride = stage.wings_stride or tile
    csr = [torch.as_tensor(a) for a in stage.csr]
    zero = torch.zeros(csr[0].numel(), dtype=torch.int64)
    span = 32 * points
    edges = pads = 0
    # Each chunk class: the main chunks, then the tail chunks.
    for start, count, width in ((csr[0], csr[1], stage.wings_chunk),
                                (*csr[2:], stage.wings_tail or 128)):
        tiles, line0, _ = lc._chunk_pairs(start, count, width, zero, "cpu")
        want = lc._tile_partials_plain(soa, tiles, line0, width, tile,
                                       stride, "pre")
        got = warp_walk_partials(soa, tiles, line0, width, tile, stride,
                                 points)
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
        if len(csr) == 2:
            break
    assert edges > 0 and pads > 0


def test_warp_lists_hand_cases():
    """One tile of 256 points, 4 points a lane (two warps of 128): lines
    holding every point, none, windows ending and starting inside a warp
    and on its edges, a zero-strength line and a dead line: the warp-list
    sum equals the plain partial bit for bit."""
    windows = [(0, 255), (300, 400), (-50, 10), (127, 128), (128, 255),
               (5, 126), (40, 40), (0, 127), (-1, -2), (200, 1000)]
    n = len(windows)
    soa = torch.zeros((1, 8, n))
    soa[0, lc.C_INT] = torch.tensor([100.0 + 13 * i for i in range(n)])
    soa[0, lc.C_FRAC] = 0.25
    soa[0, lc.SRW] = 0.37
    soa[0, lc.Y] = 0.81
    soa[0, lc.PREF] = torch.tensor([0.0 if i == 6 else 1.0 + i
                                    for i in range(n)])
    soa[0, lc.S_IDX] = torch.tensor([float(s) for s, _ in windows])
    soa[0, lc.E_IDX] = torch.tensor([float(e) for _, e in windows])
    tiles = torch.tensor([0])
    line0 = torch.tensor([0])
    want = lc._tile_partials_plain(soa, tiles, line0, n, 256, 256, "pre")
    got = warp_walk_partials(soa, tiles, line0, n, 256, 256, 4)
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got).any())          # never -0.0


def dense_stage(layout):
    return stage_of(layout, 512 if layout == "tail" else 256)


@pytest.mark.parametrize("piece", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["tail", "splat"])
def test_plain_at_piece_size_matches_pallas(layout, piece):
    """The plain version folding pieces of ``piece`` chunks (the kernel's
    walk at that piece size: 1 is ``WINGS_PIECE_CHUNKS``, 4 the earlier
    one) against ``_pallas_pass_strided`` (the strided
    tail layout) and ``_pallas_pass_batched`` with the prepacked line
    function (the splat), rel < 5e-6 with the 1e-7 * max floor."""
    stage, soa = dense_stage(layout)
    csr = stage.csr
    assert int(sum(np.asarray(c) for c in csr[1::2]).max()) > 2 * piece
    n = stage.n_out
    if layout == "tail":
        got = lc.wings_strided_plain(soa, *csr[:2], n, stage.tile,
                                     stage.wings_stride, stage.wings_chunk,
                                     *csr[2:], tail=128, piece=piece)
        want = jlp._pallas_pass_strided(
            jnp.asarray(soa.numpy()), csr[0], csr[1], n, stage.tile,
            stage.wings_stride, chunk=stage.wings_chunk, interpret=True,
            prepacked=True, t_start=csr[2], t_n=csr[3], tail=128)
    else:
        got = lc.tile_plain(soa, *csr, n, stage.tile, stage.wings_chunk,
                            "wings_pre", piece=piece)
        batch = soa.shape[0]
        want = jlp._pallas_pass_batched(
            jnp.asarray(soa.numpy()),
            np.broadcast_to(csr[0], (batch,) + csr[0].shape),
            np.broadcast_to(csr[1], (batch,) + csr[1].shape), n, stage.tile,
            stage.wings_chunk, "wings_pre", interpret=True)
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
