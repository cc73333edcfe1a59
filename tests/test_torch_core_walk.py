"""The mixed-slot core kernel's phases (csrc/lineshape.cu
``core_segmix_kernel``) on the CPU.

The kernel cannot run here, so its arithmetic is held through a model of
what its blocks compute, phase by phase:

- classify, lane = instance: the window as integer offset bounds, then
  each in-window offset's list (K1, or region 1, 2, 3, CPF12; every
  in-window offset of a non-finite prefactor in the full-correction list)
  or none;
- list the needed pairs by list, instance-major;
- evaluate each list through the plain correction functions
  (ops/voigt.py: the region bodies minus the Lorentzian, the K1 form, the
  whole class correction) into a zeroed [instance, offset] value block;
- sum in the one-block order: per slot, each warp group's live instances
  in order from +0.0, then ((g0 + g1) + g2) + g3 into the piece
  accumulator; an offset whose chunk sum went non-finite in one slot
  makes the other slots NaN there at the piece's end (the one-hot
  product's 0 * inf); the pieces fold in piece order.

The model equals ``core_tiles_plain`` bit for bit at pieces of 1, 2 and 4
on inputs made from a numpy seed with every class and region, and on a
real pipeline's; the plain version still matches the JAX
``_pallas_seg_pass_mixed`` in interpret mode on a class-4-heavy input at
the tolerance of tests/test_torch_lineshape.py
``test_segmix_core_matches_pallas`` (1e-6 of its scale).  The kernel
itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.ops import voigt
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn
from pylbl_tpu_torch.tools import core_census as cc
from pylbl_tpu_torch.tools import nonfinite as nf

torch.set_num_threads(1)
# The kernel's lists: K1 (class 1), regions 1, 2, 3 and CPF12, and the
# whole correction (kListK1, kListR1 + region, kListAny).
K1, R1, ANY = 0, 1, 5


def chunk_class(y):
    m = float(y.min())
    return 0 if m >= np.float32(70.55) else 1 if m >= np.float32(8.425) \
        else 2 if m >= np.float32(6.8) else 3 if m >= np.float32(2.0) else 4


def core_x(blk, i, o):
    """x of instances ``i`` at offsets ``o`` (tensors), float32."""
    return ((blk[lc.SR_SEG0REL, i] + o.to(blk.dtype)) - blk[lc.SR_CFRAC, i]) \
        * blk[lc.SR_SRW, i]


def classify(blk, cls, slots):
    """[128, 32] list of each pair (-1: none), as core_needs labels it."""
    lists = torch.full((128, 32), -1, dtype=torch.int64)
    o = torch.arange(32)
    for i in range(128):
        s, e = float(blk[lc.SR_SREL, i]), float(blk[lc.SR_EREL, i])
        slot = int(blk[lc.SR_SLOT, i])
        if not (e >= 0 and s <= 31) or not 0 <= slot < slots:
            continue
        o0, o1 = max(math.ceil(s), 0), min(math.floor(e), 31)
        if o0 > o1:
            continue
        win = (o >= o0) & (o <= o1)
        if not torch.isfinite(blk[lc.SR_PREF, i]):
            lists[i, win] = ANY
            continue
        y = blk[lc.SR_Y, i]
        if not bool(y < 70.55):
            continue
        x = core_x(blk, torch.full((32,), i), o)
        if cls == 1:
            lim = torch.clamp_min(15100.0 + y * (40.0 - y * 3.6), 0.0)
            lists[i, win & (x * x < lim)] = K1
            continue
        xlim0, xlim1, xlim2, xlim3, _, _ = voigt.region_limits(y)
        abx = x.abs()
        region = R1 + torch.where(
            abx >= xlim1, 0, torch.where(
                (cls == 2) | (abx >= xlim2), 1,
                torch.where((cls == 3) | (abx < xlim3), 2, 3)))
        need = win & (abx < xlim0)
        lists[i, need] = region[need]
    return lists


def list_value(x, y, cls, lst):
    """The correction of a pair of list ``lst`` by the plain functions."""
    if lst == ANY:
        return lc._CORE_CLASSES[cls - 1][1](x, y)
    if cls == 1:
        return voigt.voigt_correction_k1(x, y)
    xp = voigt._xp(x, y)
    abx = x.abs()
    xq = abx * abx
    yq = y * y
    if lst == R1:
        inner = voigt._w4_region1(xq, y, yq, xp)
    elif lst == R1 + 1:
        inner = voigt._w4_region2(xq, y, yq, xp)
    elif lst == R1 + 2:
        inner = voigt._w4_region3(xq, y, xp)
    else:
        inner = voigt._cpf12(x, xq, abx, y, 18.1 * y + 1.65, xp)
    return inner - voigt.voigt_lorentz(x, y)


def chunk_sums(blk, slots):
    """The chunk's [slots, 32] sums as the kernel's phases compute them,
    and its pair lists (for the tests' coverage checks)."""
    cls = chunk_class(blk[lc.SR_Y])
    sums = blk.new_zeros((slots, 32))
    if cls == 0:
        return sums, None, cls
    lists = classify(blk, cls, slots)
    val = blk.new_zeros((128, 32))
    for lst in range(ANY + 1):            # each list, instance-major
        i, o = torch.nonzero(lists == lst, as_tuple=True)
        if i.numel():
            v = list_value(core_x(blk, i, o), blk[lc.SR_Y, i], cls, lst)
            val[i, o] = blk[lc.SR_PREF, i] * v
    live = (lists >= 0).any(dim=1)
    slot = blk[lc.SR_SLOT].long()
    for s in range(slots):
        part = []
        for g in range(4):
            chain = blk.new_zeros(32)
            for j in range(32):
                i = 32 * g + j
                if live[i] and slot[i] == s:
                    chain = chain + val[i]
            part.append(chain)
        sums[s] = ((part[0] + part[1]) + part[2]) + part[3]
    return sums, lists, cls


def kernel_model(params, t_start, t_chunks, tile, piece):
    """[B, T, tile]: the chunk sums folded into each piece's accumulator
    in walk order, the pieces of ``piece`` chunks into the tile in piece
    order (a tile of one piece is that piece)."""
    slots = tile // 32
    out = params.new_zeros((params.shape[0], t_chunks.size, tile))
    seen = []
    for b in range(params.shape[0]):
        for t in range(t_chunks.size):
            n = int(t_chunks[t])
            pieces = []
            for k0 in range(0, max(n, 1), piece):
                acc = params.new_zeros((slots, 32))
                for k in range(k0, min(k0 + piece, n)):
                    col = (int(t_start[t]) + k) * 128
                    sums, lists, cls = chunk_sums(
                        params[b, :, col:col + 128], slots)
                    acc = acc + sums
                    seen.append((cls, lists))
                # core_spread: NaN where another slot's piece sum is not
                # finite.
                spread = ~torch.isfinite(acc)
                others = spread.sum(0) - spread.int() > 0
                acc = torch.where(others, acc + float("nan"), acc)
                pieces.append(acc.reshape(-1))
            tot = pieces[0]
            if len(pieces) > 1:
                tot = params.new_zeros(tile)
                for p in pieces:
                    tot = tot + p
            out[b, t] = tot
    return out, seen


@pytest.mark.parametrize("piece", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_model_equals_plain_on_every_class_and_region(seed, piece):
    """Every chunk class (a skipped chunk, K1, 2, 3, 4 with a tiny y),
    every list, dead instances and windows outside 0..31: the model equals
    the plain version bit for bit."""
    params, t_start, t_chunks, _ = cc.synthetic_core(seed)
    params = torch.as_tensor(params)
    tile = 256
    got, seen = kernel_model(params, t_start, t_chunks, tile, piece)
    want = lc.core_tiles_plain(params, torch.as_tensor(t_start),
                               torch.as_tensor(t_chunks), t_chunks.size,
                               tile, piece=piece)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())
    assert {cls for cls, _ in seen} == {0, 1, 2, 3, 4}
    for cls, want_lists in ((1, {K1}), (2, {R1, R1 + 1}),
                            (3, {R1, R1 + 1, R1 + 2}),
                            (4, {R1, R1 + 1, R1 + 2, R1 + 3})):
        lists = torch.cat([ls.reshape(-1) for c, ls in seen if c == cls])
        assert set(lists.unique().tolist()) - {-1} == want_lists
    assert int(t_chunks.max()) > piece             # a tile of pieces


def test_model_spreads_a_non_finite_prefactor_over_the_slots():
    """An instance of infinite prefactor: its in-window offsets take the
    whole correction (a skipped term would be NaN, not +0.0), so its slot's
    points of those offsets in its tile are not finite, and the tile's
    other slots are NaN at those offsets (the plain version's one-hot slot
    product, as JAX's, adds 0 * inf there: ``core_spread``); the model
    equals the plain version bit for bit, NaN for NaN, and every other
    point the plain version without the instance."""
    params, t_start, t_chunks, _ = cc.synthetic_core(4, layers=1)
    params = torch.as_tensor(params)
    col = int(t_start[2]) * 128 + 40              # tile 2's first chunk
    assert chunk_class(params[0, lc.SR_Y, col - 40:col + 88]) > 0
    params[0, lc.SR_PREF, col] = float("inf")
    params[0, lc.SR_SREL, col] = 3.0
    params[0, lc.SR_EREL, col] = 9.0
    got, _ = kernel_model(params, t_start, t_chunks, 256, 1)
    gone = params.clone()
    gone[0, lc.SR_PREF, col] = 0.0
    want = lc.core_tiles_plain(gone, torch.as_tensor(t_start),
                               torch.as_tensor(t_chunks), t_chunks.size,
                               256, piece=1)
    bad = torch.zeros_like(got, dtype=torch.bool)
    for slot in range(8):
        bad[0, 2, 32 * slot + 3:32 * slot + 10] = True
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.equal(got[~bad], want[~bad])
    plain = lc.core_tiles_plain(params, torch.as_tensor(t_start),
                                torch.as_tensor(t_chunks), t_chunks.size,
                                256, piece=1)
    nan = torch.isnan(plain)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], plain[~nan])


@pytest.mark.parametrize("piece", [1, 2, 4])
def test_model_equals_plain_on_a_pipeline(piece):
    """A real stacked pipeline's core (two gases, two layers, a dense
    cluster of lines, tile 256): bit for bit."""
    packs = {"H2O": synthetic_line_pack("H2O", num_lines=1500, nu_min=30.0,
                                        nu_max=33.0, seed=31,
                                        band_centers=(31.5,)),
             "CO2": synthetic_line_pack("CO2", num_lines=200, nu_min=1.0,
                                        nu_max=60.0, seed=22,
                                        band_centers=(20.0,))}
    fn = make_multigas_batched_fn(packs, np.arange(1.0, 60.0, 0.1), tile=256,
                                  chunk=128, device="cpu")
    _, core = fn.assemble(np.asarray([288.99, 227.74]),
                          np.asarray([98388.0, 1032.0]),
                          np.asarray([[6.6e-03, 3.6e-04], [4.8e-06,
                                                           3.6e-04]]))
    plan = fn.core_plan
    assert int(plan.t_chunks.max()) > piece
    got, _ = kernel_model(core, plan.t_start, plan.t_chunks, 256, piece)
    want = lc.core_tiles_plain(core, torch.as_tensor(plan.t_start),
                               torch.as_tensor(plan.t_chunks),
                               plan.t_chunks.size, 256, piece=piece)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("tiles,chunks,want", [
    (100, 5, 1),                                  # D-like: 500 blocks
    (lc.CORE_WAVE_BLOCKS, 1, 1),                  # exactly one wave
    (lc.CORE_WAVE_BLOCKS + 1, 1, lc.PIECE_CHUNKS),
    (lc.CORE_WAVE_BLOCKS + 1, 0, lc.PIECE_CHUNKS),  # empty tiles count
    (50, 47, lc.PIECE_CHUNKS),                    # C-like: 2350 blocks
])
def test_core_piece_size_follows_the_walk(tiles, chunks, want):
    """core_piece_chunks: one chunk a piece where one layer's walk at one
    chunk a block fits one wave of the card (an empty tile is a block),
    else PIECE_CHUNKS; [B, T] counts decide by their most, as the pieces
    split."""
    counts = np.full(tiles, chunks)
    assert lc.core_piece_chunks(counts) == want
    layered = torch.as_tensor(np.stack([counts // 2, counts]))
    assert lc.TilePieces.of_core(layered).piece == want


def test_plan_core_pass_folds_in_its_pieces():
    """A stacked pipeline's core plan takes core_piece_chunks' pieces, and
    its pass (the plain version on the CPU), the plain pass and the
    defaults of core_segmix_pass / core_segmix_plain fold in them."""
    packs = {"H2O": synthetic_line_pack("H2O", num_lines=1500, nu_min=30.0,
                                        nu_max=33.0, seed=31,
                                        band_centers=(31.5,))}
    fn = make_multigas_batched_fn(packs, np.arange(1.0, 60.0, 0.1), tile=256,
                                  chunk=128, device="cpu")
    _, core = fn.assemble(np.asarray([288.99, 227.74]),
                          np.asarray([98388.0, 1032.0]),
                          np.asarray([[6.6e-03], [4.8e-06]]))
    plan = fn.core_plan
    assert plan.pieces.piece == lc.core_piece_chunks(plan.t_chunks) == 1
    assert int(plan.t_chunks.max()) > 1               # a split tile
    t_start = torch.as_tensor(plan.t_start)
    t_chunks = torch.as_tensor(plan.t_chunks)
    tiles = lc.core_tiles_plain(core, t_start, t_chunks, plan.t_chunks.size,
                                256, piece=plan.pieces.piece)
    want = tiles.reshape(2, -1)[:, :plan.num_points]
    assert float(want.abs().max()) > 0
    for got in (fn.core_pass(core), fn.core_pass(core, plain=True),
                lc.core_segmix_pass(core, t_start, t_chunks,
                                    plan.num_points, 256),
                lc.core_segmix_plain(core, t_start, t_chunks,
                                     plan.num_points, 256)):
        assert torch.equal(got, want)


def test_plain_matches_pallas_on_a_class4_heavy_input():
    """The plain version (unchanged by the redesign) against
    ``_pallas_seg_pass_mixed`` in interpret mode, class-4 chunks (CPF12
    and region 3 among their points) beside a K1 one: within 1e-6 of the
    scale, as ``test_segmix_core_matches_pallas``."""
    params, t_start, t_chunks, num_points = cc.synthetic_core(
        5, tile=256, tile_chunks=(4, 1, 5), classes=(4, 4, 4, 1))
    counts = cc.census(torch.as_tensor(params), t_start, t_chunks)
    assert counts["chunks_by_class"]["c4"] > counts["chunks"] / 2
    assert counts["needed"]["cpf12_i"] and counts["needed"]["r3"]
    got = lc.core_segmix_plain(torch.as_tensor(params),
                               torch.as_tensor(t_start),
                               torch.as_tensor(t_chunks), num_points,
                               256).numpy()
    want = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(params), t_start, t_chunks, num_points, 256, 128,
        interpret=True))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


@pytest.mark.parametrize("layers", [1, 2])
def test_model_equals_plain_on_poisoned_lines(layers):
    """The mixed-slot core's poisoned input (``nonfinite.family_case``: an
    infinite and a NaN prefactor, a NaN y, y = 0 at x = 0, instances in
    slots drawn from the seed), one layer and two: the model, with its
    spread of a slot's non-finite sums over the other slots, equals the
    plain version bit for bit, NaN for NaN."""
    case = nf.family_case("segmix", layers)
    params = torch.as_tensor(case.inputs["params"]).reshape(
        layers, lc.SEGP_ROWS, -1)
    t_start, t_chunks = case.inputs["csr"]
    got, _ = kernel_model(params, t_start, t_chunks, 256,
                          lc.core_piece_chunks(t_chunks))
    want = case.plain().reshape(layers, -1)
    got = got.reshape(layers, -1)[:, :want.shape[-1]]
    nan = torch.isnan(want)
    assert bool(nan.any()) and bool(torch.isfinite(want).any())
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
