"""The segment pass's chunk kernels (csrc/lineshape.cu ``seg_core_kernel``
and ``seg_wings_kernel``) on the CPU.

The kernels cannot run here, so their arithmetic is held through a model
of what their blocks and warps compute, phase by phase:

- the segment core, per entry of the stream-ordered chunk list: the class
  from the chunk's min y (NaN if a y is, as the plain version's amin and
  jnp.min, which fails every test of the JAX conds and takes class 4, the
  whole correction); classify, lane = instance: the window as integer
  offset bounds, then each in-window offset's list (K1, or region 1, 2, 3,
  CPF12; every in-window offset of a non-finite prefactor in the
  full-correction list) or none; evaluate each list through the plain
  correction functions (ops/voigt.py) into a zeroed [instance, offset]
  value block; sum slot 0: warp group g adds its live instances in order
  from +0.0, and the chunk sum is ((g0 + g1) + g2) + g3;
- the segment wings, per entry: per group of 32 instances y^2 and
  pref*y/sqrt(pi) prepacked in the plain version's float32 order, each
  window's lanes as a bit mask (``seg_lane_mask``: ceil(ws - lo) ..
  floor(we - lo), equal to the point-by-point window test), a ballot of
  the instances whose window reaches the segment, those walked in order
  (all 32 unrolled where all reach), each term the IEEE quotient kept
  where its lane bit is set; the chunk sum is ((w0 + w1) + w2) + w3 over
  the groups;
- the fold: each (tile, slot) stream adds its entries' sums in walk
  order from +0.0.

The model equals ``seg_tiles_plain`` (through ``seg_plain``) bit for bit,
NaN where it is NaN, on inputs made from a numpy seed with every class and
region, non-finite prefactors, a NaN y, y = 0 at x = 0, dead instances
and empty streams, at tiles 256 and 1024, one layer and a batch, and on
real plans' parameters; the plain version still matches the JAX
``_pallas_seg_pass`` in interpret mode on a class-4-heavy input at the
tolerance of tests/test_torch_lineshape.py ``test_seg_pass_matches_pallas``,
and on the inputs with non-finite values too (NaN and infinities where
JAX's are), as the mixed-slot plain version matches
``_pallas_seg_pass_mixed`` there.
The kernels themselves are held to the plain version bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.ops import voigt
from pylbl_tpu_torch.tools import (CUT_OFF, headline_pack, layer_workload,
                                   seg_bytes, seg_wings_evals)
from pylbl_tpu_torch.tools.core_census import synthetic_segment
from pylbl_tpu_torch.utils.constants import RSQRPI

torch.set_num_threads(1)
# The kernel's lists: K1 (class 1), regions 1, 2, 3 and CPF12, and the
# whole correction (kListK1, kListR1 + region, kListAny).
K1, R1, ANY = 0, 1, 5


def chunk_class(y):
    """chunk_class of the chunk's min y: >= 70.55 is 0; a NaN min (a NaN
    y) fails every test and is 4, as in the JAX conds."""
    m = float(y.min())
    return 0 if m >= np.float32(70.55) else 1 if m >= np.float32(8.425) \
        else 2 if m >= np.float32(6.8) else 3 if m >= np.float32(2.0) else 4


def core_x(blk, i, o):
    """x of instances ``i`` at offsets ``o`` (tensors), float32."""
    return ((blk[lc.SR_SEG0REL, i] + o.to(blk.dtype)) - blk[lc.SR_CFRAC, i]) \
        * blk[lc.SR_SRW, i]


def classify(blk, cls):
    """[128, 32] list of each pair (-1: none), as core_needs labels it in
    the one slot of a segment chunk."""
    lists = torch.full((128, 32), -1, dtype=torch.int64)
    o = torch.arange(32)
    for i in range(128):
        s, e = float(blk[lc.SR_SREL, i]), float(blk[lc.SR_EREL, i])
        if not (e >= 0 and s <= 31):
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


def core_chunk_sum(blk, seen):
    """The segment core's [32] sum of one chunk [8, 128], phase by phase;
    appends (class, lists) to ``seen``."""
    cls = chunk_class(blk[lc.SR_Y])
    if cls == 0:
        seen.append((0, None))
        return blk.new_zeros(32)
    lists = classify(blk, cls)
    seen.append((cls, lists))
    val = blk.new_zeros((128, 32))
    for lst in range(ANY + 1):            # each list, instance-major
        i, o = torch.nonzero(lists == lst, as_tuple=True)
        if i.numel():
            v = list_value(core_x(blk, i, o), blk[lc.SR_Y, i], cls, lst)
            val[i, o] = blk[lc.SR_PREF, i] * v
    live = (lists >= 0).any(dim=1)
    groups = []
    for g in range(4):
        chain = blk.new_zeros(32)
        for j in range(32):
            if live[32 * g + j]:
                chain = chain + val[32 * g + j]
        groups.append(chain)
    return ((groups[0] + groups[1]) + groups[2]) + groups[3]


def lane_mask(ws, we, lo):
    """csrc ``seg_lane_mask``: the lanes l in ceil(ws - lo) ..
    floor(we - lo) within 0..31, as bits (float32 differences)."""
    a = float(np.ceil(np.float32(ws) - np.float32(lo)))
    b = float(np.floor(np.float32(we) - np.float32(lo)))
    if not (a <= b and b >= 0.0 and a <= 31.0):
        return 0
    ia, ib = int(max(a, 0.0)), int(min(b, 31.0))
    return ((0xffffffff >> (31 - ib)) & (0xffffffff << ia)) & 0xffffffff


def wings_chunk_sum(blk, lo, seen):
    """The segment wings' [32] sum of one chunk [8, 128] of raw rows on
    the segment lo .. lo + 31, warp by group; appends each group's
    (reaching instances, edge instances: a mask of some lanes) to
    ``seen``.  Each lane mask equals the window test point by point."""
    point = lo + torch.arange(32).to(blk.dtype)
    hi = lo + 31.0
    bits = 1 << torch.arange(32, dtype=torch.int64)
    total = None
    for w in range(4):
        g = blk[:, 32 * w:32 * w + 32]
        ws, we = g[lc.S_IDX], g[lc.E_IDX]
        meet = ~((we < lo) | (ws > hi))
        pref_y = (g[lc.PREF] * g[lc.Y]) * RSQRPI
        ysq = g[lc.Y] * g[lc.Y]
        masks = [lane_mask(ws[i], we[i], lo) for i in range(32)]
        for i in range(32):
            inside = (point >= ws[i]) & (point <= we[i])
            assert torch.equal((masks[i] & bits) != 0, inside)
        seen.append((int(meet.sum()), sum(0 < m < 0xffffffff
                                          for m in masks)))
        part = blk.new_zeros(32)
        for i in torch.nonzero(meet).flatten().tolist():
            x = ((point - g[lc.C_INT, i]) - g[lc.C_FRAC, i]) * g[lc.SRW, i]
            val = pref_y[i] / (x * x + ysq[i])
            keep = (masks[i] & bits) != 0
            part = part + torch.where(keep, val, torch.zeros_like(val))
        total = part if w == 0 else total + part
    return total


def kernel_model(kind, params, streams, num_points, tile):
    """[B, num_points]: each entry's chunk sum on its own, each stream's
    entries folded in walk order from +0.0; and what the phases saw."""
    batch = params.shape[0]
    out = params.new_zeros((batch, streams.num_streams, 32))
    seen = []
    for b in range(batch):
        for s in range(streams.num_streams):
            acc = params.new_zeros(32)
            for e in range(streams.ptr[s], streams.ptr[s + 1]):
                col = int(streams.chunk[e]) * 128
                blk = params[b, :, col:col + 128]
                if kind == "core":
                    acc = acc + core_chunk_sum(blk, seen)
                else:
                    acc = acc + wings_chunk_sum(blk, float(32 * s), seen)
            out[b, s] = acc
    return out.reshape(batch, -1)[:, :num_points], seen


def nan_equal(got, want):
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) \
        and torch.equal(got[~nan], want[~nan])


def synthetic(kind, tile, batched, **kwargs):
    """A synthetic segment input, its chunks in 4 slots of their tile
    (streams of several chunks at tile 1024 too)."""
    params, t_start, t_chunks, c_slot, n = synthetic_segment(
        kind=kind, tile=tile, slots_used=4, **kwargs)
    params = torch.as_tensor(params if batched else params[:1])
    streams = lc.SegStreams(t_start, t_chunks, c_slot, tile // 32)
    return params, streams, n


def plain(kind, params, streams, n, tile):
    return lc.seg_plain(params, *streams.tensors("cpu")[3:], n, tile,
                        kind=kind)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("seed,classes", [(0, (0, 1, 2, 3, 4)),
                                          (5, (4, 4, 4, 1))])
def test_core_model_equals_plain_on_every_class_and_region(seed, classes,
                                                           tile, batched):
    """Every chunk class (a skipped chunk, K1, 2, 3, 4 with a tiny y; or
    class-4-heavy), every list, dead instances, windows outside 0..31, an
    infinite and a NaN prefactor (the whole correction: not finite), y = 0
    at x = 0 (NaN), a NaN y (its chunk takes class 4, the instance itself
    adds nothing), streams of several chunks and empty ones: the model
    equals the plain version bit for bit, NaN where it is NaN."""
    params, streams, n = synthetic("core", tile, batched, seed=seed,
                                   classes=classes)
    got, seen = kernel_model("core", params, streams, n, tile)
    want = plain("core", params, streams, n, tile)
    assert got.shape == want.shape == (params.shape[0], n)
    assert nan_equal(got, want)
    finite = torch.isfinite(want)
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())
    assert float(want[finite].abs().max()) > 0
    assert not bool(torch.signbit(got[got == 0]).any())
    assert set(classes) <= {cls for cls, _ in seen}
    lists = torch.cat([ls.reshape(-1) for c, ls in seen if c == 4])
    assert {R1, R1 + 1, R1 + 2, R1 + 3, ANY} <= set(lists.unique().tolist())
    per = np.diff(streams.ptr)
    assert per.max() > 1 and (per == 0).any()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("tile", [256, 1024])
def test_wings_model_equals_plain(tile, batched):
    """Windows that hold the segment, end inside it or miss it (never
    loaded), empty ones, dead instances, an infinite and a NaN prefactor,
    a NaN y, a NaN window start, y = 0 at x = 0 (0/0: NaN in its window):
    the model equals the plain version bit for bit, NaN where it is NaN;
    every lane mask equals the window test; groups that all reach the
    segment and groups that do not, edge instances among them."""
    params, streams, n = synthetic("wings", tile, batched, seed=1)
    got, seen = kernel_model("wings", params, streams, n, tile)
    want = plain("wings", params, streams, n, tile)
    assert nan_equal(got, want)
    assert bool(torch.isnan(want).any())
    assert float(want[torch.isfinite(want)].abs().max()) > 0
    assert {m == 32 for m, _ in seen} == {True, False}
    assert sum(e for _, e in seen) > 0


@pytest.mark.parametrize("lo", [0.0, 32.0, 4096.0, 16777184.0])
def test_lane_mask_equals_the_window_test_at_the_edges(lo):
    """``seg_lane_mask`` against the point-by-point window test on
    windows whose edges lie on, inside, just beside and far from the
    segment, fractional, infinite and NaN ones."""
    point = (np.float32(lo) + np.arange(32, dtype=np.float32))
    edges = [lo + d for d in (-40.0, -1.5, -1.0, -0.5, 0.0, 0.25, 1.0, 15.5,
                              30.0, 31.0, 31.5, 32.0, 60.0)]
    edges += [-1e30, 1e30, float("inf"), -float("inf"), float("nan")]
    for ws in edges:
        for we in edges:
            s, e = np.float32(ws), np.float32(we)
            want = (point >= s) & (point <= e)
            got = lane_mask(s, e, lo)
            assert [bool(got >> k & 1) for k in range(32)] == list(want)


def small_work():
    return layer_workload(headline_pack(3000, nu_max=260.0),
                          np.arange(1.0, 220.0, 0.1))


@pytest.mark.parametrize("batched", [False, True])
def test_models_equal_plain_on_real_plans(batched):
    """A real layer's segment plans (the core over the core windows, the
    wings over the wing windows, as ``make_device_plan(core_mode="seg",
    wings_mode="seg")`` builds them; a batch of two layers shares the
    plans): both models equal the plan's plain pass bit for bit."""
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays

    work = small_work()
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device="cpu",
                               core_mode="seg", wings_mode="seg")
    cases = [("core", plan.core, plan.groups), ("wings", plan.wings,
                                                 plan.soa)]
    if batched:
        kin = kernel_inputs(line_profile_params(
            work["pack"], 227.74, 1032.0, 4.8e-06, keep=work["keep"]),
            internal_grid(work["grid"])[0], work["npv"], CUT_OFF)
        second = prepare_kernel_arrays(kin, work["npv"], np.float32)
        both = {k: np.stack([work["arrays"][k], second[k]])
                for k in second}
        idx = np.maximum(plan.wings.inst_line, 0)
        cases = [("core", plan.core,
                  torch.as_tensor(plan.core.gather(both))),
                 ("wings", plan.wings, torch.as_tensor(
                     plan.wings.wings_params({k: v[..., idx]
                                              for k, v in both.items()})))]
    for kind, seg_plan, params in cases:
        p = params if params.dim() == 3 else params[None]
        got, seen = kernel_model(kind, p, seg_plan.streams, work["n"],
                                 seg_plan.tile)
        want = seg_plan.seg_pass(p, plain=True)
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)
        assert torch.equal(seg_plan.seg_pass(p), want)


def test_seg_bytes_and_evals_count_what_the_kernels_read():
    """The segment pass's bytes: 7 rows of each walked chunk's 128
    instances a layer, the int32 walk (chunks; the wings' streams too; the
    fold's pointers) and the output; the wings' terms against a
    point-by-point count."""
    params, streams, n = synthetic("wings", 256, True, seed=2, odd=False)
    e, ptr = streams.num_entries, streams.ptr.size
    assert seg_bytes("wings", params, streams, n) == 4 * (
        7 * 128 * e * 2 + 2 * e + ptr + 2 * n)
    assert seg_bytes("core", params[0], streams, n) == 4 * (
        7 * 128 * e + e + ptr + n)
    count = 0
    for b in range(2):
        for k in range(e):
            lo = 32 * int(streams.stream[k])
            col = int(streams.chunk[k]) * 128
            for i in range(col, col + 128):
                s, t = params[b, lc.S_IDX, i], params[b, lc.E_IDX, i]
                count += sum(1 for p in range(lo, lo + 32) if s <= p <= t)
    assert seg_wings_evals(params, streams) == count > 0


@pytest.mark.parametrize("kind,classes", [("core", (4, 4, 4, 1)),
                                          ("wings", (0,))])
def test_plain_matches_pallas_on_a_class4_heavy_input(kind, classes):
    """The plain version (unchanged by the redesign) against
    ``_pallas_seg_pass`` in interpret mode within 1e-6 of the scale, as
    ``test_seg_pass_matches_pallas`` holds the core: class-4 chunks beside
    a K1 one for the core; the synthetic wings too, whose prefactors of
    both signs cancel at some points, where a relative measure would read
    the two summation orders (the real plans' wings keep rel 5e-6 in
    tests/test_torch_lineshape.py)."""
    tile = 256
    params, t_start, t_chunks, c_slot, n = synthetic_segment(
        3, kind, tile=tile, tile_chunks=(4, 1, 5), odd=False,
        classes=classes)
    got = lc.seg_plain(torch.as_tensor(params), torch.as_tensor(t_start),
                       torch.as_tensor(t_chunks), torch.as_tensor(c_slot),
                       n, tile, kind=kind).numpy()
    want = np.asarray(jlp._pallas_seg_pass(
        jnp.asarray(params), t_start, t_chunks, c_slot, n, tile, 128,
        interpret=True, kind=kind))
    assert got.shape == want.shape == (2, n)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def odd_mixed(params, seed, tile):
    """The segment core's parameters as a mixed-slot core input: each
    instance in a slot of its tile drawn from ``seed``."""
    mixed = params.copy()
    mixed[:, lc.SR_SLOT] = np.random.default_rng(seed).integers(
        0, tile // lc.SEG, params.shape[2])
    return mixed


def ported_and_pallas(kind, params, t_start, t_chunks, c_slot, n, tile,
                      seed, jax_too=True):
    """The port's plain pass and (``jax_too``) the JAX Pallas kernel's in
    interpret mode on one input: "core" and "wings" the segment pass
    (``_pallas_seg_pass``), "mixed" the mixed-slot core
    (``_pallas_seg_pass_mixed``) on :func:`odd_mixed`'s slots."""
    if kind == "mixed":
        params = odd_mixed(params, seed, tile)
        got = lc.core_tiles_plain(
            torch.as_tensor(params), torch.as_tensor(t_start),
            torch.as_tensor(t_chunks), t_chunks.size, tile).reshape(
                params.shape[0], n).numpy()
        want = jlp._pallas_seg_pass_mixed(
            jnp.asarray(params), t_start, t_chunks, n, tile, 128,
            interpret=True) if jax_too else None
    else:
        got = lc.seg_plain(torch.as_tensor(params), torch.as_tensor(t_start),
                           torch.as_tensor(t_chunks),
                           torch.as_tensor(c_slot), n, tile,
                           kind=kind).numpy()
        want = jlp._pallas_seg_pass(
            jnp.asarray(params), t_start, t_chunks, c_slot, n, tile, 128,
            interpret=True, kind=kind) if jax_too else None
    return got, None if want is None else np.asarray(want)


def segment_input(kind, seed, classes, tile, odd):
    """:func:`synthetic_segment`'s input for ``kind`` ("core", "mixed" or
    "wings"); ``odd`` "nan_y": the input without the non-finite values
    but one NaN y, in chunk 3 (no class-4 chunk in the cases below)."""
    base = "wings" if kind == "wings" else "core"
    params, *rest = synthetic_segment(seed, base, tile=tile, classes=classes,
                                      odd=odd is True)
    if odd == "nan_y":
        params[:, lc.SR_Y, 3 * lc.ROWS_CHUNK + 100] = np.nan
    return (params, *rest)


@pytest.mark.parametrize("kind,odd", [("core", True), ("mixed", True),
                                      ("wings", True), ("core", "nan_y"),
                                      ("mixed", "nan_y")])
@pytest.mark.parametrize("seed,classes", [(0, (0, 1, 2, 3, 4)),
                                          (5, (4, 4, 4, 1))])
def test_plain_matches_pallas_on_non_finite_inputs(kind, odd, seed,
                                                   classes):
    """The plain versions against the JAX kernels in interpret mode on the
    inputs with an infinite and a NaN prefactor, a NaN y, y = 0 at x = 0
    (and in the wings a NaN window start), or with a NaN y alone (the
    mixed-slot pass spreads a NaN prefactor's NaN over its chunk's tile,
    0 * NaN in its one-hot sum, which would hide the rest): NaN and each
    signed infinity where JAX's are, and the finite points within 1e-6 of
    the scale, as ``test_seg_pass_matches_pallas`` holds the core.  The
    scale is the same input's without the non-finite values, whose NaN
    covers the largest points.  A chunk whose min y is NaN takes the whole
    correction (class 4) in both, its other instances their corrections,
    the NaN-y instance none (correction(x, NaN) is 0)."""
    tile = 256
    params, t_start, t_chunks, c_slot, n = segment_input(kind, seed, classes,
                                                         tile, odd)
    got, want = ported_and_pallas(kind, params, t_start, t_chunks, c_slot,
                                  n, tile, seed)
    clean = segment_input(kind, seed, classes, tile, False)
    scale = np.abs(ported_and_pallas(kind, *clean, tile, seed,
                                     jax_too=False)[0]).max()
    assert got.shape == want.shape == (2, n) and scale > 0
    assert bool(np.isnan(want).any()) == (odd is True)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    finite = np.isfinite(want)
    assert float(np.abs(want[finite]).max()) > 0
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=scale * 1e-6)
