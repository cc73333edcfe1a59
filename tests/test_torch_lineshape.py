"""The port's wings and core passes against the JAX Pallas kernels.

The port's pipeline assembles a stacked SoA and core-parameter block; the
same numpy arrays and CSRs go through the Pallas kernels in interpret mode
(``_pallas_pass_strided``, ``_pallas_pass_batched`` with the prepacked
splat line function, ``_pallas_seg_pass_mixed``) and through the port's
wrappers, which on CPU tensors run the plain versions.  rel < 5e-6 with the
1e-7 * max floor of tests/test_lineshape_pallas.py (the core alone, which
cancels to near zero at points, to 1e-6 of its scale).  The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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

GRID = np.arange(1.0, 220.0, 0.2)
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])


def packs():
    return {
        "H2O": synthetic_line_pack("H2O", num_lines=300, nu_min=0.6,
                                   nu_max=260.0, seed=21,
                                   band_centers=(150.0,)),
        "CO2": synthetic_line_pack("CO2", num_lines=200, nu_min=0.6,
                                   nu_max=260.0, seed=22,
                                   band_centers=(60.0, 200.0)),
        "O3": synthetic_line_pack("O3", num_lines=100, nu_min=0.6,
                                  nu_max=260.0, seed=23,
                                  band_centers=(100.0,)),
    }


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * 1e-7)).max())


def pipeline(tile, tail, device="cpu"):
    fn = make_multigas_batched_fn(packs(), GRID, tile=tile, chunk=128,
                                  wings_tail=tail, device=device)
    soa, core = fn.assemble(T, P, VMR)
    return fn, soa, core


@pytest.mark.parametrize("tile,tail", [(512, 128), (512, None)])
def test_strided_wings_match_pallas(tile, tail):
    fn, soa, _ = pipeline(tile, tail)
    assert fn.wings_stride is not None
    assert (fn.wings_tail_csr is not None) == (tail is not None)
    lc.reset_launches()
    got = fn.wings_pass(soa).numpy()
    assert lc.LAUNCHES["wings_strided"] == 0   # CPU tensors: plain version
    w_start, w_n = fn.wings_csr
    t_start, t_n = fn.wings_tail_csr or (None, None)
    want = jlp._pallas_pass_strided(
        jnp.asarray(soa.numpy()), w_start, w_n, fn.core_plan.num_points,
        tile, fn.wings_stride, chunk=fn.wings_chunk, interpret=True,
        prepacked=True, t_start=t_start, t_n=t_n, tail=tail or 128)
    assert got.shape == want.shape
    assert rel_err(got, want) < 5e-6


def test_splat_wings_match_pallas():
    fn, soa, _ = pipeline(256, 128)
    assert fn.wings_stride is None
    got = fn.wings_pass(soa).numpy()
    w_start, w_n = fn.wings_csr
    batch = soa.shape[0]
    want = jlp._pallas_pass_batched(
        jnp.asarray(soa.numpy()), np.broadcast_to(w_start, (batch,)
                                                  + w_start.shape),
        np.broadcast_to(w_n, (batch,) + w_n.shape),
        fn.core_plan.num_points, 256, fn.wings_chunk, "wings_pre",
        interpret=True)
    assert got.shape == want.shape
    assert rel_err(got, want) < 5e-6
    # A [B, T] broadcast CSR is taken like the shared [T] one.
    bcast = [torch.as_tensor(a).expand(batch, -1) for a in fn.wings_csr]
    again = lc.tile_pass(soa, *bcast, fn.core_plan.num_points, 256,
                         fn.wings_chunk, "wings_pre").numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("tile,tail", [(512, 128), (256, 128)])
def test_segmix_core_matches_pallas(tile, tail):
    """The core correction alone cancels to near zero at points (it is
    K_full - K_lorentz), so it is held to 1e-6 of its scale in absolute
    terms (the JAX package's own segmix test uses 1e-5); the spectrum it
    produces with the wings is held to rel < 5e-6."""
    fn, soa, core = pipeline(tile, tail)
    plan = fn.core_plan
    got = fn.core_pass(core).numpy()
    want = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(core.numpy()), plan.t_start, plan.t_chunks,
        plan.num_points, plan.tile, plan.chunk, interpret=True))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    wings = fn.wings_pass(soa).numpy()
    assert rel_err(wings + got, wings + want) < 5e-6


def test_plain_float64_matches_float32_path():
    """The plain versions run in float64 too (the parity reference the
    card checks the float32 kernels against)."""
    fn, soa, core = pipeline(512, 128)
    k32 = fn.wings_pass(soa) + fn.core_pass(core)
    k64 = fn.wings_pass(soa.double()) + fn.core_pass(core.double())
    assert k64.dtype == torch.float64
    assert rel_err(k32.numpy(), k64.numpy()) < 5e-6


def test_wrappers_refuse_other_devices():
    fn, soa, core = pipeline(512, 128)
    with pytest.raises(ValueError, match="device"):
        fn.wings_pass(soa.to("meta"))
    with pytest.raises(ValueError, match="device"):
        fn.core_pass(core.to("meta"))


# --- Single-gas formulations on the small workload of
# tests/test_lineshape_pallas.py:13-22 (two layers for the batched forms). ---

SMALL_CONDS = [(288.99, 98388.0, 6.637074e-03), (250.0, 80000.0, 0.004)]


def small_layers(step=0.2, pack=None, conds=SMALL_CONDS):
    """[(kin, port kernel arrays)] per layer, npv, n (of a 120-line pack
    unless ``pack`` is given)."""
    from pylbl_tpu.database.fixtures import synthetic_line_pack as jpack
    from pylbl_tpu.models.lines import internal_grid
    from pylbl_tpu.models.lines.physics import (kernel_inputs,
                                                line_profile_params)
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays

    if pack is None:
        pack = jpack(num_lines=120, nu_min=30.0, nu_max=280.0, seed=11,
                     band_centers=(150.0,))
    grid = np.arange(50.0, 250.0, step)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    layers = []
    for cond in conds:
        kin = kernel_inputs(line_profile_params(pack, *cond, keep=keep), v0,
                            npv, 25)
        layers.append((kin, prepare_kernel_arrays(kin, npv, np.float32)))
    return layers, npv, n


def union_windows(arrays_list, lo, hi):
    return (np.min([a[lo] for a in arrays_list], axis=0).astype(np.int64),
            np.max([a[hi] for a in arrays_list], axis=0).astype(np.int64))


def stacked(arrays_list):
    return {k: np.stack([a[k] for a in arrays_list]) for k in arrays_list[0]}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("pass_kind", ["wings", "core", "wings_pre"])
def test_tile_pass_matches_pallas(pass_kind, batched):
    """The tile kernel's line functions (raw Lorentzian, per-line Humlicek
    correction, prepacked Lorentzian) against ``_pallas_pass`` (one layer)
    and ``_pallas_pass_batched``.  The correction alone cancels to near
    zero at points, so it is held to 1e-6 of its scale, as the JAX
    package's own scalar-vs-segment core test does."""
    from pylbl_tpu_torch.ops.lineshape import core_halfwidth

    layers, npv, n = small_layers()
    arrays = [a for _, a in layers]
    tile, chunk = 256, 128
    s, e = union_windows(arrays, "s_idx", "e_idx")
    if pass_kind == "core":
        kin = layers[0][0]
        core_w = core_halfwidth({"y": kin["y"], "repwid": kin["repwid"]},
                                npv, 25)
        center = np.rint(arrays[0]["c_int"]).astype(np.int64)
        s, e = np.maximum(center - core_w, s), np.minimum(center + core_w, e)
    start, nchunks = lc.tile_line_ranges(s, e, n, tile, chunk)
    soa = lc.pack_lines_soa(stacked(arrays) if batched else arrays[0],
                            chunk)[0]
    if pass_kind == "wings_pre":
        soa[..., lc.PREF, :] = soa[..., lc.PREF, :] * soa[..., lc.Y, :] \
            * np.float32(1.0 / np.sqrt(np.pi))
        soa[..., lc.Y, :] = soa[..., lc.Y, :] * soa[..., lc.Y, :]
    lc.reset_launches()
    got = lc.tile_pass(torch.as_tensor(soa), start, nchunks, n, tile, chunk,
                       pass_kind).numpy()
    assert sum(lc.LAUNCHES.values()) == 0
    if batched:
        bcast = [np.ascontiguousarray(np.stack([a, a]))
                 for a in (start, nchunks)]
        want = jlp._pallas_pass_batched(jnp.asarray(soa), *bcast, n, tile,
                                        chunk, pass_kind, interpret=True)
    else:
        want = jlp._pallas_pass(jnp.asarray(soa), start, nchunks, n, tile,
                                chunk, pass_kind, interpret=True)
    want = np.asarray(want)
    assert got.shape == want.shape == ((2, n) if batched else (n,))
    if pass_kind == "core":
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    else:
        assert rel_err(got, want) < 5e-6


def union_core_windows(layers, n, npv):
    """The union over ``layers`` of each line's core-instance window."""
    windows = [lc.core_instance_windows(a, k, n, npv, 25) for k, a in layers]
    return (np.min([w[0] for w in windows], axis=0),
            np.max([w[1] for w in windows], axis=0))


def seg_plan_params(layers, npv, n, kind, batched, tile=256, chunk=128):
    """A segment plan ("core" over the union core windows, "wings" over
    the union wing windows) of ``layers`` and its parameter block (the
    first layer, or all)."""
    arrays = [a for _, a in layers]
    data = stacked(arrays) if batched else arrays[0]
    if kind == "core":
        cs, ce = union_core_windows(layers, n, npv)
        plan = lc.CorePlan(cs, ce, n, tile, sort_key=arrays[0]["y"],
                           mode="seg", chunk=chunk)
        return plan, plan.gather(data)
    s, e = union_windows(arrays, "s_idx", "e_idx")
    plan = lc.CorePlan(s, e, n, tile, mode="seg", kind="wings", chunk=chunk)
    idx = np.maximum(plan.inst_line, 0)
    return plan, plan.wings_params({k: v[..., idx] for k, v in data.items()})


def check_seg_pass(plan, params, n, kind, batched):
    """The plan's segment pass against ``_pallas_seg_pass``: the core
    alone to 1e-6 of its scale, the wings to rel 5e-6."""
    got = plan.seg_pass(torch.as_tensor(params)).numpy()
    want = np.asarray(jlp._pallas_seg_pass(
        jnp.asarray(params), plan.t_start, plan.t_chunks, plan.c_slot, n,
        plan.tile, plan.chunk, interpret=True, kind=kind))
    assert got.shape == want.shape == ((2, n) if batched else (n,))
    if kind == "core":
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    else:
        assert rel_err(got, want) < 5e-6


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["core", "wings"])
def test_seg_pass_matches_pallas(kind, batched):
    """The per-stream segment-32 pass (core and Lorentzian wings) against
    ``_pallas_seg_pass``, one layer and a two-layer batch over a shared
    plan (the core alone to 1e-6 of its scale, as above)."""
    layers, npv, n = small_layers()
    plan, params = seg_plan_params(layers, npv, n, kind, batched)
    check_seg_pass(plan, params, n, kind, batched)


def test_single_layer_strided_and_segmix_match_pallas():
    """One layer [8, N] through the strided wings and the mixed-slot core
    (batches of one) against ``_pallas_pass_strided`` and
    ``_pallas_seg_pass_mixed`` on the same single-layer blocks."""
    layers, npv, n = small_layers()
    kin, arrays = layers[0]
    plan = lc.make_device_plan(arrays, kin, n, npv, 25, tile=1024, chunk=128,
                               device="cpu")
    assert plan.wings_stride is not None and plan.soa.dim() == 2
    wings = plan.wings_pass().numpy()
    want = np.asarray(jlp._pallas_pass_strided(
        jnp.asarray(plan.soa.numpy()), plan.w_start.numpy(),
        plan.w_n.numpy(), n, 1024, plan.wings_stride, interpret=True,
        prepacked=True))
    assert wings.shape == want.shape == (n,)
    assert rel_err(wings, want) < 5e-6
    core = plan.core_pass().numpy()
    want_core = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(plan.groups.numpy()), plan.core.t_start,
        plan.core.t_chunks, n, 1024, 128, interpret=True))
    scale = np.abs(want_core).max()
    np.testing.assert_allclose(core, want_core, rtol=0, atol=scale * 1e-6)
    assert rel_err(wings + core, want + want_core) < 5e-6


def test_strided_tail_single_layer_matches_pallas():
    """Mirrors tests/test_lineshape_pallas.py:464-506: the single-layer
    two-class tail pass against the Pallas tail kernel (5e-6) and against
    the single-class pass on the same lines (the JAX test's tolerance)."""
    rng = np.random.default_rng(11)
    n = 2048
    tile, stride = 512, 256
    num_lines = 700
    s = np.sort(rng.integers(0, n - 300, size=num_lines))
    e = s + rng.integers(50, 280, size=num_lines)
    lay1 = lc.build_strided_layout(s, stride, n, chunk=256, e_wide=e,
                                   tile=tile)
    lay2 = lc.build_strided_layout(s, stride, n, chunk=256, e_wide=e,
                                   tile=tile, tail=128)
    assert lay2.t_start is not None and lay2.t_n.sum() > 0
    pref_line = (rng.random(num_lines) + 0.5).astype(np.float32)

    def soa_for(lay):
        c_int = (s + e) / 2.0
        rows = np.zeros((8, lay.nlines), np.float32)
        idx, dead = lay.idx, lay.dead
        rows[0] = c_int[idx]
        rows[1] = 0.1
        rows[2] = np.float32(0.02)
        rows[3] = np.float32(1.5)
        rows[4] = np.where(dead, 0.0, pref_line[idx])
        rows[5] = np.where(dead, -1, s[idx])
        rows[6] = np.where(dead, -2, e[idx])
        return rows

    lc.reset_launches()
    out1 = lc.wings_strided_pass(torch.as_tensor(soa_for(lay1)),
                                 lay1.w_start, lay1.w_n, n, tile, stride,
                                 chunk=256).numpy()
    out2 = lc.wings_strided_pass(torch.as_tensor(soa_for(lay2)),
                                 lay2.w_start, lay2.w_n, n, tile, stride,
                                 chunk=256, t_start=lay2.t_start,
                                 t_n=lay2.t_n, tail=128).numpy()
    assert sum(lc.LAUNCHES.values()) == 0
    want2 = np.asarray(jlp._pallas_pass_strided(
        jnp.asarray(soa_for(lay2)), lay2.w_start, lay2.w_n, n, tile, stride,
        chunk=256, interpret=True, prepacked=True, t_start=lay2.t_start,
        t_n=lay2.t_n, tail=128))
    assert out2.shape == want2.shape == (n,)
    assert rel_err(out2, want2) < 5e-6
    np.testing.assert_allclose(out1, out2, rtol=2e-6,
                               atol=abs(out1).max() * 1e-6)
    assert abs(out1).max() > 0


# --- The rows core (K9) and the ownership-checked strided wings (K6). ---

def rows_blocks(batched, tile=256, work=None):
    """The rows plan over two layers' union core windows and its group
    block (one layer or both); ``work``: :func:`small_layers`' result
    (the small pack's by default)."""
    layers, npv, n = work or small_layers()
    arrays = [a for _, a in layers]
    cs, ce = union_core_windows(layers, n, npv)
    plan = lc.CorePlan(cs, ce, n, tile, sort_key=arrays[0]["y"],
                       mode="rows")
    return plan, plan.gather(stacked(arrays) if batched else arrays[0]), n


@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_rows_pass_matches_pallas(batched, tile):
    """The rows core (one layer and a two-layer batch over one plan)
    against ``_pallas_rows_pass``; the core alone to 1e-6 of its scale, as
    the JAX package's rows-vs-scalar core test holds it."""
    plan, groups, n = rows_blocks(batched, tile)
    lc.reset_launches()
    got = plan.core_pass(torch.as_tensor(groups)).numpy()
    assert sum(lc.LAUNCHES.values()) == 0
    want = np.asarray(jlp._pallas_rows_pass(
        jnp.asarray(groups), plan.g_start, plan.g_n, n, tile, plan.chunk,
        interpret=True))
    assert got.shape == want.shape == ((2, n) if batched else (n,))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_rows_vmem_pass_matches_pallas():
    """The rows core with the separate min-y block against
    ``_pallas_rows_pass_vmem``, and against the rows core itself (the
    same values in the same order)."""
    plan, groups, n = rows_blocks(False)
    ymin = lc.group_min_y(groups)
    got = lc.rows_vmem_pass(torch.as_tensor(groups), torch.as_tensor(ymin),
                            plan.walk, n, 256).numpy()
    want = np.asarray(jlp._pallas_rows_pass_vmem(
        jnp.asarray(groups), jnp.asarray(ymin), plan.g_start, plan.g_n, n,
        256, interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    np.testing.assert_array_equal(
        got, plan.core_pass(torch.as_tensor(groups)).numpy())


def test_checked_strided_wings_match_pallas():
    """Mirrors tests/test_lineshape_pallas.py:322-363: the ownership-checked
    strided wings on the straddle CSR against ``_pallas_pass_strided(
    prepacked=False)`` (5e-6), one layer and a two-layer batch sharing the
    CSR (layer 0 bit-identical to the single-layer pass)."""
    layers, npv, n = small_layers()
    arrays = layers[0][1]
    tile, chunk = 1024, 128
    soa, num = lc.pack_lines_soa(arrays, chunk)
    s = arrays["s_idx"].astype(np.int64)
    e = arrays["e_idx"].astype(np.int64)
    stride = lc.pick_wings_stride(tile, int((e - s).max()) + 1)
    assert stride in (256, 512)
    assign = np.clip(s, 0, None) // stride
    soa[lc._PAD, :num] = assign.astype(np.float32)
    soa[lc._PAD, num:] = -1.0
    st, nc = lc.strided_line_ranges(assign, (n - 1) // stride + 1,
                                    chunk=chunk)
    soa_b = np.stack([soa, soa * 1.0])
    soa_b[1, lc.PREF] *= 0.5
    lc.reset_launches()
    got = lc.wings_strided_checked_pass(torch.as_tensor(soa), st, nc, n,
                                        tile, stride, chunk).numpy()
    got_b = lc.wings_strided_checked_pass(torch.as_tensor(soa_b), st, nc, n,
                                          tile, stride, chunk).numpy()
    assert sum(lc.LAUNCHES.values()) == 0
    for data, out in ((soa, got), (soa_b, got_b)):
        want = np.asarray(jlp._pallas_pass_strided(
            jnp.asarray(data), st, nc, n, tile, stride, chunk=chunk,
            interpret=True))
        assert out.shape == want.shape
        assert rel_err(out, want) < 5e-6
    np.testing.assert_array_equal(got_b[0], got)
    # Foreign lines add nothing: the tile splat over the same lines.
    w_start, w_n = lc.tile_line_ranges(s, e, n, tile, chunk)
    splat = lc.tile_pass(torch.as_tensor(soa), w_start, w_n, n, tile, chunk,
                         "wings").numpy()
    np.testing.assert_allclose(got, splat, atol=np.abs(splat).max() * 1e-6)


# --- The split chunk walks: a dense line cluster puts more than
# 2 * PIECE_CHUNKS chunks into one tile of the wings and the core. ---

def dense_packs():
    """4000 H2O lines within 100-103 cm-1 (one or two tiles of the core
    and the wings hold them all) beside the small CO2 pack."""
    return {
        "H2O": synthetic_line_pack("H2O", num_lines=4000, nu_min=100.0,
                                   nu_max=103.0, seed=31,
                                   band_centers=(101.5,)),
        "CO2": packs()["CO2"],
    }


def dense_pipeline(tile, tail):
    fn = make_multigas_batched_fn(dense_packs(), GRID, tile=tile, chunk=128,
                                  wings_tail=tail, device="cpu")
    soa, core = fn.assemble(T, P, VMR)
    return fn, soa, core


def most_chunks(*counts):
    return int(sum(np.asarray(c, np.int64) for c in counts).max())


@pytest.mark.parametrize("tile,tail", [(512, 128), (256, 128)])
def test_split_segmix_core_matches_pallas(tile, tail):
    """The stacked path's mixed-slot core with a tile of more than 2K
    chunks (several pieces) against ``_pallas_seg_pass_mixed``, the core
    alone to 1e-6 of its scale as test_segmix_core_matches_pallas."""
    fn, _, core = dense_pipeline(tile, tail)
    plan = fn.core_plan
    assert most_chunks(plan.t_chunks) > 2 * lc.PIECE_CHUNKS
    assert plan.pieces.num_slots > 0
    got = fn.core_pass(core).numpy()
    want = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(core.numpy()), plan.t_start, plan.t_chunks,
        plan.num_points, plan.tile, plan.chunk, interpret=True))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_split_strided_tail_wings_match_pallas():
    """The strided wings with the tail chunk class, one tile walking more
    than 2K main and tail chunks, against ``_pallas_pass_strided``."""
    fn, soa, _ = dense_pipeline(512, 128)
    assert fn.wings_stride is not None and fn.wings_tail_csr is not None
    w_start, w_n = fn.wings_csr
    t_start, t_n = fn.wings_tail_csr
    assert most_chunks(w_n, t_n) > 2 * lc.PIECE_CHUNKS and t_n.sum() > 0
    got = fn.wings_pass(soa).numpy()
    want = np.asarray(jlp._pallas_pass_strided(
        jnp.asarray(soa.numpy()), w_start, w_n, fn.core_plan.num_points,
        512, fn.wings_stride, chunk=fn.wings_chunk, interpret=True,
        prepacked=True, t_start=t_start, t_n=t_n, tail=128))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_split_splat_wings_match_pallas():
    """The splat wings, tiles walking more than 2K chunks of 128 lines,
    against ``_pallas_pass_batched`` with the prepacked line function."""
    fn, soa, _ = dense_pipeline(256, 128)
    assert fn.wings_stride is None
    w_start, w_n = fn.wings_csr
    assert most_chunks(w_n) > 2 * lc.PIECE_CHUNKS
    batch = soa.shape[0]
    got = fn.wings_pass(soa).numpy()
    want = np.asarray(jlp._pallas_pass_batched(
        jnp.asarray(soa.numpy()), np.broadcast_to(w_start, (batch,)
                                                  + w_start.shape),
        np.broadcast_to(w_n, (batch,) + w_n.shape), fn.core_plan.num_points,
        256, fn.wings_chunk, "wings_pre", interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_one_piece_tile_matches_pallas():
    """A tile of exactly one full piece writes its sum directly: the walk
    of the second-densest tile (13 chunks) cut to PIECE_CHUNKS, against the
    Pallas core on the same cut CSR, and bit for bit the sum of its chunk
    partials in order.  (The densest tile cut so short ends on a point
    that cancels, where the TPU kernel's one-hot order and the port's
    differ by 1.8e-6 of the maximum.)"""
    fn, _, core = dense_pipeline(512, 128)
    plan = fn.core_plan
    t_chunks = plan.t_chunks.copy()
    dense = int(np.argsort(t_chunks, kind="stable")[-2])
    assert t_chunks[dense] > lc.PIECE_CHUNKS
    t_chunks[dense] = lc.PIECE_CHUNKS
    pieces = lc.TilePieces(t_chunks)
    assert pieces.per_tile[dense] == 1 and pieces.slot[dense] == -1
    got = lc.core_segmix_pass(core, torch.as_tensor(plan.t_start),
                              torch.as_tensor(t_chunks), plan.num_points,
                              plan.tile, pieces=pieces).numpy()
    want = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(core.numpy()), plan.t_start, t_chunks, plan.num_points,
        plan.tile, plan.chunk, interpret=True))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    # The same tile through one-chunk walks, added in walk order.
    tile = plan.tile
    span = slice(dense * tile, (dense + 1) * tile)
    total = torch.zeros(core.shape[0], tile)
    for k in range(lc.PIECE_CHUNKS):
        one = np.zeros_like(t_chunks)
        one[dense] = 1
        start = plan.t_start.copy()
        start[dense] += k
        total = total + lc.core_segmix_pass(
            core, torch.as_tensor(start), torch.as_tensor(one),
            plan.num_points, tile)[:, span]
    np.testing.assert_array_equal(got[:, span], total.numpy())


def test_tile_pieces_plan():
    """Pieces of at most K chunks per tile, one for an empty tile, scratch
    slots only for split tiles; [B, T] counts split by their most."""
    k = lc.PIECE_CHUNKS
    counts = np.asarray([0, 1, k, k + 1, 2 * k + 1])
    pieces = lc.TilePieces(counts)
    assert list(pieces.per_tile) == [1, 1, 1, 2, 3]
    assert list(pieces.first) == [0, 1, 2, 3, 5]
    assert list(pieces.tile) == [0, 1, 2, 3, 3, 4, 4, 4]
    assert list(pieces.slot) == [-1, -1, -1, 0, 2]
    assert pieces.num_slots == 5 and pieces.num_pieces == 8
    assert pieces.stats() == {"pieces": 8, "most_chunks_tile": 2 * k + 1,
                              "most_chunks_piece": k}
    layered = lc.TilePieces(np.stack([counts, counts[::-1]]))
    assert list(layered.per_tile) == [3, 2, 1, 2, 3]
    both = lc.TilePieces.of_csr(counts, torch.as_tensor(counts), piece=k)
    assert list(both.per_tile) == list(lc.TilePieces(2 * counts).per_tile)
    # The chunk classes' pieces are the tile kernel's by default.
    assert lc.TilePieces.of_csr(counts).piece == lc.WINGS_PIECE_CHUNKS


def test_fold_pieces_is_the_kernels_order():
    """The plain fold: piece j sums chunks jK.. in order from +0.0, the tile
    sums its pieces in order from +0.0 (bit for bit against a loop)."""
    rng = np.random.default_rng(5)
    k = lc.PIECE_CHUNKS
    counts = [0, 3 * k + 2, 1, k]
    tiles = np.repeat(np.arange(len(counts)), counts)
    seq = np.concatenate([np.arange(c) for c in counts])
    parts = torch.as_tensor(rng.normal(size=(2, tiles.size, 5))
                            .astype(np.float32))
    got = lc._fold_pieces(parts, torch.as_tensor(tiles),
                          torch.as_tensor(seq), (2, len(counts), 5))
    want = torch.zeros(2, len(counts), 5)
    for t, count in enumerate(counts):
        first = int(np.flatnonzero(tiles == t)[0]) if count else 0
        acc = torch.zeros(2, 5)
        for j in range(0, count, k):
            piece = torch.zeros(2, 5)
            for c in range(j, min(j + k, count)):
                piece = piece + parts[:, first + c]
            acc = acc + piece
        want[:, t] = acc
    assert torch.equal(got, want)


# --- The segment pass per chunk and the rows core per piece, on the dense
# cluster: at 0.2 cm-1 and tile 256 its densest core stream folds 19
# chunks and its densest wings stream 32; the rows plan cuts its densest
# tile into 76 pieces of 32 groups. ---

DENSE_CONDS = [(288.99, 98388.0, 6.637074e-03), (227.74, 1032.0, 4.763972e-06)]


def dense_layers():
    """The dense H2O cluster's kernel arrays at a surface layer and a
    1032 Pa layer on 50-250 cm-1 @ 0.2: :func:`small_layers`' result."""
    from pylbl_tpu.database.fixtures import synthetic_line_pack as jpack

    pack = jpack("H2O", num_lines=4000, nu_min=100.0, nu_max=103.0, seed=31,
                 band_centers=(101.5,))
    return small_layers(pack=pack, conds=DENSE_CONDS)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["core", "wings"])
def test_split_seg_pass_matches_pallas(kind, batched):
    """The per-stream segment pass on a plan whose densest stream folds
    more than 8 chunks, one layer and two, against ``_pallas_seg_pass``
    at the tolerances of test_seg_pass_matches_pallas."""
    layers, npv, n = dense_layers()
    plan, params = seg_plan_params(layers, npv, n, kind, batched)
    assert plan.streams.stats()["most_chunks_stream"] > 8
    check_seg_pass(plan, params, n, kind, batched)


def test_seg_streams_plan():
    """The stream walk lists every walked chunk once, by stream, in walk
    order within a stream (slots interleaved within a tile here), with
    empty streams and unwalked chunks left out."""
    tile_start = np.asarray([0, 5, 9])
    tile_chunks = np.asarray([5, 3, 0])
    chunk_slot = np.asarray([1, 0, 1, 1, 0, 2, 2, 0, 0, 3])
    streams = lc.SegStreams(tile_start, tile_chunks, chunk_slot, slots=4)
    assert list(streams.chunk) == [1, 4, 0, 2, 3, 7, 5, 6]
    assert list(streams.stream) == [0, 0, 1, 1, 1, 4, 6, 6]
    assert list(streams.ptr) == [0, 2, 5, 5, 5, 6, 6, 8, 8, 8, 8, 8, 8]
    assert streams.stats() == {"chunks": 8, "core_piece": 1,
                               "core_blocks": 8, "streams": 12,
                               "most_chunks_stream": 3}
    assert streams.stats("wings", 16) == {"chunks": 8, "wings_warps": 8,
                                          "streams": 12,
                                          "most_chunks_stream": 3}
    many = lc.SEG_CORE_MANY
    assert lc.seg_core_piece(many // 16, 16) == lc.SEG_CORE_PIECE
    assert lc.seg_core_piece(many - 1) == 1
    again = lc.SegStreams(*(torch.as_tensor(a) for a in (
        tile_start, tile_chunks, chunk_slot)), 4)
    assert list(again.chunk) == list(streams.chunk)
    with pytest.raises(ValueError, match="slot"):
        lc.SegStreams(tile_start, tile_chunks, chunk_slot, slots=2)
    # A planner's streams are contiguous runs of chunk ids.
    layers, npv, n = dense_layers()
    plan, _ = seg_plan_params(layers, npv, n, "core", False)
    walked = int(plan.t_chunks.sum())
    assert list(plan.streams.chunk) == list(range(walked))
    assert plan.streams.ptr[-1] == walked


@pytest.mark.parametrize("batched", [False, True])
def test_split_rows_pass_matches_pallas(batched):
    """The rows core, its tiles' group walks cut into pieces of
    ROWS_PIECE_GROUPS and folded in piece order, against
    ``_pallas_rows_pass`` (one running sum through the walk) at 1e-6 of
    the scale, the JAX rows test's tolerance."""
    plan, groups, n = rows_blocks(batched, work=dense_layers())
    assert plan.walk.pieces.piece == lc.ROWS_PIECE_GROUPS
    assert plan.walk.pieces.per_tile.max() > 2
    got = plan.core_pass(torch.as_tensor(groups)).numpy()
    want = np.asarray(jlp._pallas_rows_pass(
        jnp.asarray(groups), plan.g_start, plan.g_n, n, plan.tile,
        plan.chunk, interpret=True))
    assert got.shape == want.shape == ((2, n) if batched else (n,))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_split_rows_vmem_pass_matches_pallas():
    """The rows core with the separate min-y block on the dense cluster
    against ``_pallas_rows_pass_vmem`` (1e-6 of the scale), and bit for
    bit the rows core itself."""
    plan, groups, n = rows_blocks(False, work=dense_layers())
    ymin = lc.group_min_y(groups)
    got = lc.rows_vmem_pass(torch.as_tensor(groups), torch.as_tensor(ymin),
                            plan.walk, n, plan.tile).numpy()
    want = np.asarray(jlp._pallas_rows_pass_vmem(
        jnp.asarray(groups), jnp.asarray(ymin), plan.g_start, plan.g_n, n,
        plan.tile, interpret=True))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    np.testing.assert_array_equal(
        got, plan.core_pass(torch.as_tensor(groups)).numpy())


def test_rows_pieces_plan():
    """Pieces of a width other than PIECE_CHUNKS: the rows core's walk of
    g_n * 128 groups in pieces of ROWS_PIECE_GROUPS (32), and a generic
    width of 3 units."""
    walk = lc.GroupWalk(np.asarray([0, 0, 128, 384]), np.asarray([0, 1, 2, 3]))
    pieces = walk.pieces
    assert pieces.piece == lc.ROWS_PIECE_GROUPS == 32
    assert list(pieces.counts) == [0, 128, 256, 384]
    assert list(pieces.per_tile) == [1, 4, 8, 12]
    assert list(pieces.first) == [0, 1, 5, 13]
    assert list(pieces.slot) == [-1, 0, 4, 12]
    assert pieces.num_slots == 24 and pieces.num_pieces == 25
    assert walk.stats() == {"pieces": 25, "most_groups_tile": 384,
                            "most_groups_piece": 32}
    assert [list(t) for t in walk.tensors("cpu")] == [[0, 0, 128, 384],
                                                       [0, 1, 2, 3]]
    three = lc.TilePieces(np.asarray([0, 1, 3, 4, 7]), piece=3)
    assert list(three.per_tile) == [1, 1, 1, 2, 3]
    assert three.stats() == {"pieces": 8, "most_chunks_tile": 7,
                             "most_chunks_piece": 3}


def test_rows_plain_folds_pieces_in_order():
    """rows_tiles_plain's order: a running sum per piece from +0.0 in
    group order, the pieces added in order from +0.0.  Pieces of one
    chunk's worth of groups sum like the tile's chunk partials, so the
    tile is bit for bit the chunks' passes added in walk order; one piece
    of the whole walk is the JAX kernels' single running sum."""
    plan, groups, n = rows_blocks(True, work=dense_layers())
    dense = int(np.argmax(plan.g_n))
    tile = plan.tile
    g = torch.as_tensor(groups)
    start, count = plan.g_start.copy(), plan.g_n.copy()
    span = slice(dense * tile, (dense + 1) * tile)
    got = lc.rows_plain(g, start, count, n, tile, piece=plan.chunk)[:, span]
    total = torch.zeros(2, tile)
    for k in range(int(count[dense])):
        one, first = np.zeros_like(count), start.copy()
        one[dense], first[dense] = 1, start[dense] + k * plan.chunk
        total = total + lc.rows_plain(g, first, one, n, tile,
                                      piece=plan.chunk)[:, span]
    assert count[dense] > 2 and torch.equal(got, total)
    whole = lc.rows_plain(g, start, count, n, tile, piece=1 << 30)
    split = lc.rows_plain(g, start, count, n, tile)
    scale = float(whole.abs().max())
    assert float((split - whole).abs().max()) <= scale * 1e-6

