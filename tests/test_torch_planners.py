"""The PyTorch port's host planners against the JAX package's.

The port cannot import pylbl_tpu (it pulls in jax), so it carries numpy
copies of the planners; these tests hold every copy byte-identical to the
original on the same inputs.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from pylbl_tpu.database import fixtures as jfix
from pylbl_tpu.models.lines import LinePack as JLinePack
from pylbl_tpu.models.lines import internal_grid as j_internal_grid
from pylbl_tpu.ops import lineshape as jls
from pylbl_tpu.ops import lineshape_pallas as jlp
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.database import fixtures as tfix
from pylbl_tpu_torch.models.lines import LinePack as TLinePack
from pylbl_tpu_torch.models.lines import internal_grid as t_internal_grid
from pylbl_tpu_torch.ops import lineshape_cuda as tlc
from pylbl_tpu_torch.parallel import lines as tlines
from pylbl_tpu_torch.utils import constants as tc

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
GRID = np.arange(1.0, 220.0, 0.2)
GAS_ARGS = [("H2O", 300, 21, (150.0,)), ("CO2", 200, 22, (60.0, 200.0)),
            ("O3", 100, 23, (100.0,))]


def packs_of(module):
    return {name: module.synthetic_line_pack(name, num_lines=num,
                                             nu_min=0.6, nu_max=260.0,
                                             seed=seed, band_centers=bands)
            for name, num, seed, bands in GAS_ARGS}


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def windows(host, arrays, static, t_max=350.0, p_max_atm=5.0, cut_off=25):
    """The stacked pipeline's wide and core windows (the
    make_multigas_batched_fn host derivation, in numpy)."""
    v0, n_per_v = static["v0"], static["n_per_v"]
    num_points = static["num_points"]
    off = arrays["flat_off"].astype(np.int64)
    b0 = np.floor(host["nu"]).astype(np.int64)
    s_wide = off + np.clip((b0 - 1 - cut_off - v0) * n_per_v, 0,
                           num_points - 1)
    e_wide = off + np.clip((b0 + 1 + cut_off + 1 - v0) * n_per_v, 0,
                           num_points - 1)
    alpha = (host["nu"] / tc.VLIGHT) * np.sqrt(
        tc.R2 * t_max / np.maximum(host["mass"], 1.0))
    core_w = tlc.core_halfwidths(tc.SQRT_LN2 / alpha, n_per_v, cut_off)
    np.testing.assert_array_equal(
        core_w, jls.core_halfwidths(tc.SQRT_LN2 / alpha, n_per_v, cut_off))
    shift_w = np.ceil(np.abs(host["delta_air"]) * p_max_atm
                      * n_per_v).astype(np.int64) + 1
    center0 = np.rint((host["nu"] - v0) * n_per_v).astype(np.int64)
    core_lo = off + np.clip(center0 - core_w - shift_w, 0, num_points - 1)
    core_hi = off + np.clip(center0 + core_w + shift_w, 0, num_points - 1)
    y_ref = host["gamma_air"] * (1.0 + host["n_air"])
    return s_wide, e_wide, core_lo, core_hi, y_ref


@pytest.fixture(scope="module")
def stacked():
    jp, tp = packs_of(jfix), packs_of(tfix)
    j_out = jlines.stack_device_packs(jp, GRID)
    t_out = tlines.stack_device_packs(tp, GRID)
    return j_out, t_out


def test_synthetic_line_pack_identical():
    for (name, j), t in zip(packs_of(jfix).items(), packs_of(tfix).values()):
        for field in JLinePack._ARRAY_FIELDS:
            assert_same(getattr(j, field), getattr(t, field))
        assert j.formula == t.formula == name


@pytest.mark.parametrize("name", ["h2o", "co2", "o3", "n2o", "co", "ch4",
                                  "o2", "n2"])
def test_frozen_pack_load_identical(name):
    path = DATA / f"{name}_frozen.lpk.npz"
    j, t = JLinePack.load(path), TLinePack.load(path)
    for field in JLinePack._ARRAY_FIELDS:
        assert_same(getattr(j, field), getattr(t, field))
    assert_same(j.mass, t.mass)
    assert_same(j.q(250.0), t.q(250.0))


def test_internal_grid_and_envelope_identical():
    for grid in (GRID, np.arange(1.0, 3250.0, 0.1), np.arange(500.0, 1500.0,
                                                                0.01)):
        assert j_internal_grid(grid) == t_internal_grid(grid)
    t = np.asarray([269.01, 227.74, 203.37, 288.99])
    p = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
    assert jlines.derive_envelope(t, p) == tlines.derive_envelope(t, p)


def test_device_line_pack_identical():
    for j, t in zip(packs_of(jfix).values(), packs_of(tfix).values()):
        ja, js = jlines.device_line_pack(j, GRID)
        ta, ts = tlines.device_line_pack(t, GRID)
        assert js == ts and set(ja) == set(ta)
        for key in ja:
            assert_same(ja[key], ta[key])


def test_stack_device_packs_identical(stacked):
    (ja, jh, js, jn), (ta, th, ts, tn) = stacked
    assert jn == tn and js == ts
    for key in ja:
        assert_same(ja[key], ta[key])
    for key in jh:
        assert_same(jh[key], th[key])


@pytest.mark.parametrize("tile,chunk", [(256, 128), (512, 128),
                                        (1024, 128), (1024, 512)])
def test_tile_line_ranges_identical(stacked, tile, chunk):
    _, (ta, th, ts, _) = stacked
    s_wide, e_wide, _, _, _ = windows(th, ta, ts)
    n = ts["flat_points"]
    for got, want in zip(tlc.tile_line_ranges(s_wide, e_wide, n, tile, chunk),
                         jlp.tile_line_ranges(s_wide, e_wide, n, tile,
                                              chunk)):
        assert_same(got, want)


@pytest.mark.parametrize("tile,tail,chunk", [
    (512, 128, None), (512, None, None), (1024, 128, None),
    (256, None, None), (1024, 128, 128), (512, None, 128)])
def test_plan_strided_stage_identical(stacked, tile, tail, chunk):
    """The strided plan at the default wings chunk (256) and at the
    ``wings_chunk=128`` the stacked pipelines take."""
    _, (ta, th, ts, _) = stacked
    s_wide, e_wide, core_lo, core_hi, y_ref = windows(th, ta, ts)
    n = ts["flat_points"]
    window = int((e_wide - s_wide).max()) + 1
    assert tlc.pick_wings_stride(tile, window) == \
        jlp.pick_wings_stride(tile, window)
    chunk = chunk or tlc.STRIDED_CHUNK
    got = tlc.plan_strided_stage(s_wide, e_wide, core_lo, core_hi, y_ref, n,
                                 tile=tile, chunk=chunk, tail=tail)
    want = jlp.plan_strided_stage(s_wide, e_wide, core_lo, core_hi, y_ref, n,
                                  tile=tile, chunk=chunk, tail=tail)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    for field in ("perm", "idx", "dead", "w_start", "w_n", "t_start", "t_n",
                  "assign"):
        if getattr(want[1], field) is None:
            assert getattr(got[1], field) is None
        else:
            assert_same(getattr(got[1], field), getattr(want[1], field))
    assert got[1].tail == want[1].tail and got[1].nlines == want[1].nlines
    for field in ("inst_line", "seg0", "slot", "t_start", "t_chunks"):
        assert_same(getattr(got[2], field), getattr(want[2], field))
    assert got[2].num_instances == want[2].num_instances
    permuted_t = tlc.permute_line_arrays(ta, got[1].perm)
    permuted_j = jlp.permute_line_arrays(ta, want[1].perm)
    for key in permuted_j:
        assert_same(permuted_t[key], permuted_j[key])


def test_layout_builders_identical(stacked):
    _, (ta, th, ts, _) = stacked
    s_wide, e_wide, core_lo, core_hi, y_ref = windows(th, ta, ts)
    n = ts["flat_points"]
    stride, tile = 128, 512
    num_tiles = (n - 1) // stride + 1
    s = np.clip(s_wide, 0, None)
    e = np.minimum(np.clip(e_wide, 0, None), n - 1)
    for chunk in (128, 256):
        assign_t = tlc._balanced_tile_assign(s, np.maximum(e, s), stride,
                                             tile, num_tiles, chunk)
        assign_j = jlp._balanced_tile_assign(s, np.maximum(e, s), stride,
                                             tile, num_tiles, chunk)
        assert_same(assign_t, assign_j)
        for got, want in zip(
                tlc.padded_strided_layout_tail(assign_t, num_tiles, chunk),
                jlp.padded_strided_layout_tail(assign_j, num_tiles, chunk)):
            assert_same(got, want)
        for got, want in zip(
                tlc.padded_strided_layout(assign_t, num_tiles, chunk),
                jlp.padded_strided_layout(assign_j, num_tiles, chunk)):
            assert_same(got, want)
    empty = np.zeros(0, np.int64)
    for got, want in zip(tlc.padded_strided_layout_tail(empty, 4),
                         jlp.padded_strided_layout_tail(empty, 4)):
        assert_same(got, want)
    for got, want in zip(
            tlc.build_core_segments_mixed(core_lo, core_hi, n, tile=tile,
                                          sort_key=y_ref),
            jlp.build_core_segments_mixed(core_lo, core_hi, n, tile=tile,
                                          sort_key=y_ref)):
        assert_same(got, want)


# --- Single-gas planners: kernel arrays, SoA, segment plans, device plan. ---

MODES = [(None, None), (None, "tile"), (None, "seg"), ("seg", None),
         ("seg", "seg"), ("rows", None), ("rows", "tile")]


def small_kin(step=0.2):
    """The small workload of tests/test_lineshape_pallas.py:13-22 (JAX
    physics, float64)."""
    from pylbl_tpu.models.lines.physics import (kernel_inputs,
                                                line_profile_params)
    pack = jfix.synthetic_line_pack(num_lines=120, nu_min=30.0,
                                    nu_max=280.0, seed=11,
                                    band_centers=(150.0,))
    grid = np.arange(50.0, 250.0, step)
    v0, vn, npv, n = j_internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    params = line_profile_params(pack, 288.99, 98388.0, 6.637074e-03,
                                 keep=keep)
    return kernel_inputs(params, v0, npv, 25), npv, n


def test_kernel_array_prep_identical():
    from pylbl_tpu_torch.ops import lineshape as tls

    kin, npv, _ = small_kin()
    for dtype in (np.float32, np.float64):
        got = tls.prepare_kernel_arrays(kin, npv, dtype)
        want = jls.prepare_kernel_arrays(kin, npv, dtype)
        assert set(got) == set(want)
        for key in want:
            assert_same(got[key], want[key])
        for multiple in (128, 512):
            (pg, ng), (pw, nw) = (tls._pad_lines(got, multiple),
                                  jls._pad_lines(want, multiple))
            assert ng == nw
            for key in pw:
                assert_same(pg[key], np.asarray(pw[key]))
    assert tls.core_halfwidth(kin, npv, 25) == jls.core_halfwidth(kin, npv,
                                                                  25)
    assert_same(tls.core_halfwidths(kin["repwid"], npv, 25),
                jls.core_halfwidths(kin["repwid"], npv, 25))


@pytest.mark.parametrize("chunk", [128, 512])
def test_pack_lines_soa_identical(chunk):
    kin, npv, _ = small_kin()
    arrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    batched = {k: np.stack([v, v[::-1]]) for k, v in arrays.items()}
    for data in (arrays, batched):
        (got, ng), (want, nw) = (tlc.pack_lines_soa(data, chunk),
                                 jlp.pack_lines_soa(data, chunk))
        assert ng == nw
        assert_same(got, want)


@pytest.mark.parametrize("tile,sorted_", [(256, True), (1024, True),
                                          (512, False)])
def test_segment_planners_identical(tile, sorted_):
    kin, npv, n = small_kin()
    arrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    got_w = tlc.core_instance_windows(arrays, kin, n, npv, 25)
    want_w = jlp.core_instance_windows(arrays, kin, n, npv, 25)
    for got, want in zip(got_w, want_w):
        assert_same(got, want)
    key = arrays["y"] if sorted_ else None
    got = tlc.build_core_segments(*got_w, n, tile=tile, sort_key=key)
    want = jlp.build_core_segments(*want_w, n, tile=tile, sort_key=key)
    for g, w in zip(got, want):
        assert_same(g, w)
    inst, seg0, slot = got[0], got[1], got[4][:1].repeat(got[0].size)
    batched = {k: np.stack([v, v]) for k, v in arrays.items()}
    for data in (arrays, batched):
        for sl in (None, slot):
            assert_same(tlc.gather_segment_params(data, inst, seg0, slot=sl),
                        jlp.gather_segment_params(data, inst, seg0, xp=np,
                                                  slot=sl))


@pytest.mark.parametrize("mode,kind", [("seg", "core"), ("segmix", "core"),
                                       ("seg", "wings"), ("rows", "core")])
def test_core_plan_modes_identical(mode, kind):
    kin, npv, n = small_kin()
    arrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    if kind == "wings":
        lo = arrays["s_idx"].astype(np.int64)
        hi = arrays["e_idx"].astype(np.int64)
    else:
        lo, hi = jlp.core_instance_windows(arrays, kin, n, npv, 25)
    got = tlc.CorePlan(lo, hi, n, 256, sort_key=arrays["y"], mode=mode,
                       kind=kind)
    want = jlp.CorePlan(lo, hi, n, 256, sort_key=arrays["y"], mode=mode,
                        kind=kind)
    for field in ("inst_line", "seg0", "t_start", "t_chunks", "slot",
                  "c_slot", "g_start", "g_n"):
        if getattr(want, field, None) is None:
            assert getattr(got, field, None) is None
        else:
            assert_same(getattr(got, field), getattr(want, field))
    assert got.num_instances == want.num_instances
    if kind == "wings":
        idx = np.maximum(want.inst_line, 0)
        ka = {k: arrays[k][idx] for k in ("c_int", "c_frac", "scaled_repwid",
                                          "y", "prefactor", "s_idx",
                                          "e_idx")}
        assert_same(got.wings_params(ka), want.wings_params(ka, xp=np))
    else:
        assert_same(got.gather(arrays), want.gather(arrays))
    if mode == "rows":
        # The segment-mode methods refuse a rows plan, as the JAX ones do.
        tensors = {k: torch.as_tensor(v) for k, v in arrays.items()}
        for method in (got.expand_line_arrays, got.seg_params):
            with pytest.raises(ValueError, match="seg"):
                method(dict(tensors, nu=tensors["y"]))
        with pytest.raises(ValueError, match="seg"):
            want.seg_params(arrays, xp=np)


@pytest.mark.parametrize("step,tile", [(0.2, 256), (0.2, 1024), (0.02, 256)])
@pytest.mark.parametrize("core_mode,wings_mode", MODES)
def test_make_device_plan_host_arrays_identical(step, tile, core_mode,
                                                wings_mode):
    """The single-layer plan's host blocks (SoA or seg wings parameters,
    wings CSR, core parameters) and plans, in each mode."""
    kin, npv, n = small_kin(step)
    arrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    got = tlc.make_device_plan(arrays, kin, n, npv, 25, tile=tile,
                               chunk=128, core_mode=core_mode,
                               wings_mode=wings_mode, device="cpu")
    want = jlp.make_device_plan(arrays, kin, n, npv, 25, tile=tile,
                                chunk=128, core_mode=core_mode,
                                wings_mode=wings_mode, interpret=True)
    assert got.wings_stride == want.wings_stride
    assert (got.wings is None) == (want.wings is None)
    for field in ("soa", "w_start", "w_n", "groups"):
        assert_same(getattr(got, field).numpy(),
                    np.asarray(getattr(want, field)))
    for g, w in ((got.core, want.core), (got.wings, want.wings)):
        if w is not None:
            assert g.mode == w.mode and g.kind == w.kind
            assert_same(g.inst_line, w.inst_line)
            for field in (("g_start", "g_n") if w.mode == "rows"
                          else ("t_chunks",)):
                assert_same(getattr(g, field), getattr(w, field))


@pytest.mark.parametrize("tile,sorted_", [(256, True), (1024, True),
                                          (512, False)])
def test_rows_planners_identical(tile, sorted_):
    """build_core_groups, gather_group_params (one layer and a batch) and
    group_min_y against the JAX planners, and the device gather of
    CorePlan.group_params against the host block."""
    kin, npv, n = small_kin()
    arrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    cs, ce = jlp.core_instance_windows(arrays, kin, n, npv, 25)
    key = arrays["y"] if sorted_ else None
    got = tlc.build_core_groups(cs, ce, n, tile, sort_key=key)
    want = jlp.build_core_groups(cs, ce, n, tile, sort_key=key)
    for g, w in zip(got, want):
        assert_same(g, w)
    batched = {k: np.stack([v, v[::-1]]) for k, v in arrays.items()}
    plan = tlc.CorePlan(cs, ce, n, tile, sort_key=key, mode="rows")
    for data in (arrays, batched):
        block = tlc.gather_group_params(data, got[0])
        assert_same(block, jlp.gather_group_params(data, want[0]))
        assert block.flags["C_CONTIGUOUS"]
        assert_same(tlc.group_min_y(block), jlp.group_min_y(block))
        tensors = {k: torch.as_tensor(v) for k, v in data.items()}
        assert_same(plan.group_params(tensors).numpy(), block)
    assert np.all(block[..., tlc.YMIN_ROW + 1:, :] == 0)


def test_strided_line_ranges_identical():
    kin, npv, n = small_kin()
    s = np.asarray(kin["s_idx"]).astype(np.int64)
    for stride, chunk in ((256, 128), (512, 256), (128, 128)):
        assign = np.clip(s, 0, None) // stride
        num_tiles = (n - 1) // stride + 1
        for got, want in zip(
                tlc.strided_line_ranges(assign, num_tiles, chunk),
                jlp.strided_line_ranges(assign, num_tiles, chunk)):
            assert_same(got, want)
    empty = np.zeros(0, np.int64)
    for got, want in zip(tlc.strided_line_ranges(empty, 5),
                         jlp.strided_line_ranges(empty, 5)):
        assert_same(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_atmosphere_packed_identical(atmosphere_dataset, atmosphere, dtype):
    """Atmosphere.shape and packed() (tests/test_atmosphere.py:38-43) on the
    canonical column, equal to the JAX package's."""
    from pylbl_tpu.atmosphere import Atmosphere as JAtmosphere
    from pylbl_tpu_torch.atmosphere import Atmosphere as TAtmosphere

    got, want = TAtmosphere(atmosphere_dataset), JAtmosphere(
        atmosphere_dataset)
    assert got.shape == want.shape == (4,)
    p, t, vmr = got.packed(dtype)
    assert p.shape == (4,)
    assert t[-1] == np.asarray(atmosphere.t[-1], dtype)
    assert vmr["H2O"][-1] == np.asarray(atmosphere.vmr["water_vapor"][-1],
                                        dtype)
    jp, jt, jvmr = want.packed(dtype)
    assert_same(p, jp)
    assert_same(t, jt)
    assert list(vmr) == list(jvmr)
    for name in vmr:
        assert_same(vmr[name], jvmr[name])
