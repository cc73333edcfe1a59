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
                                        (1024, 512)])
def test_tile_line_ranges_identical(stacked, tile, chunk):
    _, (ta, th, ts, _) = stacked
    s_wide, e_wide, _, _, _ = windows(th, ta, ts)
    n = ts["flat_points"]
    for got, want in zip(tlc.tile_line_ranges(s_wide, e_wide, n, tile, chunk),
                         jlp.tile_line_ranges(s_wide, e_wide, n, tile,
                                              chunk)):
        assert_same(got, want)


@pytest.mark.parametrize("tile,tail", [(512, 128), (512, None),
                                       (1024, 128), (256, None)])
def test_plan_strided_stage_identical(stacked, tile, tail):
    _, (ta, th, ts, _) = stacked
    s_wide, e_wide, core_lo, core_hi, y_ref = windows(th, ta, ts)
    n = ts["flat_points"]
    window = int((e_wide - s_wide).max()) + 1
    assert tlc.pick_wings_stride(tile, window) == \
        jlp.pick_wings_stride(tile, window)
    got = tlc.plan_strided_stage(s_wide, e_wide, core_lo, core_hi, y_ref, n,
                                 tile=tile, tail=tail)
    want = jlp.plan_strided_stage(s_wide, e_wide, core_lo, core_hi, y_ref, n,
                                  tile=tile, tail=tail)
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
