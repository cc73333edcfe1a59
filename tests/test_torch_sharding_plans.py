"""The port's line-sharding planners and single-process runtime paths
against the JAX package's (no rank processes).

parallel/shard_plans.py carries numpy copies of the JAX planners
(pylbl_tpu/parallel/lines.py ``shard_line_pack`` .. ``_build_ring_plans``);
each is held byte-identical to its original on the single-gas and the
gas-stacked layouts at spec 2, 4 and 8, in every mode.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu.database import fixtures as jfix
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.database import fixtures as tfix
from pylbl_tpu_torch.parallel import distributed as tdist
from pylbl_tpu_torch.parallel import mesh as tmesh
from pylbl_tpu_torch.parallel import shard_plans as sp

torch.set_num_threads(1)

SINGLE_GRID = np.arange(1.0, 320.0, 0.5)
STACKED_GRID = np.arange(1.0, 220.0, 0.2)
MODES = ["halo", "ring", "balanced"]
SPECS = [2, 4, 8]


def single(module):
    return module.synthetic_line_pack(num_lines=400, nu_min=0.6,
                                      nu_max=360.0, seed=31)


def stacked(module):
    return {"H2O": module.synthetic_line_pack(
                "H2O", num_lines=300, nu_min=0.6, nu_max=260.0, seed=21,
                band_centers=(150.0,)),
            "CO2": module.synthetic_line_pack(
                "CO2", num_lines=200, nu_min=0.6, nu_max=260.0, seed=22,
                band_centers=(60.0, 200.0)),
            "O3": module.synthetic_line_pack(
                "O3", num_lines=100, nu_min=0.6, nu_max=260.0, seed=23,
                band_centers=(100.0,))}


def assert_same(a, b, path="plan"):
    """Equal structure, dtypes, shapes and bytes."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            assert_same(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


def sharded(layout, spec, mode):
    """(JAX result, port result) of shard_line_pack or
    shard_stacked_packs (blocks, q_table, static, info[, names])."""
    if layout == "single":
        return (jlines.shard_line_pack(single(jfix), SINGLE_GRID, spec,
                                       mode=mode),
                sp.shard_line_pack(single(tfix), SINGLE_GRID, spec,
                                   mode=mode))
    return (jlines.shard_stacked_packs(stacked(jfix), STACKED_GRID, spec,
                                       mode=mode),
            sp.shard_stacked_packs(stacked(tfix), STACKED_GRID, spec,
                                   mode=mode))


@pytest.mark.parametrize("layout", ["single", "stacked"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_blocks_match_jax(layout, spec, mode):
    """shard_line_pack / shard_stacked_packs (through _partition_lines and
    _slice_blocks): blocks, q_table, static and info byte-identical."""
    j_out, t_out = sharded(layout, spec, mode)
    assert_same(j_out, t_out)
    info = t_out[3]
    assert info["mode"] == mode
    if mode != "halo":
        assert info["duplication"] == 1.0


@pytest.mark.parametrize("layout", ["single", "stacked"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", MODES)
def test_shard_plans_match_jax(layout, spec, mode):
    """_build_shard_plans / _build_ring_plans (the tile giving a stride on
    each layout), their per-shard window helpers and the pads
    byte-identical to the JAX ones."""
    j_out, t_out = sharded(layout, spec, mode)
    blocks, _, static, info = t_out[:4]
    tile = 256 if layout == "single" else 1024
    for s in range(spec):
        blk = {k: v[s] for k, v in blocks.items()}
        windows = sp._shard_window_arrays(blk, static)
        assert_same(jlines._shard_window_arrays(blk, static), windows)
        assert_same(jlines._shard_core_windows(blk, static, *windows,
                                               350.0, 5.0),
                    sp._shard_core_windows(blk, static, *windows, 350.0,
                                           5.0))
    j_build = jlines._build_ring_plans if mode == "ring" \
        else jlines._build_shard_plans
    t_build = sp._build_ring_plans if mode == "ring" \
        else sp._build_shard_plans
    want = j_build(j_out[0], j_out[2], j_out[3], tile, 350.0, 5.0)
    got = t_build(blocks, static, info, tile, 350.0, 5.0)
    assert want is not None and got is not None
    assert_same(want, got)
    # One rank's own plan is row s of the stacked one, padded as JAX pads.
    s = spec - 1
    if mode == "ring":
        steps, _ = sp.ring_plan_list(blocks, static, info, tile, 350.0, 5.0,
                                     shards=[s])
        for row, per in zip(want[0], steps):
            entry = per[0][0]
            for key, value in entry.items():
                size = row[key].shape[1] if row[key].ndim == 2 else None
                fill = sp._RING_FILLS.get(key)
                padded = value if fill is None \
                    else sp._pad_1d(value, size, fill)
                assert_same(row[key][s], padded, key)
    else:
        (plan, _, _), = sp.shard_plan_list(blocks, static, info, tile,
                                           350.0, 5.0, shards=[s])[0]
        m_max = want[0]["assign"].shape[1]
        assert_same(want[0]["assign"][s],
                    sp._pad_1d(plan["assign"], m_max, -1.0))
        assert_same({k: v[s] for k, v in want[0]["lines"].items()},
                    sp._pad_line_dict(plan["lines"], m_max))


def test_wide_windows_have_no_stride():
    """No stride fits a 0.2 cm-1 window in 256-point tiles: both packages'
    plan functions return None (the step then takes the portable branch)."""
    j_out, t_out = sharded("stacked", 4, "balanced")
    assert jlines._build_shard_plans(j_out[0], j_out[2], j_out[3], 256,
                                     350.0, 5.0) is None
    assert sp._build_shard_plans(t_out[0], t_out[2], t_out[3], 256, 350.0,
                                 5.0) is None


def test_empty_ring_pair_gets_the_all_dead_plan():
    """A (block, slab) pair with no line reaching the slab gets the
    all-dead plan of lines.py:1204-1225, equal to the JAX one."""
    _, t_out = sharded("stacked", 4, "ring")
    blocks, _, static, info = t_out[:4]
    steps, meta = sp.ring_plan_list(blocks, static, info, 1024, 350.0, 5.0)
    empty = [(i, d) for i, per in enumerate(steps)
             for d, (entry, lay, _) in enumerate(per) if lay is None]
    assert empty, "the layout has an empty ring pair"
    stacked_plans, _ = sp._build_ring_plans(blocks, static, info, 1024,
                                            350.0, 5.0)
    for i, d in empty:
        entry = steps[i][d][0]
        assert entry["wsel"].size == sp.lc.STRIDED_CHUNK
        assert entry["wdead"].all() and not entry["w_n"].any()
        assert entry["isel"].size == 0 and not entry["t_chunks"].any()
        assert stacked_plans[i]["idead"][d].all()


def test_ring_plans_hold_indices():
    """tests/test_parallel.py:298: the ring plans hold gather indices, not
    expanded line constants."""
    _, t_out = sharded("single", 8, "ring")
    plans, _ = sp._build_ring_plans(t_out[0], t_out[2], t_out[3], 256, 350.0,
                                    5.0)
    for plan in plans:
        assert "lines" not in plan and "inst" not in plan
        assert plan["wsel"].dtype == np.int32
        assert plan["isel"].dtype == np.int32


def test_pads_match_jax():
    v = np.arange(5, dtype=np.float32) + 1
    for size, fill in ((8, None), (8, 0.0), (3, 1.0)):
        assert_same(jlines._pad_1d(v, size, fill), sp._pad_1d(v, size, fill))
    consts = {"sw": v, "nu": v * 2, "q_row": np.arange(5, dtype=np.int32)}
    assert_same(jlines._pad_line_dict(consts, 9),
                sp._pad_line_dict(consts, 9))


def test_single_process_runtime():
    """tests/test_parallel.py:20 and :234 without a cluster: initialize()
    is a no-op, rows stay whole, and a mesh needs a process group (none is
    invented)."""
    assert tdist.initialize() is False
    assert tdist.process_local_rows(10) == slice(0, 10)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(batch=1, spec=1, device="cpu")
