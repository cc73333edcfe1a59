"""The port's single-gas engine against the JAX package's.

``accumulate_device`` / ``make_device_plan`` (one layer) and
``make_batched_fn`` (a layer batch) on CPU tensors, which run the kernels'
plain versions, against ``accumulate_tpu`` / ``make_device_plan`` and
``make_batched_tpu_fn`` with the Pallas kernels in interpret mode, at
rel < 5e-6 (floor 1e-7 of the maximum, as tests/test_lineshape_pallas.py);
the port's ``Gas`` against the JAX engine with its pedestal functions; and
the H2O golden scalars through the port's float64 plain ``Gas``.  The
small workload is the one of tests/test_lineshape_pallas.py:13-22.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.models.lines import internal_grid
from pylbl_tpu.models.lines import pedestal as jped
from pylbl_tpu.models.lines.physics import kernel_inputs, line_profile_params
from pylbl_tpu.ops import lineshape as jls
from pylbl_tpu.ops import lineshape_pallas as jlp
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.models.lines import Gas, LinePack
from pylbl_tpu_torch.ops import lineshape as tls
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel import lines as tlines

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SURFACE = (288.99, 98388.0, 6.637074e-03)
T2 = np.asarray([288.99, 227.74], np.float32)
P2 = np.asarray([98388.0, 1032.0], np.float32)
X2 = np.asarray([6.637074e-03, 4.763972e-06], np.float32)
MODES = [(None, None), (None, "tile"), (None, "seg"), ("seg", None),
         ("rows", None), ("rows", "tile")]


def small_pack():
    return synthetic_line_pack(num_lines=120, nu_min=30.0, nu_max=280.0,
                               seed=11, band_centers=(150.0,))


def port_pack(pack):
    return LinePack(formula=pack.formula,
                    **{f: getattr(pack, f) for f in LinePack._ARRAY_FIELDS})


def workload(step=0.2, cond=SURFACE, pack=None):
    pack = pack or small_pack()
    grid = np.arange(50.0, 250.0, step)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    params = line_profile_params(pack, *cond, keep=keep)
    return kernel_inputs(params, v0, npv, 25), npv, n


def rel_err(got, want, floor=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * floor)).max())


@pytest.mark.parametrize("step,tile", [(0.2, 256), (0.2, 1024), (0.02, 256)])
@pytest.mark.parametrize("core_mode,wings_mode", MODES)
def test_accumulate_device_matches_jax(step, tile, core_mode, wings_mode):
    kin, npv, n = workload(step)
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    jarrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    if core_mode is None and wings_mode is None:
        got = lc.accumulate_device(arrays, kin, n, npv, 25, tile=tile,
                                   chunk=128, device="cpu")
        want = np.asarray(jlp.accumulate_tpu(jarrays, kin, n, npv, 25,
                                             tile=tile, chunk=128,
                                             interpret=True))
    else:
        got = lc.make_device_plan(arrays, kin, n, npv, 25, tile=tile,
                                  chunk=128, core_mode=core_mode,
                                  wings_mode=wings_mode, device="cpu")()
        want = np.asarray(jlp.make_device_plan(
            jarrays, kin, n, npv, 25, tile=tile, chunk=128, interpret=True,
            core_mode=core_mode, wings_mode=wings_mode)())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got.numpy(), want) < 5e-6


def test_empty_line_list():
    """Analogue of tests/test_lineshape_pallas.py:60."""
    kin, npv, n = workload()
    empty = {k: v[:0] for k, v in
             tls.prepare_kernel_arrays(kin, npv, np.float32).items()}
    out = lc.accumulate_device(empty, kin, n, npv, 25, device="cpu")
    assert np.array_equal(out.numpy(), np.zeros(n, dtype=np.float32))


def test_seg_pass_matches_scalar_core():
    """Analogue of tests/test_lineshape_pallas.py:166: the segment-32 core
    pass equals the scalar (per-line) core pass up to addition order."""
    kin, npv, n = workload()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    tile, chunk = 256, 128
    soa, _ = lc.pack_lines_soa(arrays, chunk)
    s = arrays["s_idx"].astype(np.int64)
    e = arrays["e_idx"].astype(np.int64)
    core_w = tls.core_halfwidth({"y": kin["y"], "repwid": kin["repwid"]},
                                npv, 25)
    center = np.rint(arrays["c_int"]).astype(np.int64)
    c_start, c_n = lc.tile_line_ranges(np.maximum(center - core_w, s),
                                       np.minimum(center + core_w, e),
                                       n, tile, chunk)
    scalar = lc.tile_pass(torch.as_tensor(soa), c_start, c_n, n, tile, chunk,
                          "core").numpy()
    cs, ce = lc.core_instance_windows(arrays, kin, n, npv, 25)
    plan = lc.CorePlan(cs, ce, n, tile, sort_key=arrays["y"], mode="seg",
                       chunk=chunk)
    got = plan.seg_pass(torch.as_tensor(plan.gather(arrays))).numpy()
    scale = np.abs(scalar).max()
    assert scale > 0
    np.testing.assert_allclose(got, scalar, atol=scale * 1e-6)


def test_seg_pass_batched_matches_per_layer():
    """Analogue of tests/test_lineshape_pallas.py:199: the layer-batched
    segment pass equals the per-layer pass bit for bit."""
    pack = synthetic_line_pack(num_lines=90, nu_min=30.0, nu_max=280.0,
                               seed=7, band_centers=(150.0,))
    conds = [(250.0, 80000.0, 0.004), SURFACE]
    kins, arrs = [], []
    for cond in conds:
        kin, npv, n = workload(cond=cond, pack=pack)
        kins.append(kin)
        arrs.append(tls.prepare_kernel_arrays(kin, npv, np.float32))
    batched = {k: np.stack([a[k] for a in arrs]) for k in arrs[0]}
    s_idx = batched["s_idx"].astype(np.int64)
    e_idx = batched["e_idx"].astype(np.int64)
    center = np.rint(batched["c_int"]).astype(np.int64)
    core_w = tls.core_halfwidths(
        np.stack([k["repwid"] for k in kins]).min(axis=0), npv, 25)
    cs = np.maximum(center - core_w, s_idx).min(axis=0)
    ce = np.minimum(center + core_w, e_idx).max(axis=0)
    ce = np.where((batched["y"] >= 70.55).all(axis=0), cs - 1, ce)
    plan = lc.CorePlan(cs, ce, n, 256, sort_key=batched["y"].min(axis=0),
                       mode="seg")
    got = plan.seg_pass(torch.as_tensor(plan.gather(batched))).numpy()
    for b in range(len(conds)):
        want = plan.seg_pass(torch.as_tensor(plan.gather(arrs[b]))).numpy()
        np.testing.assert_array_equal(got[b], want)


def test_seg_wings_matches_tile_wings():
    """Analogue of tests/test_lineshape_pallas.py:276."""
    kin, npv, n = workload()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    tile, chunk = 256, 128
    soa, _ = lc.pack_lines_soa(arrays, chunk)
    s = arrays["s_idx"].astype(np.int64)
    e = arrays["e_idx"].astype(np.int64)
    w_start, w_n = lc.tile_line_ranges(s, e, n, tile, chunk)
    tile_wings = lc.tile_pass(torch.as_tensor(soa), w_start, w_n, n, tile,
                              chunk, "wings").numpy()
    wp = lc.CorePlan(s, e, n, tile, mode="seg", kind="wings", chunk=chunk)
    idx = np.maximum(wp.inst_line, 0)
    ka_inst = {k: arrays[k][idx] for k in ("c_int", "c_frac",
                                           "scaled_repwid", "y",
                                           "prefactor", "s_idx", "e_idx")}
    got = wp.seg_pass(torch.as_tensor(wp.wings_params(ka_inst))).numpy()
    np.testing.assert_allclose(got, tile_wings,
                               atol=np.abs(tile_wings).max() * 1e-6)


def test_device_plan_wings_modes_agree():
    """Analogue of tests/test_lineshape_pallas.py:305."""
    kin, npv, n = workload()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    plans = {mode: lc.make_device_plan(arrays, kin, n, npv, 25, tile=256,
                                       chunk=128, wings_mode=mode,
                                       device="cpu")
             for mode in ("seg", "tile")}
    assert plans["seg"].wings is not None and plans["tile"].wings is None
    a, b = plans["seg"]().numpy(), plans["tile"]().numpy()
    np.testing.assert_allclose(a, b, atol=np.abs(b).max() * 1e-6)


def test_rows_core_mode_is_refused():
    """core_mode="rows" is no longer refused: with wings_mode="seg" it
    takes the strided branch (the JAX planner's dispatch) and matches the
    JAX plan; only the segment-mode methods refuse a rows plan, as the JAX
    ones do."""
    kin, npv, n = workload()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    plan = lc.make_device_plan(arrays, kin, n, npv, 25, core_mode="rows",
                               wings_mode="seg", device="cpu")
    want = jlp.make_device_plan(
        jls.prepare_kernel_arrays(kin, npv, np.float32), kin, n, npv, 25,
        interpret=True, core_mode="rows", wings_mode="seg")
    assert plan.wings is None and plan.wings_stride == want.wings_stride
    assert plan.core.mode == "rows" and plan.groups.shape[0] == 64
    assert rel_err(plan().numpy(), np.asarray(want())) < 5e-6
    with pytest.raises(ValueError, match="seg"):
        plan.core.seg_pass(plan.groups)


def test_accumulate_batched_matches_jax():
    """The layer-batched two-pass (per-layer splat CSRs, one core plan over
    the union windows) against accumulate_tpu_batched, and each layer
    against the single-layer device plan."""
    pack = small_pack()
    grid = np.arange(50.0, 250.0, 0.2)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    conds = np.asarray([(250.0, 80000.0, 0.004), SURFACE]).T
    kin = kernel_inputs(line_profile_params(pack, *conds, keep=keep), v0,
                        npv, 25)
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    assert arrays["y"].shape[0] == 2
    lc.reset_launches()
    got = lc.accumulate_batched(arrays, kin, n, npv, 25, tile=256,
                                chunk=128, device="cpu").numpy()
    assert sum(lc.LAUNCHES.values()) == 0
    want = np.asarray(jlp.accumulate_tpu_batched(
        jls.prepare_kernel_arrays(kin, npv, np.float32), kin, n, npv, 25,
        tile=256, chunk=128, interpret=True))
    assert got.shape == want.shape == (2, n)
    assert rel_err(got, want) < 5e-6
    for b in range(2):
        one = {k: v[b] for k, v in arrays.items()}
        kin_b = {k: np.asarray(v)[b] for k, v in kin.items()}
        single = lc.accumulate_device(one, kin_b, n, npv, 25, tile=256,
                                      chunk=128, device="cpu").numpy()
        assert rel_err(got[b], single) < 5e-6


@pytest.mark.parametrize("remove_pedestal", [False, True])
def test_gas_matches_jax_engine(remove_pedestal):
    """Port Gas (one layer, float32, plain kernel versions on the CPU)
    against JAX accumulate_tpu + compute_pedestals / apply_pedestal: 5e-6
    without the pedestal; with it, the tests/test_multigas.py:110
    tolerance (5e-4, floor 1e-6), since the pedestal subtraction leaves
    points that cancel to near zero."""
    pack = small_pack()
    grid = np.arange(50.0, 250.0, 0.2)
    got = Gas(port_pack(pack), "H2O", device="cpu").absorption_coefficient(
        *SURFACE, grid, remove_pedestal=remove_pedestal)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    params = line_profile_params(pack, *SURFACE, keep=keep)
    kin = kernel_inputs(params, v0, npv, 25)
    want = np.asarray(jlp.accumulate_tpu(
        jls.prepare_kernel_arrays(kin, npv, np.float32), kin, n, npv, 25,
        interpret=True), np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    if not remove_pedestal:
        assert rel_err(got, want) < 5e-6
        return
    kin_ped = dict(kin, nu_raw=pack.nu[:keep], nu_shift=params["nu_shift"])
    ped = jped.compute_pedestals(want, kin_ped, n, npv, 25)
    want = jped.apply_pedestal(want, ped, kin["s_idx"], kin["e_idx"], n)
    assert rel_err(got, want, 1e-6) < 5e-4


@pytest.mark.parametrize("tile,core_mode", [(256, None), (1024, None),
                                            (1024, "seg"), (256, "seg"),
                                            (1024, "rows"), (256, "rows")])
def test_batched_fn_matches_jax(tile, core_mode):
    pack = small_pack()
    grid = np.arange(50.0, 250.0, 0.2)
    fn = tlines.make_batched_fn(port_pack(pack), grid, tile=tile, chunk=128,
                                core_mode=core_mode, device="cpu")
    jfn = jlines.make_batched_tpu_fn(pack, grid, tile=tile, chunk=128,
                                     core_mode=core_mode, interpret=True)
    assert (fn.wings_stride is None) == (jfn.wings_stride is None) \
        == (tile == 256)
    # The SoA rows are prepacked except for the splat under a "seg" or
    # "rows" core (JAX's wings_prepacked handle reports the stride alone).
    assert fn.wings_prepacked == (tile == 1024 or core_mode is None)
    assert fn.wings_tail_csr is None
    got = fn(T2, P2, X2).numpy()
    want = np.asarray(jfn(T2, P2, X2))
    assert got.shape == want.shape == (2, internal_grid(grid)[3])
    assert rel_err(got, want) < 5e-6
    np.testing.assert_array_equal(fn.inner(T2, P2, X2).numpy(), got)
    soa, core = fn.assemble_layer(T2[1], P2[1], X2[1])
    assert soa.dim() == 2 and core.dim() == 2
    assert core.shape[0] == (64 if core_mode == "rows" else 8)


def test_batched_fn_envelope_guard():
    """Analogue of tests/test_parallel.py:83."""
    pack = port_pack(synthetic_line_pack(num_lines=64, nu_min=0.7,
                                         nu_max=60.0, seed=4))
    fn = tlines.make_batched_fn(pack, np.arange(1.0, 50.0, 0.5),
                                t_max=350.0, p_max_atm=5.0, device="cpu")
    with pytest.raises(ValueError, match="t_max"):
        fn(np.asarray([400.0]), np.asarray([1e5]), np.asarray([1e-3]))
    with pytest.raises(ValueError, match="p_max_atm"):
        fn(np.asarray([288.0]), np.asarray([6e5]), np.asarray([1e-3]))


def test_batched_bitwise_determinism():
    """Analogue of tests/test_parallel.py:354: repeated calls are
    bit-identical."""
    pack = port_pack(synthetic_line_pack(num_lines=400, nu_min=0.5,
                                         nu_max=120.0, seed=3))
    fn = tlines.make_batched_fn(pack, np.arange(1.0, 100.0, 0.1), tile=256,
                                chunk=128, device="cpu")
    a, b = fn(T2, P2, X2).numpy(), fn(T2, P2, X2).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 0


def test_gas_batch_matches_single_layers():
    """The batched pipeline and the single-layer plan give the same
    spectra, with and without the pedestal, and the batch pipeline is
    built once per grid."""
    gas = Gas(port_pack(small_pack()), "H2O", device="cpu")
    grid = np.arange(50.0, 250.0, 0.2)
    for ped in (False, True):
        batch = gas.absorption_coefficient_batch(T2, P2, X2, grid,
                                                 remove_pedestal=ped)
        for i in range(2):
            single = gas.absorption_coefficient(T2[i], P2[i], X2[i], grid,
                                                remove_pedestal=ped)
            assert rel_err(batch[i], single, 1e-6) < 5e-5
    assert len(gas._batched_fns) == 1


# Oracle-computed anchors on tests/data/h2o_frozen.lpk.npz, surface layer,
# grid 1-3250 @0.1 cm-1 (tests/test_goldens.py:45-48).
@pytest.mark.parametrize("remove_pedestal,log_max,log_sum", [
    (False, -52.29384204610783, -47.584943918810545),
    (True, -52.29394886463197, -47.586756746157604)])
def test_h2o_golden_scalars_float64_plain(remove_pedestal, log_max, log_sum):
    grid = np.arange(1.0, 3250.0, 0.1)
    gas = Gas(LinePack.load(DATA / "h2o_frozen.lpk.npz"), "H2O",
              dtype=torch.float64, backend="plain", device="cpu")
    k = gas.absorption_coefficient(288.99, 98388.0, 6.637074e-03, grid,
                                   remove_pedestal=remove_pedestal)
    k = k[:grid.size]
    assert np.log(k.max()) == pytest.approx(log_max, rel=1e-6)
    assert np.log(np.sum(k * 0.1)) == pytest.approx(log_sum, rel=1e-6)


def test_split_device_plan_matches_jax():
    """The single-layer device plan on a dense line cluster at 1032 Pa
    (where the cores are not pure Lorentzian), whose core tile and strided
    wings tile walk more than 2K chunks (several pieces), against the JAX
    device plan: the core alone to 1e-6 of its scale, the spectrum to
    5e-6."""
    dense = synthetic_line_pack(num_lines=4000, nu_min=100.0, nu_max=103.0,
                                seed=31, band_centers=(101.5,))
    kin, npv, n = workload(cond=(227.74, 1032.0, 4.763972e-06), pack=dense)
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    jarrays = jls.prepare_kernel_arrays(kin, npv, np.float32)
    plan = lc.make_device_plan(arrays, kin, n, npv, 25, tile=1024, chunk=128,
                               device="cpu")
    want = jlp.make_device_plan(jarrays, kin, n, npv, 25, tile=1024,
                                chunk=128, interpret=True)
    assert plan.wings_stride is not None
    assert int(plan.core.t_chunks.max()) > 2 * lc.PIECE_CHUNKS
    assert int(plan.w_n.max()) > 2 * lc.PIECE_CHUNKS
    core = plan.core_pass().numpy()
    want_core = np.asarray(jlp._pallas_seg_pass_mixed(
        jnp.asarray(plan.groups.numpy()), plan.core.t_start,
        plan.core.t_chunks, n, 1024, 128, interpret=True))
    scale = np.abs(want_core).max()
    assert scale > 0
    np.testing.assert_allclose(core, want_core, rtol=0, atol=scale * 1e-6)
    assert rel_err(plan().numpy(), np.asarray(want())) < 5e-6


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _entry_calls():
    """Each public entry point called with its default device."""
    from pylbl_tpu_torch import Spectroscopy

    kin, npv, n = workload()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    batch = {k: np.stack([v, v]) for k, v in arrays.items()}
    kin_b = {k: np.stack([v, v]) for k, v in kin.items()}
    pack = port_pack(small_pack())
    grid = np.arange(50.0, 250.0, 0.2)
    return {
        "Spectroscopy": lambda: Spectroscopy(None, grid, None),
        "Gas": lambda: Gas(pack, "H2O").absorption_coefficient(*SURFACE,
                                                                grid),
        "Gas batch": lambda: Gas(pack, "H2O").absorption_coefficient_batch(
            T2, P2, X2, grid),
        "make_batched_fn": lambda: tlines.make_batched_fn(pack, grid),
        "make_multigas_batched_fn": lambda: tlines.make_multigas_batched_fn(
            {"H2O": pack}, grid),
        "make_device_plan": lambda: lc.make_device_plan(arrays, kin, n, npv,
                                                        25),
        "accumulate_device": lambda: lc.accumulate_device(arrays, kin, n, npv,
                                                          25),
        "accumulate_batched": lambda: lc.accumulate_batched(batch, kin_b, n,
                                                            npv, 25),
    }


@pytest.mark.parametrize("entry", ["Spectroscopy", "Gas", "Gas batch",
                                   "make_batched_fn",
                                   "make_multigas_batched_fn",
                                   "make_device_plan", "accumulate_device",
                                   "accumulate_batched"])
def test_entry_points_default_to_the_card(no_card, entry):
    """The public entry points run on the card unless the caller asks for
    the CPU: without a card their default raises, with no fallback."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_calls()[entry]()
