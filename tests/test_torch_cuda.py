"""CUDA kernels of the port against their plain versions, on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor pylbl_tpu, so the GPU host (which has no jax) runs them with the
repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn

T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def packs():
    return {
        name: synthetic_line_pack(name, num_lines=num, nu_min=0.6,
                                  nu_max=260.0, seed=seed,
                                  band_centers=bands)
        for name, num, seed, bands in [("H2O", 3000, 21, (150.0,)),
                                       ("CO2", 2000, 22, (60.0, 200.0)),
                                       ("O3", 1000, 23, (100.0,))]}


def rel_err(got, want):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * 1e-7)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("step,tile,tail,wings_chunk", [
    (0.1, 1024, 128, None), (0.1, 1024, None, None), (0.01, 1024, 128, None),
    (0.2, 256, 128, None), (0.2, 512, 128, None), (0.1, 1024, 128, 128),
    (0.01, 1024, 128, 128)])
def test_kernels_match_plain_versions(cuda_device, step, tile, tail,
                                      wings_chunk):
    grid = np.arange(1.0, 220.0 if step > 0.05 else 120.0, step)
    fn = make_multigas_batched_fn(packs(), grid, tile=tile,
                                  wings_chunk=wings_chunk, wings_tail=tail,
                                  device=cuda_device)
    assert fn.wings_chunk == (wings_chunk or (
        lc.DEFAULT_CHUNK if fn.wings_stride is None else lc.STRIDED_CHUNK))
    soa, core = fn.assemble(T, P, VMR)
    lc.reset_launches()
    for run, arg in ((fn.wings_pass, soa), (fn.core_pass, core)):
        got = run(arg)
        want = run(arg, plain=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.is_cuda
        assert rel_err(got, want) < 5e-6
    assert sum(lc.LAUNCHES.values()) == 2
    key = "wings_splat" if fn.wings_stride is None else "wings_strided"
    assert lc.LAUNCHES[key] == 1 and lc.LAUNCHES["core_segmix"] == 1


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    fn = make_multigas_batched_fn(packs(), np.arange(1.0, 220.0, 0.1),
                                  device=cuda_device)
    soa, core = fn.assemble(T, P, VMR)
    with pytest.raises(TypeError, match="float32"):
        fn.wings_pass(soa.double())
    with pytest.raises(TypeError, match="float32"):
        fn.core_pass(core.double())
    w_start, w_n = (torch.as_tensor(a, device=cuda_device)
                    for a in fn.wings_csr)
    num_points = fn.core_plan.num_points
    with pytest.raises(ValueError, match="CSR"):
        lc.wings_strided_pass(soa, w_start[:-1], w_n[:-1], num_points,
                              1024, fn.wings_stride)
    with pytest.raises(ValueError, match="contiguous"):
        lc.wings_strided_pass(soa[:, :, ::2], w_start, w_n, num_points,
                              1024, fn.wings_stride)


def card_database(path):
    db = Database(path)
    for pack in packs().values():
        db.ingest_line_pack(pack)
    return db


def card_column(temperature=T):
    """The two-layer column of T, P and VMR with O2 and N2 added."""
    names = {"H2O": "water_vapor", "CO2": "carbon_dioxide", "O3": "ozone",
             "O2": "oxygen", "N2": "nitrogen"}
    vmr = {"H2O": VMR[:, 0], "CO2": VMR[:, 1], "O3": VMR[:, 2],
           "O2": [0.209, 0.209], "N2": [0.78, 0.78]}
    data = {"p": (["layer"], P, {"standard_name": "air_pressure"}),
            "t": (["layer"], temperature,
                  {"standard_name": "air_temperature"})}
    for name, std in names.items():
        data[name.lower()] = (["layer"], np.asarray(vmr[name]), {
            "standard_name": f"mole_fraction_of_{std}_in_air"})
    return Dataset(data_vars=data)


@pytest.mark.gpu
def test_spectroscopy_on_card_matches_cpu(cuda_device, tmp_path):
    """The main path on the card (kernels) agrees with the same path on
    the CPU (plain versions), and repeats bit for bit."""
    db = card_database(tmp_path / "gpu.db")
    atm = card_column()
    grid = np.arange(1.0, 220.0, 0.1)
    gpu = Spectroscopy(atm, grid, db, device=cuda_device)
    cpu = Spectroscopy(atm, grid, db, device="cpu")
    got = gpu.compute_absorption(output_format="total")["absorption"].data
    again = gpu.compute_absorption(output_format="total")["absorption"].data
    want = cpu.compute_absorption(output_format="total")["absorption"].data
    assert np.array_equal(got, again)
    scale = np.abs(want).max()
    assert float((np.abs(got - want) / np.maximum(np.abs(want),
                                                  scale * 1e-6)).max()) < 5e-5


@pytest.mark.gpu
def test_objects_on_one_database_share_the_stacked_pipeline(cuda_device,
                                                            tmp_path):
    """A second object on the same Database takes the first one's stacked
    pipeline and returns, bit for bit, what the first object and a fresh
    build return; ten objects hold no more than one entry more than one
    object does."""
    from pylbl_tpu_torch.utils.observability import metrics

    grid = np.arange(1.0, 220.0, 0.1)
    warmer = T + np.asarray([0.8, 0.5])  # the same 290 K bucket

    def total(db, temperature=T):
        spec = Spectroscopy(card_column(temperature), grid, db,
                            device=cuda_device)
        return spec.compute_absorption(output_format="total")[
            "absorption"].data

    db = card_database(tmp_path / "shared.db")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    first = total(db)
    torch.cuda.synchronize()
    one = torch.cuda.memory_allocated()
    metrics.reset()
    assert np.array_equal(total(db), first)
    hit = total(db, warmer)
    counters = metrics.snapshot()["counters"]
    assert counters["lines.shared_hits"] == 2
    assert "lines.builds" not in counters
    assert np.array_equal(hit, total(card_database(tmp_path / "cold.db"),
                                     warmer))
    for _ in range(7):
        total(db, warmer)
    torch.cuda.synchronize()
    ten = torch.cuda.memory_allocated()
    entry = one - before
    assert entry > 0 and abs(ten - one) <= entry


@pytest.mark.gpu
def test_blocked_absorption_equals_one_block(cuda_device, tmp_path,
                                             monkeypatch):
    """At 0.01 cm-1, two sites with the budget forced to one site a block
    give, bit for bit, what one block gives ("total" and "gas"), and a
    second request copies back through the same pinned buffers."""
    from pylbl_tpu_torch import spectroscopy
    from pylbl_tpu_torch.runtime.reuse import reuse_of
    from pylbl_tpu_torch.utils.observability import metrics

    grid = np.arange(1.0, 220.0, 0.01)
    # card_column's two layers at two sites, the second 1 K warmer.
    sites = Dataset(data_vars={
        name: (["site", "layer"],
               np.stack([var.data, var.data + (name == "t")]), var.attrs)
        for name, var in card_column().data_vars.items()})
    db = card_database(tmp_path / "blocks.db")

    def compute(output_format):
        spec = Spectroscopy(sites, grid, db, device=cuda_device)
        out = spec.compute_absorption(output_format=output_format)
        return {k: v.data for k, v in out.data_vars.items()}

    whole = {f: compute(f) for f in ("total", "gas")}
    monkeypatch.setattr(spectroscopy, "block_bytes", lambda *a: (1, 0))
    monkeypatch.setattr(spectroscopy, "block_budget", lambda device: 2)
    for output_format, want in whole.items():
        metrics.reset()
        got = compute(output_format)
        assert metrics.snapshot()["counters"]["absorption.blocks"] == 2
        assert got.keys() == want.keys()
        for key, values in want.items():
            assert got[key].dtype == values.dtype == np.float64 \
                or key == "wavenumber"
            assert np.array_equal(got[key], values), key
    buffers, = reuse_of(db).staging._free
    held = {k: b.data_ptr() for k, b in buffers._buffers.items()}
    assert held and all(b.is_pinned() for b in buffers._buffers.values())
    assert np.array_equal(compute("total")["absorption"],
                          whole["total"]["absorption"])
    assert {k: b.data_ptr() for k, b in buffers._buffers.items()} == held


# --- Single-gas kernels: tile line functions, segment passes, single-layer
# launches and the Gas engine. ---

def single_gas_layers(step, num_layers=2, pack=None, lo=1.0, hi=220.0):
    """[(kin, kernel arrays)] of a 3000-line H2O pack (or ``pack``) for
    ``num_layers`` layers on lo..hi cm-1, npv, n."""
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays

    pack = packs()["H2O"] if pack is None else pack
    grid = np.arange(lo, hi, step)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    layers = []
    for i in range(num_layers):
        params = line_profile_params(pack, T[i], P[i], VMR[i, 0], keep=keep)
        kin = kernel_inputs(params, v0, npv, 25)
        layers.append((kin, prepare_kernel_arrays(kin, npv, np.float32)))
    return layers, npv, n


def batch_of(arrays_list, batched):
    if not batched:
        return arrays_list[0]
    return {k: np.stack([a[k] for a in arrays_list]) for k in arrays_list[0]}


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_tile_line_functions_match_plain(cuda_device, tile, batched):
    from pylbl_tpu_torch.ops.lineshape import core_halfwidth

    layers, npv, n = single_gas_layers(0.1)
    arrays = [a for _, a in layers]
    soa_np = lc.pack_lines_soa(batch_of(arrays, batched), 512)[0]
    s = np.min([a["s_idx"] for a in arrays], axis=0).astype(np.int64)
    e = np.max([a["e_idx"] for a in arrays], axis=0).astype(np.int64)
    kin = layers[0][0]
    core_w = core_halfwidth(kin, npv, 25)
    center = np.rint(arrays[0]["c_int"]).astype(np.int64)
    csr = {"wings": lc.tile_line_ranges(s, e, n, tile, 512),
           "core": lc.tile_line_ranges(np.maximum(center - core_w, s),
                                       np.minimum(center + core_w, e), n,
                                       tile, 512)}
    soa = torch.as_tensor(soa_np, device=cuda_device)
    lc.reset_launches()
    for kind, counter in (("wings", "tile_lorentz"),
                          ("core", "tile_correction")):
        start, nchunks = (torch.as_tensor(a, device=cuda_device)
                          for a in csr[kind])
        got = lc.tile_pass(soa, start, nchunks, n, tile, 512, kind)
        want = lc.tile_plain(soa, start, nchunks, n, tile, 512, kind)
        torch.cuda.synchronize()
        assert got.shape == ((2, n) if batched else (n,)) and got.is_cuda
        assert rel_err(got, want) < 5e-6
        if kind == "core":                  # CORR's unit walk: bit for bit
            assert torch.equal(got, want)
        assert lc.LAUNCHES[counter] == 1
    assert sum(lc.LAUNCHES.values()) == 2


def seg_plans(layers, npv, n, tile, batched, device):
    """The segment core plan (union core windows) and wings plan (union
    wing windows) of ``layers``, each with its parameter block on
    ``device`` (the first layer, or all)."""
    arrays = [a for _, a in layers]
    data = batch_of(arrays, batched)
    cs = np.min([lc.core_instance_windows(a, k, n, npv, 25)[0]
                 for k, a in layers], axis=0)
    ce = np.max([lc.core_instance_windows(a, k, n, npv, 25)[1]
                 for k, a in layers], axis=0)
    core = lc.CorePlan(cs, ce, n, tile, sort_key=arrays[0]["y"], mode="seg")
    s = np.min([a["s_idx"] for a in arrays], axis=0).astype(np.int64)
    e = np.max([a["e_idx"] for a in arrays], axis=0).astype(np.int64)
    wings = lc.CorePlan(s, e, n, tile, mode="seg", kind="wings")
    idx = np.maximum(wings.inst_line, 0)
    wings_params = wings.wings_params({k: v[..., idx]
                                       for k, v in data.items()})
    return [(core, torch.as_tensor(core.gather(data), device=device)),
            (wings, torch.as_tensor(wings_params, device=device))]


def synthetic_seg(kind, tile, batched, device, **kwargs):
    """A synthetic segment input (tools/core_census.py
    ``synthetic_segment``: every class and region, or class-4-heavy; an
    infinite and a NaN prefactor, a NaN y, y = 0 at x = 0, dead instances,
    empty streams) on ``device``: (params, streams, CSR tensors, n)."""
    from pylbl_tpu_torch.tools.core_census import synthetic_segment

    params, t_start, t_chunks, c_slot, n = synthetic_segment(
        kind=kind, tile=tile, **kwargs)
    params = torch.as_tensor(params if batched else params[0],
                             device=device)
    streams = lc.SegStreams(t_start, t_chunks, c_slot, tile // 32)
    return params, streams, streams.tensors(device)[3:], n


def check_synthetic_seg(device, tile, batched, **kwargs):
    """The segment core (every class; class-4-heavy) and wings on
    synthetic inputs with non-finite values: bit for bit (NaN where the
    plain version's is), repeats bit for bit.  Returns the launches."""
    cases = [("core", {}), ("core", {"classes": (4, 4, 4, 1)}),
             ("wings", {})]
    for seed, (kind, extra) in enumerate(cases):
        params, streams, csr, n = synthetic_seg(kind, tile, batched, device,
                                                seed=seed, **extra, **kwargs)
        got = lc.seg_pass(params, streams, n, tile, kind=kind)
        again = lc.seg_pass(params, streams, n, tile, kind=kind)
        want = lc.seg_plain(params, *csr, n, tile, kind=kind)
        torch.cuda.synchronize()
        assert got.shape == ((2, n) if batched else (n,))
        finite = torch.isfinite(want)
        assert bool(torch.isnan(want).any()) and bool((~finite).any())
        assert float(want[finite].abs().max()) > 0
        assert nan_equal(got, want) and nan_equal(again, got)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
    return len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_seg_kernels_match_plain(cuda_device, tile, batched):
    """The segment core and wings on a real plan, and on synthetic inputs
    of every class (and class-4-heavy) with non-finite values: bit for
    bit."""
    layers, npv, n = single_gas_layers(0.1)
    lc.reset_launches()
    for plan, params in seg_plans(layers, npv, n, tile, batched,
                                  cuda_device):
        got = plan.seg_pass(params)
        want = plan.seg_pass(params, plain=True)
        torch.cuda.synchronize()
        assert got.shape == ((2, n) if batched else (n,)) and got.is_cuda
        assert float(want.abs().max()) > 0 and torch.equal(got, want)
    assert lc.LAUNCHES["seg_core"] == 1 and lc.LAUNCHES["seg_wings"] == 1
    assert sum(lc.LAUNCHES.values()) == 2
    cases = check_synthetic_seg(cuda_device, tile, batched)
    assert lc.LAUNCHES["seg_core"] + lc.LAUNCHES["seg_wings"] == \
        2 + 2 * cases


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [None, 128])
def test_single_layer_launches_match_plain(cuda_device, tail):
    """A single layer [8, N] runs the strided wings (with or without the
    tail class) and the mixed-slot core as batches of one."""
    layers, npv, n = single_gas_layers(0.1, num_layers=1)
    kin, arrays = layers[0]
    plan = lc.make_device_plan(arrays, kin, n, npv, 25, device=cuda_device)
    assert plan.wings_stride is not None and plan.soa.dim() == 2
    soa, w_start, w_n = plan.soa, plan.w_start, plan.w_n
    t_start = t_n = None
    if tail is not None:
        s = arrays["s_idx"].astype(np.int64)
        lay = lc.build_strided_layout(s, plan.wings_stride, n, tail=tail)
        ka = {k: lay.gather(v) for k, v in arrays.items()}
        for key, fill in (("prefactor", 0.0), ("s_idx", -1), ("e_idx", -2)):
            ka[key] = np.where(lay.dead, fill, ka[key]).astype(ka[key].dtype)
        soa_np = lc.pack_lines_soa(ka, 512)[0]
        soa_np[lc.PREF] = soa_np[lc.PREF] * soa_np[lc.Y] \
            * np.float32(1.0 / np.sqrt(np.pi))
        soa_np[lc.Y] = soa_np[lc.Y] * soa_np[lc.Y]
        soa = torch.as_tensor(soa_np, device=cuda_device)
        w_start, w_n, t_start, t_n = (
            torch.as_tensor(a, device=cuda_device)
            for a in (lay.w_start, lay.w_n, lay.t_start, lay.t_n))
    lc.reset_launches()
    got = lc.wings_strided_pass(soa, w_start, w_n, n, 1024,
                                plan.wings_stride, t_start=t_start, t_n=t_n)
    want = lc.wings_strided_plain(soa, w_start, w_n, n, 1024,
                                  plan.wings_stride, t_start=t_start,
                                  t_n=t_n)
    core = plan.core_pass()
    core_want = plan.core_pass(plain=True)
    torch.cuda.synchronize()
    assert got.shape == core.shape == (n,)
    assert rel_err(got, want) < 5e-6 and rel_err(core, core_want) < 5e-6
    key = "wings_strided_single" if tail is None \
        else "wings_strided_tail_single"
    assert lc.LAUNCHES[key] == 1 and lc.LAUNCHES["core_segmix_single"] == 1
    assert sum(lc.LAUNCHES.values()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("step", [0.1, 0.01])
def test_gas_on_card_matches_cpu(cuda_device, step):
    """The Gas engine on the card (kernels) against the same engine on the
    CPU (plain versions): one layer, a layer batch, with and without the
    pedestal.  The batch's float32 line physics runs on each device (its
    exp and pow differ in the last ulp between them), and the pedestal
    subtraction leaves points that cancel to near zero, so with the
    pedestal the tolerance is tests/test_multigas.py:110's (5e-4, floor
    1e-6); without it 5e-5."""
    from pylbl_tpu_torch.models.lines import Gas

    pack = packs()["H2O"]
    grid = np.arange(1.0, 220.0 if step > 0.05 else 60.0, step)
    gpu = Gas(pack, "H2O", device=cuda_device)
    cpu = Gas(pack, "H2O", device="cpu")

    def rel(got, want):
        scale = np.abs(want).max()
        return float((np.abs(got - want) / np.maximum(
            np.abs(want), scale * 1e-6)).max())

    lc.reset_launches()
    for ped, tol in ((False, 5e-5), (True, 5e-4)):
        got = gpu.absorption_coefficient(T[0], P[0], VMR[0, 0], grid,
                                         remove_pedestal=ped)
        want = cpu.absorption_coefficient(T[0], P[0], VMR[0, 0], grid,
                                          remove_pedestal=ped)
        assert rel(got, want) < tol
        batch = gpu.absorption_coefficient_batch(T, P, VMR[:, 0], grid,
                                                 remove_pedestal=ped)
        again = gpu.absorption_coefficient_batch(T, P, VMR[:, 0], grid,
                                                 remove_pedestal=ped)
        assert np.array_equal(batch, again)
        want_b = cpu.absorption_coefficient_batch(T, P, VMR[:, 0], grid,
                                                  remove_pedestal=ped)
        assert rel(batch, want_b) < tol
    single = "wings_strided_single" if step > 0.05 else "tile_lorentz"
    assert lc.LAUNCHES[single] > 0 and lc.LAUNCHES["core_segmix_single"] > 0
    assert lc.LAUNCHES["core_segmix"] > 0


# --- The rows core (K9) and the ownership-checked strided wings (K6). ---

def rows_setup(device, tile, batched, work=None):
    """The rows plan of a 3000-line H2O pack (or ``work``, a
    :func:`single_gas_layers` result) over the union of two layers' core
    windows, and its group block ([B, 64, G] or [64, G]) on ``device``."""
    layers, npv, n = work or single_gas_layers(0.1)
    arrays = [a for _, a in layers]
    cs = np.min([lc.core_instance_windows(a, k, n, npv, 25)[0]
                 for k, a in layers], axis=0)
    ce = np.max([lc.core_instance_windows(a, k, n, npv, 25)[1]
                 for k, a in layers], axis=0)
    plan = lc.CorePlan(cs, ce, n, tile, sort_key=arrays[0]["y"],
                       mode="rows")
    groups = torch.as_tensor(plan.gather(batch_of(arrays, batched)),
                             device=device)
    return plan, groups, n


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_rows_kernels_match_plain(cuda_device, tile, batched):
    """The rows core and its separate-min-y variant equal their plain
    versions bit for bit, and each other."""
    plan, groups, n = rows_setup(cuda_device, tile, batched)
    g_start, g_n = plan.walk.tensors(cuda_device)
    ymin = lc.group_min_y(groups)
    lc.reset_launches()
    got = plan.core_pass(groups)
    want = plan.core_pass(groups, plain=True)
    vmem = lc.rows_vmem_pass(groups, ymin, plan.walk, n, tile)
    vmem_want = lc.rows_plain(groups, g_start, g_n, n, tile, ymin=ymin)
    torch.cuda.synchronize()
    assert got.shape == ((2, n) if batched else (n,)) and got.is_cuda
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(vmem, vmem_want)
    assert torch.equal(vmem, got)
    key = "core_rows" if batched else "core_rows_single"
    assert lc.LAUNCHES[key] == 1 and lc.LAUNCHES["core_rows_vmem"] == 1
    assert sum(lc.LAUNCHES.values()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("tile,step", [(256, 0.5), (1024, 0.1)])
@pytest.mark.parametrize("batched", [False, True])
def test_checked_strided_wings_match_plain(cuda_device, tile, step,
                                           batched):
    """The ownership-checked strided wings on the straddle CSR equal their
    plain version bit for bit; one CSR serves both layers."""
    layers, npv, n = single_gas_layers(step)
    arrays = [a for _, a in layers]
    soa, num = lc.pack_lines_soa(batch_of(arrays, batched), 512)
    s = np.min([a["s_idx"] for a in arrays], axis=0).astype(np.int64)
    e = np.max([a["e_idx"] for a in arrays], axis=0).astype(np.int64)
    stride = lc.pick_wings_stride(tile, int((e - s).max()) + 1)
    assert stride is not None
    assign = np.clip(s, 0, None) // stride
    soa[..., lc._PAD, :num] = assign.astype(np.float32)
    soa[..., lc._PAD, num:] = -1.0
    start, nchunks = (torch.as_tensor(a, device=cuda_device) for a in
                      lc.strided_line_ranges(assign, (n - 1) // stride + 1))
    soa = torch.as_tensor(soa, device=cuda_device)
    lc.reset_launches()
    got = lc.wings_strided_checked_pass(soa, start, nchunks, n, tile, stride)
    want = lc.wings_strided_checked_plain(soa, start, nchunks, n, tile,
                                          stride)
    torch.cuda.synchronize()
    assert got.shape == ((2, n) if batched else (n,)) and got.is_cuda
    assert float(want.abs().max()) > 0 and torch.equal(got, want)
    key = "wings_strided_checked" if batched \
        else "wings_strided_checked_single"
    assert lc.LAUNCHES[key] == 1 and sum(lc.LAUNCHES.values()) == 1


@pytest.mark.gpu
def test_rows_and_checked_kernels_refuse_what_they_do_not_take(cuda_device):
    plan, groups, n = rows_setup(cuda_device, 1024, True)
    with pytest.raises(TypeError, match="float32"):
        lc.rows_pass(groups.double(), plan.walk, n, 1024)
    wide = torch.cat([groups, groups], dim=-1)[..., :groups.shape[-1]]
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        lc.rows_pass(wide, plan.walk, n, 1024)
    with pytest.raises(ValueError, match="min-y"):
        lc.rows_vmem_pass(groups, lc.group_min_y(groups)[..., :-128],
                          plan.walk, n, 1024)
    layers, npv, n = single_gas_layers(0.1)
    soa = torch.as_tensor(lc.pack_lines_soa(layers[0][1], 512)[0],
                          device=cuda_device)
    start, nchunks = (torch.zeros((n - 1) // 512 + 1, dtype=torch.int32,
                                  device=cuda_device) for _ in range(2))
    with pytest.raises(TypeError, match="float32"):
        lc.wings_strided_checked_pass(soa.double(), start, nchunks, n, 1024,
                                      512)
    with pytest.raises(ValueError, match="contiguous"):
        lc.wings_strided_checked_pass(soa[:, ::2], start, nchunks, n, 1024,
                                      512)


# --- The split chunk walks (tests/test_torch_lineshape.py's dense line
# cluster): more than 2 * PIECE_CHUNKS chunks in one tile. ---

def dense_packs():
    return {"H2O": synthetic_line_pack("H2O", num_lines=4000, nu_min=100.0,
                                       nu_max=103.0, seed=31,
                                       band_centers=(101.5,)),
            "CO2": packs()["CO2"]}


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [512, 256])
def test_split_kernels_equal_plain(cuda_device, tile):
    """Tile 512: strided wings with the tail class; tile 256: the splat.
    Both with the mixed-slot core; each kernel equals its plain version
    bit for bit and repeats bit for bit."""
    fn = make_multigas_batched_fn(dense_packs(), np.arange(1.0, 220.0, 0.2),
                                  tile=tile, chunk=128, wings_tail=128,
                                  device=cuda_device)
    assert (fn.wings_stride is None) == (tile == 256)
    assert fn.core_plan.pieces.stats()["most_chunks_tile"] \
        > 2 * lc.PIECE_CHUNKS
    assert fn.stage.wings_pieces.stats()["most_chunks_tile"] \
        > 2 * lc.PIECE_CHUNKS
    soa, core = fn.assemble(T, P, VMR)
    lc.reset_launches()
    for run, arg in ((fn.wings_pass, soa), (fn.core_pass, core)):
        got = run(arg)
        again = run(arg)
        want = run(arg, plain=True)
        torch.cuda.synchronize()
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want) and torch.equal(got, again)
    key = "wings_splat" if tile == 256 else "wings_strided"
    assert lc.LAUNCHES[key] == 2 and lc.LAUNCHES["core_segmix"] == 2


@pytest.mark.gpu
def test_split_device_plan_equals_plain(cuda_device):
    """The single-layer device plan on the dense cluster at 1032 Pa: the
    strided wings and the core, split into pieces, equal their plain
    versions bit for bit."""
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays

    pack = dense_packs()["H2O"]
    grid = np.arange(50.0, 250.0, 0.2)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    kin = kernel_inputs(line_profile_params(pack, 227.74, 1032.0,
                                            4.763972e-06, keep=keep),
                        v0, npv, 25)
    arrays = prepare_kernel_arrays(kin, npv, np.float32)
    plan = lc.make_device_plan(arrays, kin, n, npv, 25, tile=1024, chunk=128,
                               device=cuda_device)
    assert plan.wings_stride is not None
    assert int(plan.core.t_chunks.max()) > 2 * lc.PIECE_CHUNKS
    lc.reset_launches()
    for run in (plan.wings_pass, plan.core_pass):
        got = run()
        want = run(plain=True)
        torch.cuda.synchronize()
        assert float(want.abs().max()) > 0 and torch.equal(got, want)
    assert lc.LAUNCHES["wings_strided_single"] == 1
    assert lc.LAUNCHES["core_segmix_single"] == 1


# --- The mixed-slot core's lists (csrc/lineshape.cu core_needs):
# synthetic chunks of every class and Humlicek region. ---

def core_input(seed, device, **kwargs):
    from pylbl_tpu_torch.tools.core_census import synthetic_core

    params, t_start, t_chunks, n = synthetic_core(seed, **kwargs)
    return (torch.as_tensor(params, device=device),
            torch.as_tensor(t_start, device=device),
            torch.as_tensor(t_chunks, device=device), t_chunks, n)


@pytest.mark.gpu
@pytest.mark.parametrize("piece", [1, 2, 4])
@pytest.mark.parametrize("seed,tile", [(0, 256), (3, 256), (6, 1024)])
def test_core_lists_equal_plain_at_each_piece(cuda_device, seed, tile,
                                              piece):
    """Every class (a skipped chunk, K1, 2, 3, 4 with a tiny y) and every
    list, dead instances, windows outside offsets 0..31: the kernel
    equals the plain version at its piece size bit for bit, and two runs
    are bit-identical."""
    params, t_start, t_chunks, host, n = core_input(seed, cuda_device,
                                                    tile=tile)
    pieces = lc.TilePieces(host, piece=piece)
    lc.reset_launches()
    got = lc.core_segmix_pass(params, t_start, t_chunks, n, tile,
                              pieces=pieces)
    again = lc.core_segmix_pass(params, t_start, t_chunks, n, tile,
                                pieces=pieces)
    want = lc.core_segmix_plain(params, t_start, t_chunks, n, tile,
                                piece=piece)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(got, again)
    assert lc.LAUNCHES["core_segmix"] == 2
    one = lc.core_segmix_pass(params[0], t_start, t_chunks, n, tile,
                              pieces=pieces)
    assert torch.equal(one, want[0])
    assert lc.LAUNCHES["core_segmix_single"] == 1


@pytest.mark.gpu
def test_core_takes_the_whole_correction_where_a_chunk_min_y_is_nan(
        cuda_device):
    """A NaN y makes its chunk's min y NaN (the plain version's amin, as
    jnp.min), which fails every test of the JAX conds: the mixed-slot core
    gives the chunk class 4, the whole correction, and the NaN-y instance
    adds nothing (correction(x, NaN) is 0).  Equal to the plain version bit
    for bit, and to the chunk with that instance at a class-4 y and an
    empty window (tests/test_torch_seg_walk.py holds the plain version
    against the JAX kernel there)."""
    params, t_start, t_chunks, host, n = core_input(4, cuda_device,
                                                    layers=1)
    col = int(host[:2].sum()) * 128 + 40          # tile 2's first chunk
    params[0, lc.SR_Y, col] = float("nan")
    got = lc.core_segmix_pass(params, t_start, t_chunks, n, 256)
    want = lc.core_segmix_plain(params, t_start, t_chunks, n, 256)
    assert torch.equal(got, want)
    as4 = params.clone()
    as4[0, lc.SR_Y, col] = 1.0
    as4[0, lc.SR_SREL, col] = 1.0
    as4[0, lc.SR_EREL, col] = 0.0
    assert torch.equal(lc.core_segmix_plain(as4, t_start, t_chunks, n, 256),
                       want)
    assert torch.equal(lc.core_segmix_pass(as4, t_start, t_chunks, n, 256),
                       got)


@pytest.mark.gpu
def test_core_spreads_a_non_finite_prefactor_over_the_slots(cuda_device):
    """An instance of infinite prefactor: its slot's points of its window
    offsets are not finite (the whole correction times inf), and the
    tile's other slots are NaN at those offsets, as the plain version's
    (and JAX's) one-hot slot select gives 0 * inf there; the kernel equals
    the plain version bit for bit, NaN for NaN, and every other point the
    plain version without the instance."""
    params, t_start, t_chunks, host, n = core_input(4, cuda_device,
                                                    layers=1)
    col = int(host[:2].sum()) * 128 + 40          # tile 2's first chunk
    params[0, lc.SR_PREF, col] = float("inf")
    params[0, lc.SR_SREL, col] = 3.0
    params[0, lc.SR_EREL, col] = 9.0
    got = lc.core_segmix_pass(params, t_start, t_chunks, n, 256)
    gone = params.clone()
    gone[0, lc.SR_PREF, col] = 0.0
    want = lc.core_segmix_plain(gone, t_start, t_chunks, n, 256)
    bad = torch.zeros_like(got, dtype=torch.bool)
    for slot in range(8):
        bad[0, 512 + 32 * slot + 3:512 + 32 * slot + 10] = True
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.equal(got[~bad], want[~bad])
    assert nan_equal(got, lc.core_segmix_plain(params, t_start, t_chunks, n,
                                               256))


# --- The unit walk (CORR and the rows core) on synthetic walks: every
# class and region, dead lines and slots, need windows across point
# groups, non-finite prefactors, split and unsplit walks. ---

def nan_equal(got, want):
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) \
        and torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("piece", [1, 2])
@pytest.mark.parametrize("tile,csr", [(256, "core"), (256, "wings"),
                                      (1024, "core")])
def test_corr_walk_equals_plain(cuda_device, tile, csr, piece):
    """CORR's unit walk equals its plain version bit for bit at pieces of
    1 and 2 chunks, one layer and two, and repeats bit for bit; with an
    infinite and a NaN prefactor, and a NaN y with an infinite
    prefactor, it gives the plain version's NaN where the plain version
    does, and its values elsewhere: the NaN-y line takes the whole
    correction (class 4, as JAX's conds), so its window is NaN in the
    tiles whose walk holds it."""
    from pylbl_tpu_torch.tools.core_census import synthetic_corr

    soa_np, start_np, n_np, n = synthetic_corr(
        tile // 64, layers=2, tile=tile, csr=csr,
        num_tiles=max(2, 1280 // tile))
    soa = torch.as_tensor(soa_np, device=cuda_device)
    start, nchunks = (torch.as_tensor(a, device=cuda_device)
                      for a in (start_np, n_np))
    pieces = lc.TilePieces.of_csr(n_np, piece=piece)
    if piece > 1:
        assert int(n_np.max()) > piece
    lc.reset_launches()
    got = lc.tile_pass(soa, start, nchunks, n, tile, 64, "core", pieces)
    again = lc.tile_pass(soa, start, nchunks, n, tile, 64, "core", pieces)
    want = lc.tile_plain(soa, start, nchunks, n, tile, 64, "core",
                         piece=piece)
    one = lc.tile_pass(soa[1], start, nchunks, n, tile, 64, "core", pieces)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(one, want[1])
    assert lc.LAUNCHES["tile_correction"] == 3
    y = soa[0, lc.Y]
    line0 = int(start_np[1])
    pick = torch.nonzero((y[line0:line0 + 64] < 8.0)
                         & (y[line0:line0 + 64] > 0.5)).flatten()
    bad = soa.clone()
    for k, (row, value) in enumerate(((lc.PREF, float("inf")),
                                      (lc.PREF, float("nan")),
                                      (lc.Y, float("nan")))):
        bad[0, row, line0 + int(pick[k])] = value
    nan_y = line0 + int(pick[2])
    bad[0, lc.PREF, nan_y] = float("inf")
    got = lc.tile_pass(bad, start, nchunks, n, tile, 64, "core", pieces)
    want = lc.tile_plain(bad, start, nchunks, n, tile, 64, "core",
                         piece=piece)
    torch.cuda.synchronize()
    assert bool((~torch.isfinite(want)).any())
    assert nan_equal(got, want)
    s, e = (int(soa_np[0, row, nan_y]) for row in (lc.S_IDX, lc.E_IDX))
    inside = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    inside[max(s, 0):max(e + 1, 0)] = True
    walked = torch.zeros_like(inside)
    for t in range(len(n_np)):
        if start_np[t] <= nan_y < start_np[t] + 64 * n_np[t]:
            walked[tile * t:tile * (t + 1)] = True
    inside &= walked
    assert bool(inside.any()) and bool(torch.isnan(want[0][inside]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 512, 1024])
@pytest.mark.parametrize("vmem", [False, True])
def test_rows_walk_equals_plain(cuda_device, tile, vmem):
    """The rows core's unit walk equals its plain version bit for bit, one
    layer and two, with the class from row 56 or from a separate min-y
    block that moves groups to other classes, and repeats bit for bit; an
    infinite prefactor (also at an own y >= 70.55 in a walked group) gives
    the plain version's NaN, and a NaN min y (row 56, or the separate
    block) takes class 4, the whole correction, as JAX's conds: the same
    values as a min y of 1.5."""
    from pylbl_tpu_torch.tools.core_census import synthetic_rows

    groups_np, plan, n = synthetic_rows(tile // 128, layers=2, tile=tile,
                                        num_tiles=max(2, 1024 // tile))
    groups = torch.as_tensor(groups_np, device=cuda_device)
    walk = plan.walk
    g_start, g_n = walk.tensors(cuda_device)
    ymin = None
    if vmem:
        ymin = lc.group_min_y(groups).clone()
        ymin[..., 1::5] = torch.where(ymin[..., 1::5] < 70.55, 9.0,
                                      ymin[..., 1::5])
        ymin[..., 3::7] = 1.5

    def run(g, single=False, ym=ymin):
        if single:
            g = g[1]
        if ym is None:
            return lc.rows_pass(g, walk, n, tile)
        return lc.rows_vmem_pass(g, ym[1] if single else ym, walk, n, tile)

    lc.reset_launches()
    got, again, one = run(groups), run(groups), run(groups, True)
    want = lc.rows_plain(groups, g_start, g_n, n, tile, ymin=ymin)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(one, want[1])
    assert walk.pieces.per_tile.max() > 1
    ym = groups[0, lc.YMIN_ROW]
    col = int(torch.nonzero((ym < 8.0) & (ym > 0.5)).flatten()[0])
    far = int(torch.nonzero(ym < 70.55).flatten()[-1])
    bad = groups.clone()
    bad[0, 4 * 8 + 0, col] = float("inf")
    bad[0, 4 * 8 + 1, far] = float("inf")
    bad[0, 3 * 8 + 1, far] = 80.0
    nan_group = int(torch.nonzero(ym < 2.0).flatten()[1])

    def with_min(value):
        g = bad.clone()
        g[0, lc.YMIN_ROW, nan_group] = value
        y = None if ymin is None else ymin.clone()
        if y is not None:
            y[0, 0, nan_group] = value
        return g, y

    def plain_with_min(value):
        g, y = with_min(value)
        return lc.rows_plain(g, g_start, g_n, n, tile, ymin=y)

    bad, bad_ymin = with_min(float("nan"))
    got = run(bad, ym=bad_ymin)
    want = lc.rows_plain(bad, g_start, g_n, n, tile, ymin=bad_ymin)
    torch.cuda.synchronize()
    assert nan_equal(got, want)
    assert nan_equal(want, plain_with_min(1.5))
    assert not nan_equal(want, plain_with_min(80.0))


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [1, 2])
def test_corr_walk_takes_a_nan_y_line_whole(cuda_device, layers):
    """CORR on the NaN-y input (``nonfinite.nan_y_corr``: a NaN y with an
    infinite prefactor, in every layer): the kernel equals its plain
    version bit for bit, NaN at the 40 points of the line's window in
    each layer, and repeats bit for bit."""
    from pylbl_tpu_torch.tools.nonfinite import nan_y_corr

    case = nan_y_corr(layers, cuda_device)
    lc.reset_launches()
    got, again = case.run(), case.run()
    want = case.plain()
    torch.cuda.synchronize()
    assert lc.LAUNCHES["tile_correction"] == 2
    assert int(torch.isnan(want).sum()) == 40 * layers
    assert nan_equal(got, want) and nan_equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("layers,vmem", [(1, False), (2, False), (1, True)])
def test_rows_walk_takes_a_nan_min_y_group_whole(cuda_device, layers, vmem):
    """The rows core on the NaN-min-y input (``nonfinite.nan_y_rows``: slot
    0's y and the group's min y NaN, in every layer), one layer, two and
    the separate min-y block: the group's other instances take their
    whole corrections, every point finite, the kernel equal to its plain
    version bit for bit, and a repeat too."""
    from pylbl_tpu_torch.tools.nonfinite import nan_y_rows

    case = nan_y_rows(layers, cuda_device, vmem)
    lc.reset_launches()
    got, again = case.run(), case.run()
    want = case.plain()
    torch.cuda.synchronize()
    assert lc.LAUNCHES[case.counter] == 2
    assert bool(torch.isfinite(want).all()) and float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.gpu
def test_every_kernel_equals_plain_on_poisoned_lines(cuda_device):
    """Every kernel on its family's poisoned input
    (``nonfinite.family_case``: infinite and NaN prefactors, a NaN y, y =
    0 at x = 0, a NaN srw and NaN window edges): NaN where the plain
    version's is, every other bit equal, a repeat too, each counter
    launched."""
    from pylbl_tpu_torch.tools.nonfinite import KERNEL_CASES, family_case

    lc.reset_launches()
    for family, layers in KERNEL_CASES:
        case = family_case(family, layers, cuda_device)
        got, again = case.run(), case.run()
        want = case.plain()
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        assert bool(nan.any()), family
        assert torch.equal(torch.isnan(got), nan), family
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32)), family
        assert torch.equal(again.view(torch.int32),
                           got.view(torch.int32)), family
    assert all(v > 0 for v in lc.LAUNCHES.values()), lc.LAUNCHES


# --- The segment pass per chunk and the rows core per piece on the dense
# cluster (tests/test_torch_lineshape.py's split tests): streams of more
# than 8 chunks, tiles of more than 2 pieces. ---

def dense_gas_layers():
    return single_gas_layers(0.2, pack=dense_packs()["H2O"], lo=50.0,
                             hi=250.0)


@pytest.mark.gpu
@pytest.mark.parametrize("batched", [False, True])
def test_split_seg_kernels_equal_plain(cuda_device, batched):
    """The segment core and wings, summed per chunk and folded per
    stream, equal the unchanged plain version bit for bit and repeat bit
    for bit."""
    layers, npv, n = dense_gas_layers()
    lc.reset_launches()
    for plan, params in seg_plans(layers, npv, n, 256, batched,
                                  cuda_device):
        assert plan.streams.stats()["most_chunks_stream"] > 8
        got = plan.seg_pass(params)
        again = plan.seg_pass(params)
        want = plan.seg_pass(params, plain=True)
        torch.cuda.synchronize()
        assert got.shape == ((2, n) if batched else (n,))
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want) and torch.equal(got, again)
    assert lc.LAUNCHES["seg_core"] == 2 and lc.LAUNCHES["seg_wings"] == 2
    # Synthetic streams of many chunks (two slots of a tile in use), at
    # tiles 256 and 1024, with non-finite values.
    for tile in (256, 1024):
        check_synthetic_seg(cuda_device, tile, batched,
                            tile_chunks=(21, 0, 18), slots_used=2)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_split_rows_kernels_equal_plain(cuda_device, tile, batched):
    """The rows core with and without the separate min-y block, its tiles
    cut into pieces of ROWS_PIECE_GROUPS groups, equals the piece-folded
    plain version bit for bit and repeats bit for bit."""
    plan, groups, n = rows_setup(cuda_device, tile, batched,
                                 dense_gas_layers())
    walk = plan.walk
    assert walk.pieces.per_tile.max() > 2
    g_start, g_n = walk.tensors(cuda_device)
    ymin = lc.group_min_y(groups)
    lc.reset_launches()
    runs = ((lambda: lc.rows_pass(groups, walk, n, tile),
             lambda: lc.rows_plain(groups, g_start, g_n, n, tile)),
            (lambda: lc.rows_vmem_pass(groups, ymin, walk, n, tile),
             lambda: lc.rows_plain(groups, g_start, g_n, n, tile,
                                   ymin=ymin)))
    for run, run_plain in runs:
        got = run()
        again = run()
        want = run_plain()
        torch.cuda.synchronize()
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want) and torch.equal(got, again)
    key = "core_rows" if batched else "core_rows_single"
    assert lc.LAUNCHES[key] == 2 and lc.LAUNCHES["core_rows_vmem"] == 2


@pytest.mark.gpu
def test_split_kernels_refuse_what_they_do_not_take(cuda_device):
    """Rows not 16-byte aligned, a group walk off 4-group starts, and a
    stream walk of other tiles, raise."""
    plan, groups, n = rows_setup(cuda_device, 1024, True)
    shifted = torch.empty(groups.numel() + 1, device=cuda_device)[1:]
    shifted = shifted.view_as(groups).copy_(groups)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        lc.rows_pass(shifted, plan.walk, n, 1024)
    with pytest.raises(ValueError, match="group walk"):
        lc.rows_pass(groups, lc.GroupWalk(plan.g_start + 2, plan.g_n), n,
                     1024)
    layers, npv, n = single_gas_layers(0.1)
    (core, params), _ = seg_plans(layers, npv, n, 1024, True, cuda_device)
    other = lc.SegStreams(core.t_start[:-1], core.t_chunks[:-1], core.c_slot,
                          32)
    with pytest.raises(ValueError, match="stream walk"):
        lc.seg_pass(params, other, n, 1024)
    shifted = torch.empty(params.numel() + 1, device=cuda_device)[1:]
    shifted = shifted.view_as(params).copy_(params)
    with pytest.raises(ValueError, match="aligned"):
        core.seg_pass(shifted)


# --- The Lorentzian walk's edge cases on synthetic walks: windows that
# start and end inside a warp's points, warps wholly inside and outside a
# window, padded chunks, an empty tile, a tile of many pieces, the tail
# class, [B, T] CSRs that differ by layer, tiles of 256, 512 and 1024. ---

WALK_POINTS = 128        # a warp's consecutive points (32 lanes x 4)
CHUNK, TAIL = 100, 128   # a chunk that is not whole groups of 32 lines


def synthetic_walk(tile, stride, num_tiles=6, layers=2, tail=True, seed=0,
                   many=None):
    """A prepacked SoA [B, 8, N] and a per-layer [B, T] CSR (main chunks
    of CHUNK lines, with ``tail`` tail chunks of TAIL) over private
    per-tile chunks: tile 0 walks nothing, tile 1 walks ``many`` (3K + 1)
    main chunks (many pieces), the rest 1-3; layer 1 walks one chunk fewer
    where it can (the rows read as raw y and pref just as well).  Windows:
    random around the tile's points, with edges
    inside a warp's points and on its edges, some holding all of them;
    one line in five is padding (an empty window and zero strength).
    Returns (soa, csr list, num_points)."""
    rng = np.random.default_rng(seed)
    many = 3 * lc.WINGS_PIECE_CHUNKS + 1 if many is None else many
    main = np.r_[0, many, rng.integers(1, 4, num_tiles - 2)]
    tails = rng.integers(0, 3, num_tiles) if tail else np.zeros(num_tiles,
                                                                int)
    tails[0] = 0
    w_start = np.r_[0, np.cumsum(main * CHUNK)[:-1]]
    t_start = main.sum() * CHUNK + np.r_[0, np.cumsum(tails * TAIL)[:-1]]
    total = int(main.sum() * CHUNK + tails.sum() * TAIL)
    owner = np.zeros(total, int)
    for t in range(num_tiles):
        owner[w_start[t]:w_start[t] + main[t] * CHUNK] = t
        owner[t_start[t]:t_start[t] + tails[t] * TAIL] = t
    soa = np.zeros((layers, 8, total), np.float32)
    for b in range(layers):
        lo = owner * stride
        center = lo + rng.integers(-tile // 4, tile + tile // 4, total)
        ws = center - rng.choice([3, 31, 64, 200, 2 * tile], total)
        we = center + rng.integers(0, 2 * tile, total)
        # Windows on a warp's first and last points.
        edge = rng.random(total) < 0.1
        ws = np.where(edge, lo + WALK_POINTS * rng.integers(0, 4, total), ws)
        we = np.where(edge, ws + WALK_POINTS * rng.integers(1, 3, total) - 1,
                      we)
        dead = rng.random(total) < 0.2
        soa[b, lc.C_INT] = center
        soa[b, lc.C_FRAC] = rng.random(total)
        soa[b, lc.SRW] = rng.uniform(0.02, 0.6, total)
        soa[b, lc.Y] = rng.uniform(0.05, 9.0, total)
        soa[b, lc.PREF] = np.where(dead, 0.0, rng.uniform(0.1, 3.0, total))
        soa[b, lc.S_IDX] = np.where(dead, -1.0, ws)
        soa[b, lc.E_IDX] = np.where(dead, -2.0, we)
    w_n = np.stack([np.maximum(main - b, 0) for b in range(layers)])
    csr = [np.broadcast_to(w_start, w_n.shape), w_n]
    if tail:
        csr += [np.broadcast_to(t_start, w_n.shape),
                np.broadcast_to(tails, w_n.shape)]
    csr = [np.ascontiguousarray(a, np.int32) for a in csr]
    return soa, csr, stride * num_tiles


def walk_cases(soa, csr, tile, stride):
    """How often each case of the walk occurs over every (layer, tile,
    walked line, warp): a window edge inside the warp's points, a window
    holding them all, one missing them, and a padding line."""
    cases = {"edge inside a warp": 0, "warp inside a window": 0,
             "warp outside a window": 0, "padding": 0}
    classes = [(csr[0], csr[1], CHUNK)] + (
        [(csr[2], csr[3], TAIL)] if len(csr) == 4 else [])
    for b in range(soa.shape[0]):
        for t in range(csr[0].shape[1]):
            lines = [first + i for start, count, width in classes
                     for first in [int(start[b, t])]
                     for i in range(int(count[b, t]) * width)]
            for line in lines:
                ws, we = soa[b, lc.S_IDX, line], soa[b, lc.E_IDX, line]
                if we < ws:
                    cases["padding"] += 1
                    continue
                for w in range(tile // WALK_POINTS):
                    lo = t * stride + w * WALK_POINTS
                    hi = lo + WALK_POINTS - 1
                    if we < lo or ws > hi:
                        cases["warp outside a window"] += 1
                    elif ws <= lo and we >= hi:
                        cases["warp inside a window"] += 1
                    else:
                        cases["edge inside a warp"] += 1
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 512, 1024])
@pytest.mark.parametrize("form", ["strided", "tail", "splat"])
def test_walk_edge_cases_equal_plain(cuda_device, tile, form):
    """The prepacked wings on synthetic per-layer walks equal the plain
    version bit for bit and repeat bit for bit: strided (stride tile/4)
    with and without the tail class, and the splat (stride = tile); each
    layer alone gives its row of the batch."""
    stride = tile if form == "splat" else tile // 4
    soa, csr, n = synthetic_walk(tile, stride, tail=form == "tail",
                                 seed=tile)
    cases = walk_cases(soa, csr, tile, stride)
    assert all(v > 0 for v in cases.values()), cases
    counts = csr[1] + (csr[3] if len(csr) == 4 else 0)
    assert counts[:, 0].max() == 0                   # an empty tile
    pieces = lc.TilePieces.of_csr(*csr[1::2])
    assert pieces.per_tile.max() > 3                 # many pieces
    soa_d = torch.as_tensor(soa, device=cuda_device)
    dev = [torch.as_tensor(a, device=cuda_device) for a in csr]

    def run(data, rows, plain=False, pieces=None):
        if form == "splat":
            if plain:
                return lc.tile_plain(data, *rows, n, tile, CHUNK,
                                     "wings_pre")
            return lc.tile_pass(data, *rows, n, tile, CHUNK, "wings_pre",
                                pieces)
        args = (*rows[:2], n, tile, stride, CHUNK, *(rows[2:] or
                                                     [None, None]))
        if plain:
            return lc.wings_strided_plain(data, *args, tail=TAIL)
        return lc.wings_strided_pass(data, *args, tail=TAIL, pieces=pieces)

    lc.reset_launches()
    got = run(soa_d, dev, pieces=pieces)
    again = run(soa_d, dev)
    want = run(soa_d, dev, plain=True)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(got, again)
    key = "wings_splat" if form == "splat" else "wings_strided"
    assert lc.LAUNCHES[key] == 2
    for b in range(soa.shape[0]):
        assert torch.equal(run(soa_d[b], [a[b] for a in dev]), got[b])


def synthetic_straddle(tile, stride, chunk=32, layers=2, seed=0,
                       nan_lines=False):
    """Raw rows [B, 8, N] with each line's tile in _PAD and the straddle
    CSR ([T], every layer) of :func:`lc.strided_line_ranges` over the
    pass's tiles: lines on 8 of them (20 lines each, tile 1 300: a walk of
    many chunks), every chunk holding lines of two or more tiles, the
    last tiles reading the last chunk; pad lines after them (_PAD -1,
    empty windows).  ``nan_lines``: the last line of tiles 0, 2 and 4 has
    y = 0 and its center, on a whole point, past its own tile's points
    but on the next tile's, which reads it as a foreign line (0 * rcp(0)
    is NaN there).  Returns (soa, [start, nchunks], num_points, the NaN
    lines' centers)."""
    rng = np.random.default_rng(seed)
    counts = np.r_[20, 300, np.full(6, 20)]
    assign = np.repeat(np.arange(counts.size), counts)
    num = assign.size
    total = -(-num // chunk) * chunk + chunk
    soa = np.zeros((layers, 8, total), np.float32)
    for b in range(layers):
        center = assign * stride + rng.integers(-tile // 4, tile + tile // 4,
                                                num)
        soa[b, lc.C_INT, :num] = center
        soa[b, lc.C_FRAC, :num] = rng.random(num)
        soa[b, lc.SRW, :num] = rng.uniform(0.02, 0.6, num)
        soa[b, lc.Y, :num] = rng.uniform(0.05, 3.0, num)
        soa[b, lc.PREF, :num] = rng.uniform(0.1, 3.0, num)
        soa[b, lc.S_IDX, :num] = center - rng.choice([3, 31, 200, tile], num)
        soa[b, lc.E_IDX, :num] = center + rng.choice([3, 31, 200, tile], num)
    soa[:, lc._PAD, :num] = assign
    soa[:, lc._PAD, num:] = -1.0
    soa[:, lc.S_IDX, num:], soa[:, lc.E_IDX, num:] = -1.0, -2.0
    centers = []
    if nan_lines:
        ends = np.cumsum(counts) - 1
        for t in (0, 2, 4):
            line = ends[t]
            center = t * stride + tile + 10
            soa[:, lc.C_INT, line], soa[:, lc.C_FRAC, line] = center, 0.0
            soa[:, lc.Y, line] = 0.0
            soa[:, lc.S_IDX, line] = center - 5
            soa[:, lc.E_IDX, line] = center + 5
            centers.append(center)
    n = stride * (counts.size - 1) + tile
    csr = list(lc.strided_line_ranges(assign, (n - 1) // stride + 1, chunk))
    return soa, csr, n, centers


def same_bits(got, want):
    """NaN where ``want`` is NaN, and the same bits everywhere else."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32),
        torch.where(nan, 0.0, want).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("piece", [1, 2, 4])
@pytest.mark.parametrize("form", ["raw_splat", "straddle", "kept_nan"])
def test_raw_and_own_walk_equal_plain(cuda_device, form, piece):
    """The Lorentzian walk's raw line kinds equal their plain versions bit
    for bit at pieces of 1, 2 and 4 chunks, repeat bit for bit, and give
    each layer's row alone: RAW on a synthetic splat walk (``tile_pass``
    "wings", [B, T] CSRs), OWN on a synthetic straddle CSR whose every
    chunk holds foreign lines, and OWN with foreign y = 0 lines centred
    off their own tile, which it keeps at strength 0: the plain version's
    NaN at those points."""
    tile = 1024
    if form == "raw_splat":
        soa, csr, n = synthetic_walk(tile, tile, tail=False, seed=piece,
                                     many=13)
        stride, chunk, centers = tile, CHUNK, []
    else:
        stride, chunk = 256, 32
        soa, csr, n, centers = synthetic_straddle(
            tile, stride, chunk, seed=piece, nan_lines=form == "kept_nan")
    soa_d = torch.as_tensor(soa, device=cuda_device)
    dev = [torch.as_tensor(a, device=cuda_device) for a in csr]
    pieces = lc.TilePieces.of_csr(csr[1], piece=piece)
    assert pieces.per_tile.max() > 2

    def run(data, rows, plain=False):
        if form == "raw_splat":
            if plain:
                return lc.tile_plain(data, *rows, n, tile, chunk, "wings",
                                     piece=piece)
            return lc.tile_pass(data, *rows, n, tile, chunk, "wings",
                                lc.TilePieces.of_csr(rows[1], piece=piece))
        if plain:
            return lc.wings_strided_checked_plain(data, *rows, n, tile,
                                                  stride, chunk, piece=piece)
        return lc.wings_strided_checked_pass(data, *rows, n, tile, stride,
                                             chunk, pieces=pieces)

    lc.reset_launches()
    got = run(soa_d, dev)
    again = run(soa_d, dev)
    want = run(soa_d, dev, plain=True)
    torch.cuda.synchronize()
    assert float(want.nan_to_num(0).abs().max()) > 0
    assert same_bits(got, want) and same_bits(again, got)
    nan = torch.nonzero(torch.isnan(want).any(dim=0)).flatten().tolist()
    assert nan == centers                      # only the kept foreign lines
    key = "tile_lorentz" if form == "raw_splat" else "wings_strided_checked"
    assert lc.LAUNCHES[key] == 2 and sum(lc.LAUNCHES.values()) == 2
    for b in range(soa.shape[0]):
        rows = [a[b] if a.dim() == 2 else a for a in dev]
        assert same_bits(run(soa_d[b], rows), got[b])


@pytest.mark.gpu
def test_walk_refusals(cuda_device):
    """The wings launch refuses what the kernel does not take: another
    dtype, a strided block, a CSR of other tiles or layers or on another
    device, a tile other than 256/512/1024, chunks above 512 lines, a tail
    that is not a multiple of 128."""
    soa, csr, n = synthetic_walk(1024, 256, tail=False)
    soa_d = torch.as_tensor(soa, device=cuda_device)
    dev = [torch.as_tensor(a, device=cuda_device) for a in csr]
    with pytest.raises(TypeError, match="float32"):
        lc.wings_strided_pass(soa_d.double(), *dev, n, 1024, 256, CHUNK)
    with pytest.raises(ValueError, match="contiguous"):
        lc.wings_strided_pass(soa_d[:, :, ::2], *dev, n, 1024, 256, CHUNK)
    with pytest.raises(ValueError, match="CSR of shape"):
        lc.wings_strided_pass(soa_d, *(a[:, :-1] for a in dev), n, 1024,
                              256, CHUNK)
    with pytest.raises(ValueError, match="CSR of shape"):
        lc.wings_strided_pass(soa_d, *(a[:1] for a in dev), n, 1024, 256,
                              CHUNK)
    with pytest.raises(ValueError, match="CSR on"):
        lc.wings_strided_pass(soa_d, *(torch.as_tensor(a) for a in csr), n,
                              1024, 256, CHUNK)
    with pytest.raises(ValueError, match="takes tile 256/512/1024"):
        lc.wings_strided_pass(soa_d, *dev, n, 128, 256, CHUNK)
    with pytest.raises(ValueError, match="takes tile 256/512/1024"):
        lc.wings_strided_pass(soa_d, *dev, n, 1024, 256, 640)
    with pytest.raises(ValueError, match="multiple of 128"):
        lc.wings_strided_pass(soa_d, *dev, n, 1024, 256, CHUNK, *dev,
                              tail=96)


# --- The portable two-pass backend (ops/lineshape.py accumulate). ---

@pytest.mark.gpu
@pytest.mark.parametrize("step", [0.1, 0.01])
def test_portable_accumulate_on_card_matches_cpu(cuda_device, step):
    """The portable accumulation on the card against the same function on
    the CPU, float32: its per-index sums run in another order there, so
    rel 1e-5 (floor 1e-7 of the maximum); it launches no hand kernel."""
    from pylbl_tpu_torch.ops.lineshape import accumulate

    layers, npv, n = single_gas_layers(step, num_layers=1,
                                       hi=220.0 if step > 0.05 else 60.0)
    (_, arrays), = layers
    lc.reset_launches()
    got = accumulate(arrays, n, npv, 25, device=cuda_device)
    assert sum(lc.LAUNCHES.values()) == 0
    want = accumulate(arrays, n, npv, 25, device="cpu")
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5


@pytest.mark.gpu
def test_portable_paths_repeat_on_card(cuda_device):
    """The portable accumulation and the stacked "xla" pipeline repeat bit
    for bit on the card."""
    from pylbl_tpu_torch.ops.lineshape import accumulate

    layers, npv, n = single_gas_layers(0.1, num_layers=1)
    (_, arrays), = layers
    first = accumulate(arrays, n, npv, 25, device=cuda_device)
    assert torch.equal(first, accumulate(arrays, n, npv, 25,
                                         device=cuda_device))
    fn = make_multigas_batched_fn(packs(), np.arange(1.0, 220.0, 0.1),
                                  backend="xla", device=cuda_device)
    out = fn(T, P, VMR)
    assert torch.equal(out, fn(T, P, VMR))
    assert out.shape[:2] == (2, 3) and bool(torch.isfinite(out).all())


# -- the sharded path on ranks that share the card ---------------------------

SHARD_T = np.asarray([288.99, 227.74, 250.0, 203.37])
SHARD_P = np.asarray([98388.0, 1032.0, 20000.0, 11419.0])
SHARD_VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                        [4.2e-06, 3.9e-04, 7.8e-06],
                        [1e-4, 3.9e-04, 1e-07],
                        [3.0e-06, 3.9e-04, 2.6e-07]])


def _rank_sharded(mode, backend, batch, spec):
    """One rank's sharded stacked pipeline on its card: the gathered
    result, a repeat's equality, its launches and staged bytes, and its
    first stop's kernels against their plain versions."""
    from pylbl_tpu_torch.parallel import collectives
    from pylbl_tpu_torch.parallel.mesh import make_mesh
    from pylbl_tpu_torch.parallel.sharded import \
        make_multigas_sharded_pipeline

    mesh = make_mesh(batch=batch, spec=spec, device="cuda")
    fn = make_multigas_sharded_pipeline(packs(), np.arange(1.0, 220.0, 0.1),
                                        mesh, mode=mode, backend=backend)
    lc.reset_launches()
    collectives.reset_bytes()
    out = fn.full(SHARD_T, SHARD_P, SHARD_VMR, False)
    launches = dict(lc.LAUNCHES)
    staged = collectives.BYTES["host_staged"]
    again = fn.full(SHARD_T, SHARD_P, SHARD_VMR, False)
    equal = []
    if fn.step.backend == "kernel":
        stage, soa, core = fn.step.kernel_inputs(SHARD_T, SHARD_P, SHARD_VMR)
        equal = [torch.equal(stage.wings_pass(soa),
                             stage.wings_pass(soa, plain=True)),
                 torch.equal(stage.core_pass(core),
                             stage.core_pass(core, plain=True))]
    return {"k": out.cpu().numpy(), "repeat": torch.equal(out, again),
            "launches": launches, "staged": staged, "equal": equal,
            "device": str(out.device), "backend": fn.step.backend,
            "transport": mesh.transport}


@pytest.mark.gpu
def test_sharded_pipeline_on_shared_card(cuda_device):
    """Four gloo ranks on one card run the sharded stacked pipeline in each
    mode through the strided wings and mixed-slot core kernels (each
    equal to its plain version on the rank's inputs), staging their
    collectives through the host; every rank holds the same bits, a
    repeat too, within 5e-6 of the unsharded pipeline on the card."""
    from pylbl_tpu_torch.parallel import launch

    fn = make_multigas_batched_fn(packs(), np.arange(1.0, 220.0, 0.1),
                                  device=cuda_device)
    want = fn(SHARD_T, SHARD_P, SHARD_VMR)
    with launch.RankGroup(4, backend="gloo", timeout=300) as group:
        for mode in ("balanced", "halo", "ring"):
            outs = group.run_all(_rank_sharded, mode, "kernel", 2, 2)
            for out in outs:
                assert out["backend"] == "kernel" and out["repeat"]
                assert out["device"] == "cuda:0"
                assert out["transport"] == "host" and out["staged"] > 0
                assert out["launches"]["wings_strided"] >= 1
                assert out["launches"]["core_segmix"] >= 1
                assert out["equal"] == [True, True]
                assert np.array_equal(out["k"], outs[0]["k"])
            assert rel_err(torch.as_tensor(outs[0]["k"]), want) < 5e-6, mode


@pytest.mark.gpu
def test_single_rank_nccl_mesh(cuda_device):
    """One NCCL rank: the mesh moves the card's tensors (no host staging)
    and the pipeline's result equals the four gloo ranks'."""
    from pylbl_tpu_torch.parallel import launch

    with launch.RankGroup(1, backend="nccl", timeout=300) as one:
        nccl = one.run(_rank_sharded, "balanced", "kernel", 1, 1)
    assert nccl["transport"] == "device" and nccl["staged"] == 0
    assert nccl["launches"]["wings_strided"] == 1
    with launch.RankGroup(4, backend="gloo", timeout=300) as group:
        gloo = group.run(_rank_sharded, "balanced", "kernel", 2, 2)
    assert rel_err(torch.as_tensor(nccl["k"]),
                   torch.as_tensor(gloo["k"])) < 5e-6


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    """NCCL asked for with more ranks on the host than cards raises (ranks
    that share a card need gloo); the automatic choice then is gloo."""
    from pylbl_tpu_torch.parallel import distributed

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(cards + 1))
    with pytest.raises(RuntimeError, match="NCCL needs a card per rank"):
        distributed.check_nccl_devices()
    assert distributed.pick_backend() == "gloo"
    with pytest.raises(RuntimeError, match="NCCL needs a card per rank"):
        distributed.initialize(init_method="tcp://localhost:1",
                               world_size=cards + 1, rank=0,
                               backend="nccl")


@pytest.mark.gpu
def test_bench_stages_on_card(cuda_device, tmp_path):
    """The bench's stages at a small size on the card: CUDA-event timing
    inside the band, each stage's kernels launched, no host sync inside
    a timed call (config 5: in a block's dispatch), the float64 parity."""
    from pylbl_tpu_torch import bench

    pack, _ = bench.build_workload(2000)
    grid = np.arange(1.0, 500.0, 0.1)
    gases = bench.multigas_packs(2000, 500)
    stages = [
        (lambda: bench.headline(pack, grid, device=cuda_device)[0],
         ("wings_strided_single", "core_segmix_single")),
        (lambda: bench.multigas(gases, grid, 2, device=cuda_device)[0],
         ("wings_strided", "core_segmix")),
        (lambda: bench.config5(gases, np.arange(1.0, 100.0, 0.01), tmp_path,
                               num_layers=4, block=2,
                               device=cuda_device)[0],
         ("wings_splat", "core_segmix")),
    ]
    for stage, kernels in stages:
        record = bench.tracked(stage, cuda_device)
        assert all(record["launches"].get(k, 0) > 0 for k in kernels)
        assert record["host_syncs"] == {}
        assert record.get("method", record.get("device_method")) \
            == bench.METHOD
        assert record.get("max_rel_err_vs_float64", 0.0) < 5e-4
        assert record["peak_gib"] > 0


# --- The stacked pedestal remover's kernels (ops/pedestal_cuda.py). ---

# col60-0p1-default's column at its four profile levels, and its H2O: 300k
# lines over 0.5-5100 cm-1 on the 1-5000 cm-1 grid at 0.1 cm-1.
PED_T = np.asarray([269.01, 227.74, 203.37, 288.99])
PED_P = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
PED_X = np.asarray([5.244536e-06, 4.763972e-06, 3.039952e-06, 0.006637074])
PED_GRID = np.arange(1.0, 5000.0, 0.1)


def pedestal_case(device, num_lines=300_000, plain=False):
    """(GasLines, b0, nb, line_inputs, [B, n + 3] float32 field with the
    gas's points from column 3, blo, bhi, n) of one H2O-like gas."""
    from pylbl_tpu_torch.models.lines.gas import internal_grid
    from pylbl_tpu_torch.ops import pedestal_cuda as pc

    pack = synthetic_line_pack("H2O", num_lines=num_lines, nu_min=0.5,
                               nu_max=5100.0, seed=3,
                               band_centers=(150.0, 1600.0, 3700.0))
    v0, vn, n_per_v, n = internal_grid(PED_GRID)
    gas = pc.GasLines(pack, pack.compat_break_filter(v0, vn, 25))
    b0, nb, margin = gas.bucket_range(PED_P)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    ka = pc.line_inputs(gas.on(device), tensor(PED_T), tensor(PED_P),
                        tensor(PED_X), tensor(gas.q_slots(PED_T)), v0,
                        n_per_v, 25, (b0, nb, margin), n, plain=plain)
    rng = np.random.default_rng(0)
    field = torch.as_tensor(rng.uniform(1e-24, 1e-22, (PED_T.size, n + 3)),
                            dtype=torch.float32, device=device)
    blo, bhi = (torch.as_tensor(w, device=device) for w in pc.bucket_windows(
        v0, vn, n_per_v, n, 25))
    return gas, b0, nb, ka, field, blo, bhi, n


@pytest.mark.gpu
def test_pedestal_kernels_equal_plain(cuda_device):
    """The pedestal kernels against their plain versions on the card, at
    the cell's widths (4 layers): the line physics and the endpoint
    contributions within 1e-14 of each output's largest value (the same
    float64 operations; torch's and the kernels' exp and pow may differ in
    the last ulp), the scan, the bucket totals and the field bit for bit
    on the same inputs, each launched once a call; a repeat gives the same
    bits."""
    from pylbl_tpu_torch.ops import pedestal_cuda as pc

    pc.reset_launches()
    _, b0, nb, ka, field, blo, bhi, n = pedestal_case(cuda_device)
    plain = pedestal_case(cuda_device, plain=True)[3]
    for name, value in ka.items():
        assert value.is_cuda and value.dtype == plain[name].dtype
        scale = float(plain[name].double().abs().max())
        assert float((value.double() - plain[name].double()).abs().max()) \
            <= 1e-14 * scale, name
    got = pc.endpoint_contributions(ka, field, 3, n)
    want = pc.endpoint_contributions(ka, field, 3, n, plain=True)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-14 * float(w.abs().max())
    rows = (ka["bucket"], ka["s_idx"], ka["e_idx"], *want)
    ped = pc.scan(*rows, n, 51, nb)
    assert torch.equal(ped, pc.scan(*rows, n, 51, nb, plain=True))
    for dtype in (torch.float32, torch.float64):
        totals = pc.bucket_totals(ped, ka, dtype)
        assert torch.equal(totals,
                           pc.bucket_totals(ped, ka, dtype, plain=True))
        out = field.to(dtype, copy=True)
        plain = out.clone()
        pc.subtract_field(out, 3, n, totals, blo, bhi, b0)
        pc.subtract_field(plain, 3, n, totals, blo, bhi, b0, plain=True)
        assert torch.equal(out, plain)
        assert torch.equal(out[:, :3], field[:, :3].to(dtype))
    assert pc.LAUNCHES == {"pedestal_lines": 1, "pedestal_contrib": 1,
                           "pedestal_scan": 1, "pedestal_totals": 2,
                           "pedestal_field": 2}
    again = pc.endpoint_contributions(ka, field, 3, n)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert torch.equal(pc.scan(*rows, n, 51, nb), ped)


@pytest.mark.gpu
def test_pedestal_kernels_refuse_what_they_do_not_take(cuda_device):
    from pylbl_tpu_torch.ops import pedestal_cuda as pc

    _, b0, nb, ka, field, blo, bhi, n = pedestal_case(cuda_device, 20_000)
    with pytest.raises(ValueError, match="pedestal_contrib"):
        pc.endpoint_contributions(dict(ka, y=ka["y"].float()), field, 3, n)
    with pytest.raises(ValueError, match="pedestal_contrib"):
        pc.endpoint_contributions(ka, field[:, ::2], 3, n)
    with pytest.raises(ValueError, match="pedestal_scan"):
        pc.scan(ka["bucket"].long(), ka["s_idx"], ka["e_idx"], ka["y"],
                ka["y"], ka["y"], ka["y"], n, 51, nb)
    with pytest.raises(ValueError, match="pedestal_totals"):
        pc.bucket_totals(ka["y"].float(), ka)
    with pytest.raises(ValueError, match="pedestal_field"):
        pc.subtract_field(field, 3, n + 1, torch.zeros(
            (field.shape[0], nb), dtype=torch.float64, device=cuda_device),
            blo, bhi, b0)


@pytest.mark.gpu
def test_pedestal_remover_on_card_matches_cpu(cuda_device):
    """The stacked remover on the card against the same remover on the
    CPU: a float64 field within 1e-9 (floor 1e-6; the line physics' exp
    and pow may differ in the last ulp between the two), a float32 field
    within a float32 ulp of the result plus 1e-13 of the largest value
    (the physics' last ulp can move a pedestal by that much before its
    float32 rounding); it launches each kernel once a gas, makes the host
    wait for nothing on a warm call, counts one ``lines.pedestal_device``
    and repeats bit for bit."""
    from pylbl_tpu_torch import bench
    from pylbl_tpu_torch.ops import pedestal_cuda as pc
    from pylbl_tpu_torch.parallel.lines import make_stacked_pedestal_remover
    from pylbl_tpu_torch.utils.observability import metrics

    gases = packs()
    grid = np.arange(1.0, 220.0, 0.1)
    fn = make_multigas_batched_fn(gases, grid, device=cuda_device,
                                  dtype=torch.float64, backend="plain")
    k64 = fn(T, P, VMR)
    remover = make_stacked_pedestal_remover(gases, grid)
    for k in (k64, k64.float()):
        got = remover(k, T, P, VMR)
        want = remover(k.cpu(), T, P, VMR).numpy()
        assert got.is_cuda and got.dtype == k.dtype
        got = got.cpu().numpy()
        if k.dtype == torch.float64:
            scale = np.abs(want).max()
            assert float((np.abs(got - want) / np.maximum(
                np.abs(want), scale * 1e-6)).max()) < 1e-9
        else:
            assert (np.abs(got - want) <= 2.0 ** -24 * np.abs(want)
                    + 1e-13 * np.abs(want).max()).all()
    pc.reset_launches()
    metrics.reset()
    calls = []
    assert bench.host_syncs(lambda: calls.append(remover(k, T, P, VMR)),
                            cuda_device) == {}
    assert pc.LAUNCHES == {name: len(gases) for name in pc.LAUNCHES}
    assert metrics.snapshot()["counters"] == {"lines.pedestal_device": 1}
    assert torch.equal(calls[0], remover(k, T, P, VMR))
