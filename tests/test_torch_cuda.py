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
@pytest.mark.parametrize("step,tile,tail", [
    (0.1, 1024, 128), (0.1, 1024, None), (0.01, 1024, 128),
    (0.2, 256, 128), (0.2, 512, 128)])
def test_kernels_match_plain_versions(cuda_device, step, tile, tail):
    grid = np.arange(1.0, 220.0 if step > 0.05 else 120.0, step)
    fn = make_multigas_batched_fn(packs(), grid, tile=tile,
                                  wings_tail=tail, device=cuda_device)
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


@pytest.mark.gpu
def test_spectroscopy_on_card_matches_cpu(cuda_device, tmp_path):
    """The main path on the card (kernels) agrees with the same path on
    the CPU (plain versions), and repeats bit for bit."""
    db = Database(tmp_path / "gpu.db")
    for pack in packs().values():
        db.ingest_line_pack(pack)
    names = {"H2O": "water_vapor", "CO2": "carbon_dioxide", "O3": "ozone",
             "O2": "oxygen", "N2": "nitrogen"}
    vmr = {"H2O": VMR[:, 0], "CO2": VMR[:, 1], "O3": VMR[:, 2],
           "O2": [0.209, 0.209], "N2": [0.78, 0.78]}
    data = {"p": (["layer"], P, {"standard_name": "air_pressure"}),
            "t": (["layer"], T, {"standard_name": "air_temperature"})}
    for name, std in names.items():
        data[name.lower()] = (["layer"], np.asarray(vmr[name]), {
            "standard_name": f"mole_fraction_of_{std}_in_air"})
    atm = Dataset(data_vars=data)
    grid = np.arange(1.0, 220.0, 0.1)
    gpu = Spectroscopy(atm, grid, db, device=cuda_device)
    cpu = Spectroscopy(atm, grid, db)
    got = gpu.compute_absorption(output_format="total")["absorption"].data
    again = gpu.compute_absorption(output_format="total")["absorption"].data
    want = cpu.compute_absorption(output_format="total")["absorption"].data
    assert np.array_equal(got, again)
    scale = np.abs(want).max()
    assert float((np.abs(got - want) / np.maximum(np.abs(want),
                                                  scale * 1e-6)).max()) < 5e-5
