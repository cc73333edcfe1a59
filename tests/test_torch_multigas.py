"""The port's stacked all-gases pipeline against the JAX package.

The analogues of tests/test_multigas.py for ``pylbl_tpu_torch``: the same
seeded line lists (made by the JAX package's fixtures and carried over as
LinePack fields) go through ``pylbl_tpu.parallel.lines`` — the Pallas
pipeline in interpret mode, rel < 5e-6, and the per-gas float64 "xla" Gas,
rel < 5e-4 — and through the port on CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.models.lines import Gas as JGas
from pylbl_tpu.parallel import lines as jlines
from pylbl_tpu.spectroscopy import number_density

from pylbl_tpu_torch.models.lines import Gas as TGas
from pylbl_tpu_torch.models.lines import LinePack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel import lines as tlines

torch.set_num_threads(1)

GRID = np.arange(1.0, 220.0, 0.2)
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])
ARGS32 = (T.astype(np.float32), P.astype(np.float32), VMR.astype(np.float32))


def port_pack(pack):
    """A JAX-package LinePack's fields as the port's LinePack."""
    return LinePack(formula=pack.formula,
                    **{f: getattr(pack, f) for f in LinePack._ARRAY_FIELDS})


@pytest.fixture(scope="module")
def packs():
    jp = {
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
    return jp, {name: port_pack(p) for name, p in jp.items()}


@pytest.fixture(scope="module")
def per_gas_f64(packs):
    """[B, G, points] per-gas float64 "xla" cross sections, with and
    without the pedestal (the JAX package's parity anchor)."""
    out = {}
    for ped in (False, True):
        rows = []
        for g, (name, pack) in enumerate(packs[0].items()):
            gas = JGas(pack, name, dtype=np.float64, backend="xla")
            rows.append(np.stack([
                gas.absorption_coefficient(T[i], P[i], VMR[i, g], GRID,
                                           remove_pedestal=ped)
                for i in range(T.size)]))
        out[ped] = np.stack(rows, axis=1)
    return out


def rel(got, want, floor):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), scale * floor)).max())


@pytest.mark.parametrize("tile,wings_tail", [(256, None), (512, 128),
                                             (512, None)])
def test_multigas_matches_jax(packs, per_gas_f64, tile, wings_tail):
    tfn = tlines.make_multigas_batched_fn(packs[1], GRID, tile=tile,
                                          chunk=128, wings_tail=wings_tail)
    got = tfn(*ARGS32).numpy()
    jfn = jlines.make_multigas_batched_fn(packs[0], GRID, tile=tile,
                                          chunk=128, wings_tail=wings_tail,
                                          interpret=True)
    assert (tfn.wings_stride is None) == (jfn.wings_stride is None)
    want = np.asarray(jfn(*ARGS32))
    assert got.shape == want.shape == per_gas_f64[False].shape
    assert rel(got, want, 1e-7) < 5e-6
    for g in range(3):
        assert rel(got[:, g], per_gas_f64[False][:, g], 1e-6) < 5e-4


def test_multigas_total_and_envelope_guard(packs):
    fn = tlines.make_multigas_batched_fn(packs[1], GRID, tile=256,
                                         chunk=128)
    per_gas = fn(*ARGS32).numpy().astype(np.float64)
    want = np.einsum("bgn,bg->bn", per_gas,
                     number_density(T[:, None], P[:, None], VMR))
    got = fn.total(*ARGS32).numpy()
    assert rel(got, want, 1e-6) < 1e-4
    with pytest.raises(ValueError, match="t_max"):
        fn(np.asarray([400.0]), np.asarray([1e5]),
           np.asarray([[1e-3, 1e-3, 1e-3]]))
    with pytest.raises(ValueError, match="p_max_atm"):
        fn(np.asarray([280.0]), np.asarray([6e5]),
           np.asarray([[1e-3, 1e-3, 1e-3]]))


def test_no_cross_gas_leakage(packs):
    """A gas with zero vmr still sees air-broadened lines, and no other
    gas's window writes into its segment."""
    fn = tlines.make_multigas_batched_fn(packs[1], GRID, tile=512,
                                         chunk=128)
    vmr = VMR.copy()
    vmr[:, 2] = 0.0
    got = fn(T, P, vmr).numpy()
    gas = JGas(packs[0]["O3"], "O3", dtype=np.float64, backend="xla")
    for i in range(T.size):
        want = gas.absorption_coefficient(T[i], P[i], 0.0, GRID)
        assert rel(got[i, 2], want, 1e-6) < 5e-4


def test_pedestal_remover_matches_jax(packs, per_gas_f64):
    k = tlines.make_multigas_batched_fn(packs[1], GRID, tile=512,
                                        chunk=128)(*ARGS32)
    got = tlines.make_stacked_pedestal_remover(packs[1], GRID)(
        k, T, P, VMR).numpy()
    want = np.asarray(jlines.make_stacked_pedestal_remover(packs[0], GRID)(
        jnp.asarray(k.numpy()), T, P, VMR))
    assert rel(got, want, 1e-6) < 1e-5
    for g in range(3):
        assert rel(got[:, g], per_gas_f64[True][:, g], 1e-6) < 5e-4


@pytest.mark.parametrize("remove_pedestal", [False, True])
def test_gas_engine_matches_jax(packs, per_gas_f64, remove_pedestal):
    """The port's Gas runs a one-gas stacked call (B=1 per layer, or the
    whole batch) plus the pedestal remover."""
    gas = TGas(packs[1]["CO2"], "CO2")
    batch = gas.absorption_coefficient_batch(T, P, VMR[:, 1], GRID,
                                             remove_pedestal=remove_pedestal)
    single = gas.absorption_coefficient(T[0], P[0], VMR[0, 1], GRID,
                                        remove_pedestal=remove_pedestal)
    want = per_gas_f64[remove_pedestal][:, 1]
    assert batch.dtype == np.float64 and batch.shape == want.shape
    assert rel(batch, want, 1e-6) < 5e-4
    assert rel(single, want[0], 1e-6) < 5e-4


def test_cpu_run_launches_no_kernel(packs):
    lc.reset_launches()
    fn = tlines.make_multigas_batched_fn(packs[1], GRID)
    fn(*ARGS32)
    assert all(count == 0 for count in lc.LAUNCHES.values())
