"""Per-layer line physics of the PyTorch port against the JAX package.

Identical numpy inputs (pylbl_tpu's device_line_pack / stack_device_packs
arrays) go through ``pylbl_tpu.parallel.lines.line_kernel_arrays`` one
layer at a time and through the port's layer-batched counterpart via
``as_tensors``; float32 agrees to rtol 1e-6, float64 to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.parallel import lines as tlines

torch.set_num_threads(1)

GRID = np.arange(1.0, 220.0, 0.2)
# The canonical 4-layer column (tests/conftest.py).
T = np.asarray([269.01, 227.74, 203.37, 288.99])
P = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
VMR = np.asarray([[5.244536e-06, 3.6e-04, 2.936688e-06],
                  [4.763972e-06, 3.6e-04, 7.415223e-06],
                  [3.039952e-06, 3.6e-04, 2.609510e-07],
                  [6.637074e-03, 3.5999e-04, 6.859128e-08]])
FLOAT_KEYS = ("c_frac", "scaled_repwid", "y", "prefactor")
INT_KEYS = ("c_int", "s_idx", "e_idx")


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


def compare(arrays, static, vmr, dtype, rtol):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    arrays = {k: v.astype(np_dtype) if v.dtype.kind == "f" else v
              for k, v in arrays.items()}
    got = tlines.line_kernel_arrays(
        tlines.as_tensors(arrays, "cpu"), static,
        torch.as_tensor(T.astype(np_dtype)), torch.as_tensor(
            P.astype(np_dtype)), torch.as_tensor(vmr.astype(np_dtype)))
    j_arrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    for i in range(T.size):
        want = jlines.line_kernel_arrays(
            j_arrays, static, jnp.asarray(T[i], np_dtype),
            jnp.asarray(P[i], np_dtype), jnp.asarray(vmr[i], np_dtype))
        for key in FLOAT_KEYS:
            g = got[key][i].numpy()
            w = np.asarray(want[key])
            assert g.dtype == w.dtype == np_dtype, key
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=key)
        for key in INT_KEYS:
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=key)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_line_kernel_arrays_single_gas(dtype, rtol):
    arrays, static = jlines.device_line_pack(packs()["H2O"], GRID)
    compare(arrays, static, VMR[:, 0], dtype, rtol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_line_kernel_arrays_stacked(dtype, rtol):
    arrays, _, static, _ = jlines.stack_device_packs(packs(), GRID)
    compare(arrays, static, VMR, dtype, rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_minus_exp_neg(dtype):
    z = np.concatenate([np.geomspace(1e-6, 0.5, 200),
                        np.linspace(0.5, 20.0, 200)]).astype(dtype)
    got = tlines._one_minus_exp_neg(torch.as_tensor(z)).numpy()
    want = np.asarray(jlines._one_minus_exp_neg(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == np.float32
                               else 1e-15)
    exact = -np.expm1(-z.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=3e-7 if dtype == np.float32
                               else 1e-15)


def test_as_tensors_keeps_types():
    arrays, _, _, _ = jlines.stack_device_packs(packs(), GRID)
    got = tlines.as_tensors(arrays, "cpu")
    for key, value in arrays.items():
        np.testing.assert_array_equal(got[key].numpy(), value)
        assert got[key].numpy().dtype == value.dtype
    got64 = tlines.as_tensors(arrays, "cpu", torch.float64)
    assert got64["nu"].dtype == torch.float64
    assert got64["q_row"].dtype == torch.int32


def test_float32_windows_match_float64_host_physics():
    """A line whose pressure-shifted center lies within float32 rounding of
    an integer wavenumber: the JAX package's float32 window placement
    (floor(center / n_per_v + v0)) moves its window by one wavenumber; the
    port's split-center bucket keeps every window on the float64 host
    physics' (models/lines/physics.py kernel_inputs)."""
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.models.lines import LinePack

    jpack = synthetic_line_pack(num_lines=3000, nu_min=0.5, nu_max=5100.0,
                                seed=1,
                                band_centers=(150.0, 1600.0, 3700.0, 500.0))
    pack = LinePack(formula=jpack.formula,
                    **{f: getattr(jpack, f) for f in LinePack._ARRAY_FIELDS})
    grid = np.arange(1.0, 5000.0, 0.1)
    cond = (288.99, 98388.0, 6.637074e-03)
    arrays, static = jlines.device_line_pack(jpack, grid)
    host = kernel_inputs(line_profile_params(
        pack, *cond, keep=static["num_lines"]), static["v0"],
        static["n_per_v"], static["cut_off"])
    got = tlines.line_kernel_arrays(
        tlines.as_tensors(arrays, "cpu"), static,
        *(torch.as_tensor([v], dtype=torch.float32) for v in cond))
    want = jlines.line_kernel_arrays(
        {k: jnp.asarray(v) for k, v in arrays.items()}, static,
        *(jnp.asarray(v, jnp.float32) for v in cond))
    for key in ("s_idx", "e_idx"):
        np.testing.assert_array_equal(got[key][0].numpy(), host[key])
        assert int((np.asarray(want[key]) != host[key]).sum()) >= 1
