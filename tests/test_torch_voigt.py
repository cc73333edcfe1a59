"""The PyTorch port's Voigt functions against pylbl_tpu.ops.voigt.

The same (x, y) points — covering every Humlicek region and every
correction class the core kernel selects by y — go through the JAX
package's functions (numpy inputs) and through the port's on torch
tensors.  float64 agrees to round-off; float32 within a few ulp.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import voigt as jv

from pylbl_tpu_torch.ops import voigt as tv
from pylbl_tpu_torch.utils.xp import TorchNamespace

torch.set_num_threads(1)

X = np.concatenate([np.linspace(-140.0, 140.0, 401),
                    np.geomspace(1e-4, 30.0, 60), [0.0]])
FULL_Y = np.asarray([1e-7, 1e-3, 0.05, 0.5, 1.2, 1.9, 2.0, 3.5, 6.79, 6.8,
                     8.0, 8.425, 20.0, 70.0, 71.0])
# (function name, y values in its domain).
CASES = [
    ("voigt_lorentz", FULL_Y),
    ("voigt_full", FULL_Y),
    ("voigt_correction", FULL_Y),
    ("voigt_correction_k1", FULL_Y[FULL_Y >= 8.425]),
    ("voigt_correction_k12", FULL_Y[FULL_Y >= 6.8]),
    ("voigt_correction_k123", FULL_Y[(FULL_Y >= 2.0) & (FULL_Y < 6.8)]),
]


def grid(y_values, dtype):
    x = X.astype(dtype)[None, :]
    y = np.asarray(y_values, dtype)[:, None]
    return x, y


@pytest.mark.parametrize("name,y_values", CASES)
def test_voigt_float64(name, y_values):
    x, y = grid(y_values, np.float64)
    want = getattr(jv, name)(x, y)
    got = getattr(tv, name)(torch.as_tensor(x), torch.as_tensor(y))
    assert got.dtype == torch.float64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=scale * 1e-15)


@pytest.mark.parametrize("name,y_values", CASES)
def test_voigt_float32(name, y_values):
    x, y = grid(y_values, np.float32)
    want = getattr(jv, name)(x, y)
    got = getattr(tv, name)(torch.as_tensor(x), torch.as_tensor(y))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=scale * 1e-6)


def test_correction_classes_match_full_on_their_domain():
    """Each class function equals voigt_correction where the core kernel
    selects it (the chunk-min-y dispatch)."""
    x, y = grid(FULL_Y, np.float64)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    full = tv.voigt_correction(xt, yt)
    scale = float(full.abs().max())
    for name, lo in (("voigt_correction_k1", 8.425),
                     ("voigt_correction_k12", 6.8),
                     ("voigt_correction_k123", 2.0)):
        rows = FULL_Y >= lo
        got = getattr(tv, name)(xt[:, :], yt[rows])
        np.testing.assert_allclose(got.numpy(), full[rows].numpy(),
                                   rtol=1e-9, atol=scale * 1e-12)


def test_torch_namespace_numpy_semantics():
    xp = TorchNamespace("cpu")
    a = np.arange(6.0).reshape(2, 3) - 2.0
    t = xp.asarray(a)
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(xp.maximum(t, 0.0).numpy(),
                                  np.maximum(a, 0.0))
    np.testing.assert_array_equal(
        xp.pad(t, [(0, 0), (1, 2)], constant_values=7.0).numpy(),
        np.pad(a, [(0, 0), (1, 2)], constant_values=7.0))
    np.testing.assert_array_equal(
        xp.sum(t, axis=-1, keepdims=True).numpy(),
        np.sum(a, axis=-1, keepdims=True))
    np.testing.assert_array_equal(
        xp.any(t > 2, axis=-1, keepdims=True).numpy(),
        np.any(a > 2, axis=-1, keepdims=True))
    assert tv._xp(t).device == torch.device("cpu")
    assert tv._xp(a) is np
