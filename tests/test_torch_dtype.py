"""The port's dtype and backend spellings (runtime/device.py).

The JAX package's tests write ``dtype=np.float64``; the port takes that
spelling, ``np.dtype(...)`` and strings beside the torch dtypes, and each
spelling gives results bit-identical to its torch dtype through every
entry point that takes a dtype (``Gas`` single and batched,
``make_batched_fn``, ``make_multigas_batched_fn``, ``Spectroscopy``).
A float64 spelling really computes in float64: its result differs from
the float32 one.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.models.lines import Gas
from pylbl_tpu_torch.parallel import lines as tlines
from pylbl_tpu_torch.runtime.device import resolve_backend, resolve_dtype

torch.set_num_threads(1)

GRID = np.arange(1.0, 120.0, 0.2)
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
X = np.asarray([6.637074e-03, 4.763972e-06])
SPELLINGS = [(np.float64, torch.float64), ("float64", torch.float64),
             (np.dtype("float64"), torch.float64),
             (np.float32, torch.float32), ("float32", torch.float32),
             (np.dtype("float32"), torch.float32)]


def pack(name="H2O", seed=5):
    return synthetic_line_pack(name, num_lines=150, nu_min=0.7,
                               nu_max=130.0, seed=seed,
                               band_centers=(60.0,))


@pytest.mark.parametrize("spelling,want", SPELLINGS)
def test_resolve_dtype(spelling, want):
    assert resolve_dtype(spelling) is want
    assert resolve_dtype(want) is want


@pytest.mark.parametrize("bad", [np.int32, torch.float16, np.float16, None,
                                 "complex64", "int64"])
def test_resolve_dtype_refuses(bad):
    with pytest.raises(TypeError):
        resolve_dtype(bad)
    with pytest.raises(TypeError):
        Gas(pack(), "H2O", device="cpu", dtype=bad)


@pytest.mark.parametrize("backend,device,want", [
    ("auto", "cuda", "kernel"), ("auto", "cpu", "xla"),
    ("pallas", "cpu", "kernel"), ("kernel", "cpu", "kernel"),
    ("plain", "cuda", "plain"), ("xla", "cuda", "xla")])
def test_resolve_backend(backend, device, want):
    assert resolve_backend(backend, device) == want
    assert Gas(pack(), "H2O", device=device, backend=backend).backend == want


def test_resolve_backend_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("tpu", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        Spectroscopy(None, GRID, None, device="cpu", backend="jax")


@pytest.mark.parametrize("backend", ["kernel", "plain", "xla"])
@pytest.mark.parametrize("spelling,want", SPELLINGS[::3] + SPELLINGS[1:2])
def test_gas_spellings_bit_identical(spelling, want, backend):
    gas = Gas(pack(), "H2O", device="cpu", dtype=spelling, backend=backend)
    ref = Gas(pack(), "H2O", device="cpu", dtype=want, backend=backend)
    assert gas.torch_dtype is want
    assert gas.dtype == np.dtype(str(want).removeprefix("torch."))
    np.testing.assert_array_equal(
        gas.absorption_coefficient(T[0], P[0], X[0], GRID),
        ref.absorption_coefficient(T[0], P[0], X[0], GRID))
    np.testing.assert_array_equal(
        gas.absorption_coefficient_batch(T, P, X, GRID),
        ref.absorption_coefficient_batch(T, P, X, GRID))
    np.testing.assert_array_equal(
        ref.absorption_coefficient_batch(T, P, X, GRID, dtype=spelling),
        ref.absorption_coefficient_batch(T, P, X, GRID))


@pytest.mark.parametrize("backend", ["kernel", "xla"])
def test_float64_spelling_is_not_float32(backend):
    """The repaired fault: ``np.float64`` computes in float64 (it ran in
    float32 before), single layer and batched."""
    results = {}
    for dtype in (np.float64, torch.float32):
        gas = Gas(pack(), "H2O", device="cpu", dtype=dtype, backend=backend)
        results[dtype] = (gas.absorption_coefficient(T[0], P[0], X[0], GRID),
                          gas.absorption_coefficient_batch(T, P, X, GRID))
    for one, other in zip(results[np.float64], results[torch.float32]):
        assert not np.array_equal(one, other)
        np.testing.assert_allclose(one, other, rtol=0,
                                   atol=np.abs(one).max() * 1e-5)


@pytest.mark.parametrize("spelling,want", SPELLINGS[:1] + SPELLINGS[3:4])
def test_batched_fn_spellings_bit_identical(spelling, want):
    p = pack()
    got = tlines.make_batched_fn(p, GRID, device="cpu", dtype=spelling)(
        T, P, X)
    ref = tlines.make_batched_fn(p, GRID, device="cpu", dtype=want)(T, P, X)
    assert got.dtype is want
    assert torch.equal(got, ref)
    packs = {"H2O": p, "CO2": pack("CO2", 6)}
    vmr = np.stack([X, np.full(2, 3.9e-4)], axis=1)
    for backend in ("kernel", "xla"):
        got = tlines.make_multigas_batched_fn(
            packs, GRID, device="cpu", dtype=spelling, backend=backend)(
                T, P, vmr)
        ref = tlines.make_multigas_batched_fn(
            packs, GRID, device="cpu", dtype=want, backend=backend)(
                T, P, vmr)
        assert got.dtype is want and torch.equal(got, ref)
    arrays = tlines.as_tensors({"a": np.ones(3, np.float32),
                                "i": np.arange(3)}, "cpu", spelling)
    assert arrays["a"].dtype is want and arrays["i"].dtype == torch.int64


@pytest.mark.parametrize("spelling,want", SPELLINGS[:1] + SPELLINGS[3:4])
def test_spectroscopy_spellings_bit_identical(spelling, want, tmp_path):
    db = Database(tmp_path / "d.db")
    db.ingest_line_pack(pack())
    atm = Dataset(data_vars={
        "p": (["layer"], P, {"standard_name": "air_pressure", "units": "Pa"}),
        "t": (["layer"], T, {"standard_name": "air_temperature",
                             "units": "K"}),
        "q": (["layer"], X,
              {"standard_name": "mole_fraction_of_water_vapor_in_air",
               "units": "mol mol-1"})})
    out = {}
    for dtype in (spelling, want):
        spec = Spectroscopy(atm, GRID, db, device="cpu", dtype=dtype)
        assert spec.dtype is want
        out[dtype] = spec.compute_absorption(
            output_format="total")["absorption"].data
    np.testing.assert_array_equal(out[spelling], out[want])
