"""The port's portable two-pass backend against the JAX package's.

``accumulate`` / ``accumulate_segment`` (pylbl_tpu_torch/ops/lineshape.py)
against ``pylbl_tpu.ops.lineshape`` on the same kernel arrays, in float64
at rel < 5e-6 with the 1e-7 floor of tests/test_lineshape_pallas.py:31-33;
``Gas(..., backend="xla")`` on the golden anchors of
tests/test_goldens.py:45-65 (rel 1e-6); and the stacked
``make_multigas_batched_fn(backend="xla")``, the ``Spectroscopy`` stacked
path and ``remove_stacked_pedestal`` against the JAX package on the packs
and grid of tests/test_multigas.py (rel 5e-4, floor 1e-6; the pedestal
remover at 1e-12).  Every port call runs on CPU tensors.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu import Dataset as JDataset
from pylbl_tpu.database.db import Database as JDatabase
from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.models.lines import Gas as JGas
from pylbl_tpu.models.lines import internal_grid
from pylbl_tpu.models.lines.physics import kernel_inputs, line_profile_params
from pylbl_tpu.ops import lineshape as jls
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.models.lines import Gas, LinePack
from pylbl_tpu_torch.ops import lineshape as tls
from pylbl_tpu_torch.parallel import lines as tlines

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SURFACE = (288.99, 98388.0, 6.637074e-03)
GRID = np.arange(1.0, 220.0, 0.2)
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])
NAMES = ["H2O", "CO2", "O3"]


def rel(got, want, floor=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), scale * floor)).max())


def port_pack(pack):
    return LinePack(formula=pack.formula,
                    **{f: getattr(pack, f) for f in LinePack._ARRAY_FIELDS})


def small_pack():
    return synthetic_line_pack(num_lines=120, nu_min=30.0, nu_max=280.0,
                               seed=11, band_centers=(150.0,))


def small_kin(conds=SURFACE):
    """tests/test_lineshape_pallas.py:13-22's workload (``conds`` may hold
    [B] arrays)."""
    pack = small_pack()
    grid = np.arange(50.0, 250.0, 0.2)
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, 25)
    params = line_profile_params(pack, *conds, keep=keep)
    return kernel_inputs(params, v0, npv, 25), npv, n


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


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_accumulate_matches_jax(dtype):
    kin, npv, n = small_kin()
    want = np.asarray(jls.accumulate(jls.prepare_kernel_arrays(kin, npv,
                                                               dtype),
                                     n, npv, 25))
    got = tls.accumulate(tls.prepare_kernel_arrays(kin, npv, dtype), n, npv,
                         25, device="cpu")
    assert got.shape == (n,) and got.dtype == torch.from_numpy(
        np.zeros(0, dtype)).dtype
    assert rel(got.numpy(), want) < 5e-6


def test_static_params_match_jax():
    kin, npv, _ = small_kin()
    for chunk in (2048, 256):
        assert tls.static_params(kin, npv, 25, chunk) == \
            jls.static_params(kin, npv, 25, chunk)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("segment", ["whole", "inner", "tail"])
def test_accumulate_segment_matches_jax(segment, batched):
    """A segment [origin, origin + num_points) of the global grid, float64:
    the whole grid, an inner segment whose edges every dense-band window
    crosses, and the tail segment against the global upper edge; [N] or
    [B, N] arrays."""
    conds = np.asarray([SURFACE, (250.0, 80000.0, 0.004)]).T if batched \
        else SURFACE
    kin, npv, n = small_kin(conds)
    window, core_w, chunk = jls.static_params(kin, npv, 25, 128)
    origin, num = {"whole": (0, n), "inner": (300, 400),
                   "tail": (n - 150, 150)}[segment]
    s = np.asarray(kin["s_idx"])
    e = np.asarray(kin["e_idx"])
    if segment == "inner":
        for edge in (origin, origin + num):
            assert ((s < edge) & (e >= edge)).sum() > 10
    arrays, _ = jls._pad_lines(jls.prepare_kernel_arrays(kin, npv,
                                                         np.float64), chunk)
    want = np.asarray(jls.accumulate_segment(
        {k: jnp.asarray(v) for k, v in arrays.items()}, origin, num, n,
        window, core_w, chunk))
    got = tls.accumulate_segment(arrays, origin, num, n, window, core_w,
                                 chunk).numpy()
    assert got.shape == want.shape == ((2, num) if batched else (num,))
    assert np.abs(want).max() > 0
    assert rel(got, want) < 5e-6


def test_accumulate_segment_tiles_the_grid():
    """Segments at their origins, put side by side, give the whole grid."""
    kin, npv, n = small_kin()
    window, core_w, chunk = tls.static_params(kin, npv, 25, 128)
    arrays, _ = tls._pad_lines(tls.prepare_kernel_arrays(kin, npv,
                                                         np.float64), chunk)
    whole = tls.accumulate_segment(arrays, 0, n, n, window, core_w, chunk)
    cuts = [0, 300, 700, n]
    parts = [tls.accumulate_segment(arrays, lo, hi - lo, n, window, core_w,
                                    chunk)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    assert rel(torch.cat(parts).numpy(), whole.numpy()) < 5e-6


def test_xla_and_plain_backends_agree():
    grid = np.arange(50.0, 250.0, 0.2)
    pack = port_pack(small_pack())
    got = {backend: Gas(pack, "H2O", device="cpu", dtype=np.float64,
                        backend=backend).absorption_coefficient(*SURFACE,
                                                                grid)
           for backend in ("xla", "plain")}
    assert np.abs(got["plain"]).max() > 0
    assert rel(got["xla"], got["plain"]) < 5e-6


def test_empty_line_list_gives_zeros():
    kin, npv, n = small_kin()
    empty = {k: v[:0] for k, v in
             tls.prepare_kernel_arrays(kin, npv, np.float64).items()}
    out = tls.accumulate(empty, n, npv, 25, device="cpu")
    assert out.dtype == torch.float64
    assert np.array_equal(out.numpy(), np.zeros(n))


def test_repeated_calls_are_bit_identical(packs):
    kin, npv, n = small_kin()
    arrays = tls.prepare_kernel_arrays(kin, npv, np.float32)
    a, b = (tls.accumulate(arrays, n, npv, 25, device="cpu").numpy()
            for _ in range(2))
    assert np.abs(a).max() > 0 and np.array_equal(a, b)
    fn = tlines.make_multigas_batched_fn(packs[1], GRID, backend="xla",
                                         device="cpu")
    np.testing.assert_array_equal(fn(T, P, VMR).numpy(),
                                  fn(T, P, VMR).numpy())


@pytest.mark.parametrize("remove_pedestal,log_max,log_sum", [
    (False, -52.29384204610783, -47.584943918810545),
    (True, -52.29394886463197, -47.586756746157604)])
def test_h2o_golden_scalars_xla(remove_pedestal, log_max, log_sum):
    """tests/test_goldens.py:60-70 through the port's portable backend."""
    grid = np.arange(1.0, 3250.0, 0.1)
    gas = Gas(LinePack.load(DATA / "h2o_frozen.lpk.npz"), "H2O",
              device="cpu", dtype=np.float64, backend="xla")
    k = gas.absorption_coefficient(288.99, 98388.0, 6.637074e-03, grid,
                                   remove_pedestal=remove_pedestal)
    k = k[:grid.size]
    assert np.log(k.max()) == pytest.approx(log_max, rel=1e-6)
    assert np.log(np.sum(k * 0.1)) == pytest.approx(log_sum, rel=1e-6)


def test_multigas_xla_matches_jax(packs):
    """tests/test_multigas.py:61-81's "xla" case: the port's and the JAX
    package's portable stacked pipelines, and the JAX per-gas float64
    engine, rel < 5e-4 (floor 1e-6); every layer in one call."""
    args = tuple(a.astype(np.float32) for a in (T, P, VMR))
    fn = tlines.make_multigas_batched_fn(packs[1], GRID, backend="xla",
                                         device="cpu")
    assert fn.names == NAMES
    got = fn(*args)
    assert got.dtype == torch.float32
    want = np.asarray(jlines.make_multigas_batched_fn(packs[0], GRID,
                                                      backend="xla")(*args))
    assert got.shape == want.shape == (2, 3, internal_grid(GRID)[3])
    assert rel(got.numpy(), want, 1e-6) < 5e-4
    for g, name in enumerate(NAMES):
        gas = JGas(packs[0][name], name, dtype=np.float64, backend="xla")
        per_gas = np.stack([gas.absorption_coefficient(T[i], P[i], VMR[i, g],
                                                       GRID)
                            for i in range(T.size)])
        assert rel(got[:, g].numpy(), per_gas, 1e-6) < 5e-4
    total = np.einsum("bgn,bg->bn", got.numpy().astype(np.float64),
                      P[:, None] * VMR / (1.380649e-23 * T[:, None]))
    assert rel(fn.total(*args).numpy(), total, 1e-6) < 1e-4


def test_multigas_xla_no_cross_gas_leakage(packs):
    """tests/test_multigas.py:84-99 through the port's "xla" pipeline."""
    fn = tlines.make_multigas_batched_fn(packs[1], GRID, backend="xla",
                                         device="cpu")
    vmr = VMR.copy()
    vmr[:, 2] = 0.0
    got = fn(T.astype(np.float32), P.astype(np.float32),
             vmr.astype(np.float32)).numpy()
    gas = JGas(packs[0]["O3"], "O3", dtype=np.float64, backend="xla")
    for i in range(T.size):
        want = gas.absorption_coefficient(T[i], P[i], 0.0, GRID)
        assert rel(got[i, 2], want, 1e-6) < 5e-4


def _atmosphere(cls):
    return cls(data_vars={
        "p": (["layer"], P, {"standard_name": "air_pressure", "units": "Pa"}),
        "t": (["layer"], T, {"standard_name": "air_temperature",
                             "units": "K"}),
        "q": (["layer"], VMR[:, 0],
              {"standard_name": "mole_fraction_of_water_vapor_in_air",
               "units": "mol mol-1"}),
        "co2": (["layer"], VMR[:, 1],
                {"standard_name": "mole_fraction_of_carbon_dioxide_in_air",
                 "units": "mol mol-1"}),
        "o3": (["layer"], VMR[:, 2],
               {"standard_name": "mole_fraction_of_ozone_in_air",
                "units": "mol mol-1"}),
    })


def test_spectroscopy_stacked_xla_with_pedestal(packs, tmp_path):
    """tests/test_multigas.py:110-155: the stacked path under "xla" asked
    for by ``_compute_lines_stacked(..., backend="xla")``, with the
    pedestal, against the JAX per-gas float64 engine; by default an "xla"
    Spectroscopy leaves the lines to the per-gas engines."""
    from pylbl_tpu_torch.spectroscopy import MoleculeCache

    db = Database(tmp_path / "mg.db")
    for pack in packs[1].values():
        db.ingest_line_pack(pack)
    s = Spectroscopy(_atmosphere(Dataset), GRID, db, device="cpu",
                     backend="xla")
    for name in s.atmosphere.gases:
        s.cache[name] = MoleculeCache(name, s.grid, s.lines_database,
                                      s.lines_engine, s.continua_engine,
                                      s.cross_sections_engine,
                                      s._accepted(s.lines_engine))
        assert s.cache[name].gas.backend == "xla"
    vmr_by_gas = {name: VMR[:, g] for g, name in enumerate(NAMES)}
    assert s._compute_lines_stacked(T, P, vmr_by_gas,
                                    remove_pedestal=True) == {}
    stacked = s._compute_lines_stacked(T, P, vmr_by_gas,
                                       remove_pedestal=True, backend="xla")
    assert set(stacked) == set(NAMES)
    for g, name in enumerate(NAMES):
        gas = JGas(packs[0][name], name, dtype=np.float64, backend="xla")
        for i in range(T.size):
            want = gas.absorption_coefficient(T[i], P[i], VMR[i, g], GRID,
                                              remove_pedestal=True)
            assert rel(stacked[name][i], want, 1e-6) < 5e-4


def test_spectroscopy_xla_matches_jax(packs, tmp_path):
    """An "xla" Spectroscopy (per-gas portable engines) against the JAX
    package's CPU Spectroscopy on one database file: total absorption at
    rel 5e-4 (floor 1e-6)."""
    import pylbl_tpu

    path = str(tmp_path / "xla.db")
    jdb = JDatabase(path)
    for pack in packs[0].values():
        jdb.ingest_line_pack(pack)
    want = pylbl_tpu.Spectroscopy(_atmosphere(JDataset), GRID, jdb) \
        .compute_absorption(output_format="total")["absorption"].data
    got = Spectroscopy(_atmosphere(Dataset), GRID, Database(path),
                       device="cpu", dtype=np.float64, backend="xla") \
        .compute_absorption(output_format="total")["absorption"].data
    assert got.shape == want.shape
    assert rel(got, want, 1e-6) < 5e-4


def test_remove_stacked_pedestal_matches_jax(packs):
    k = tlines.make_multigas_batched_fn(packs[1], GRID, backend="xla",
                                        device="cpu", dtype=np.float64)(
        T, P, VMR)
    got = tlines.remove_stacked_pedestal(packs[1], GRID, k, T, P, VMR)
    want = jlines.remove_stacked_pedestal(packs[0], GRID, k.numpy(), T, P,
                                          VMR)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(want).max() > 0
    assert rel(got, want, 1e-12) < 1e-12
    # The device remover of the stacked pipeline agrees at the float64
    # tolerance of the per-gas path.
    dev = tlines.make_stacked_pedestal_remover(packs[1], GRID)(k, T, P, VMR)
    assert rel(dev.numpy(), want, 1e-6) < 5e-4


def test_make_batched_fn_refuses_xla(packs):
    with pytest.raises(ValueError, match="portable"):
        tlines.make_batched_fn(packs[1]["CO2"], GRID, backend="xla",
                               device="cpu")


def test_portable_path_uses_no_accumulating_scatter():
    """The portable path is deterministic by construction: no float
    atomics and no accumulating scatter anywhere in the package."""
    root = Path(tlines.__file__).resolve().parents[1]
    banned = ("index_add", "scatter_add", "accumulate=True",
              "use_deterministic_algorithms")
    for path in root.rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, f"{path.name} uses {word}"
