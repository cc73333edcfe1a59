"""End-to-end: the port's Spectroscopy and mechanisms against the JAX package.

The same Database file, atmosphere Dataset and grid go to
``pylbl_tpu.Spectroscopy`` (on the CPU: per-gas float64 lines, host float64
continua and cross sections) and to ``pylbl_tpu_torch.Spectroscopy`` (one
stacked float32 lines pipeline through the plain kernel versions).  Output
formats agree to 5e-4 (the float32 device-physics tolerance of
tests/test_multigas.py); continua and cross sections to round-off; in
float64 the port reproduces the golden totals of tests/test_goldens.py to
1e-6.
"""
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import pylbl_tpu
from pylbl_tpu.database.db import Database as JDatabase
from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.models import mt_ckd as j_mt_ckd
from pylbl_tpu.models.arts_crossfit import CrossSection as JCrossSection

import pylbl_tpu_torch
from pylbl_tpu_torch.database.db import Database as TDatabase
from pylbl_tpu_torch.models import mt_ckd as t_mt_ckd
from pylbl_tpu_torch.models.arts_crossfit import CrossSection as TCrossSection
from pylbl_tpu_torch.ops import lineshape_cuda as lc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
GASES = ["H2O", "CO2", "CH4", "O3", "N2O", "CO", "O2", "N2"]
CONTINUA = ["CarbonDioxideContinuum", "WaterVaporForeignContinuum",
            "WaterVaporSelfContinuum", "NitrogenContinuum",
            "OxygenContinuum", "OzoneContinuum"]
# tests/test_goldens.py: engine-computed 8-gas anchors (grid 1-3000 @1.0,
# surface layer, lines + MT-CKD continua).
TOTAL_MAX = 26.927475162159258
TOTAL_LOG_SUM = 7.365904843742843
GOLDEN_VMR = {"H2O": 6.637074e-03, "CO2": 3.9754e-04, "O3": 6.7328e-08,
              "N2O": 3.2699e-07, "CO": 1.4385e-07, "CH4": 1.8346e-06,
              "O2": 0.209, "N2": 0.781}
STANDARD = {"H2O": "water_vapor", "CO2": "carbon_dioxide", "O3": "ozone",
            "N2O": "nitrous_oxide", "CO": "carbon_monoxide",
            "CH4": "methane", "O2": "oxygen", "N2": "nitrogen"}


def rel(got, want, floor=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), scale * floor)).max())


def write_xsec(directory):
    """A synthetic arts-crossfit file for CH4 whose fits go negative at
    some points (exercising the clip-and-rescale)."""
    directory.mkdir()
    rng = np.random.default_rng(5)
    with h5py.File(directory / "CH4.nc", "w") as handle:
        handle.create_dataset("bands", data=np.array([0, 1]))
        for band, (lo, hi) in enumerate([(2.0e13, 6.0e13), (7.0e13,
                                                            8.0e13)]):
            handle.create_dataset(f"band{band}_fgrid",
                                  data=np.linspace(lo, hi, 300))
            coeffs = np.zeros((300, 4))
            coeffs[:, 0] = rng.uniform(-0.2e-27, 1.0e-27, 300)
            coeffs[:, 1] = 1.0e-31
            coeffs[:, 2] = 1.0e-33
            handle.create_dataset(f"band{band}_coeffs", data=coeffs)


@pytest.fixture(scope="module")
def database(tmp_path_factory):
    """One sqlite file (written by the JAX package) opened by both."""
    tmp = tmp_path_factory.mktemp("spec")
    db = JDatabase(tmp / "spec.db")
    for formula, seed, num in [("H2O", 11, 600), ("CO2", 12, 400),
                               ("CH4", 13, 300)]:
        db.ingest_line_pack(synthetic_line_pack(formula=formula,
                                                num_lines=num, seed=seed))
    write_xsec(tmp / "coefficients")
    db.ingest_arts_crossfit_directory(str(tmp / "coefficients"))
    return db, TDatabase(tmp / "spec.db")


@pytest.fixture(scope="module")
def jax_all(database, request):
    """JAX Spectroscopy "all" output on the canonical column."""
    atm = canonical_dataset()
    return pylbl_tpu.Spectroscopy(atm, COARSE, database[0]) \
        .compute_absorption(output_format="all")


COARSE = np.arange(1.0, 3000.0, 1.0)


def canonical_dataset():
    """The canonical 4-layer column (tests/conftest.py), as a JAX-package
    Dataset (the port takes it duck-typed)."""
    p = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
    t = np.asarray([269.01, 227.74, 203.37, 288.99])
    vmr = {
        "H2O": [5.244536e-06, 4.763972e-06, 3.039952e-06, 6.637074e-03],
        "CO2": [0.00036, 0.00036, 0.00036, 0.00035999],
        "O3": [2.936688e-06, 7.415223e-06, 2.609510e-07, 6.859128e-08],
        "N2O": [1.050928e-08, 1.319584e-07, 2.895416e-07, 3.199949e-07],
        "CH4": [2.947482e-07, 8.817705e-07, 1.588336e-06, 1.700002e-06],
        "CO": [3.621464e-08, 1.761450e-08, 3.315927e-08, 1.482969e-07],
        "O2": [0.209, 0.209, 0.2090003, 0.208996],
        "N2": [0.78, 0.78, 0.78, 0.78]}
    data = {"pressure": (["layer"], p, {"units": "Pa",
                                        "standard_name": "air_pressure"}),
            "temperature": (["layer"], t, {"units": "K",
                                           "standard_name":
                                           "air_temperature"})}
    for name, values in vmr.items():
        data[STANDARD[name]] = (["layer"], np.asarray(values), {
            "units": "mol mol-1",
            "standard_name": f"mole_fraction_of_{STANDARD[name]}_in_air"})
    return pylbl_tpu.Dataset(data_vars=data)


def test_all_format_matches_jax(database, jax_all):
    got = pylbl_tpu_torch.Spectroscopy(canonical_dataset(), COARSE,
                                       database[1]).compute_absorption(
        output_format="all")
    assert list(got.data_vars) == list(jax_all.data_vars)
    assert list(got["mechanism"].data) == list(jax_all["mechanism"].data)
    for name in GASES:
        a = got[f"{name}_absorption"]
        b = jax_all[f"{name}_absorption"]
        assert a.dims == b.dims and a.attrs == b.attrs
        assert a.data.shape == b.data.shape == (4, 3, COARSE.size)
        assert rel(a.data[:, 0], b.data[:, 0]) < 5e-4          # lines
        np.testing.assert_allclose(a.data[:, 1:], b.data[:, 1:],
                                   rtol=1e-12, atol=1e-300)   # mechanisms


@pytest.mark.parametrize("device_mechanisms", [False, True])
def test_gas_and_total_formats_match_jax(database, jax_all,
                                         device_mechanisms):
    spec = pylbl_tpu_torch.Spectroscopy(
        canonical_dataset(), COARSE, database[1],
        device_mechanisms=device_mechanisms)
    per_gas = spec.compute_absorption(output_format="gas")
    total = spec.compute_absorption(output_format="total")
    want_total = 0.0
    for name in GASES:
        want = jax_all[f"{name}_absorption"].data.sum(axis=-2)
        got = per_gas[f"{name}_absorption"]
        assert got.dims == ("layer", "wavenumber")
        assert rel(got.data, want) < 5e-4
        want_total = want_total + want
    assert total["absorption"].dims == ("layer", "wavenumber")
    assert rel(total["absorption"].data, want_total) < 5e-4


def test_unstackable_gases_fall_back_per_gas(database, jax_all, tmp_path):
    """Gases whose TIPS tables start at different temperatures cannot
    share one stacked call; each then runs as a one-gas call."""
    db = TDatabase(tmp_path / "mixed.db")
    for formula, seed, num in [("H2O", 11, 600), ("CO2", 12, 400)]:
        pack = synthetic_line_pack(formula=formula, num_lines=num, seed=seed)
        db.ingest_line_pack(pack)
    pack = synthetic_line_pack(formula="CH4", num_lines=300, seed=13)
    pack.q_temperature = pack.q_temperature + 1.0
    want = pylbl_tpu.Spectroscopy(
        canonical_dataset(), COARSE, database[0]).compute_absorption(
        output_format="gas")
    db.ingest_line_pack(pack)
    spec = pylbl_tpu_torch.Spectroscopy(canonical_dataset(), COARSE, db)
    got = spec.compute_absorption(output_format="gas")
    assert "unstackable" in spec._multigas_fns.values()
    for name in ("H2O", "CO2"):
        assert rel(got[f"{name}_absorption"].data,
                   want[f"{name}_absorption"].data) < 5e-4
    assert got["CH4_absorption"].data.max() > 0


@pytest.mark.parametrize("name", CONTINUA)
def test_mt_ckd_matches_jax_host(name):
    """All bands, infrared to ultraviolet (1-60000 cm-1)."""
    grid = np.arange(1.0, 60000.0, 2.0)
    atm = canonical_dataset()
    t = np.asarray(atm["temperature"].data)
    p = np.asarray(atm["pressure"].data)
    vmr = {formula: np.asarray(atm[STANDARD[formula]].data)
           for formula in STANDARD}
    want = getattr(j_mt_ckd, name)().spectra(t, p, vmr, grid)
    cont = getattr(t_mt_ckd, name)()
    host = cont.spectra(t, p, vmr, grid)
    device = cont.device_spectra(grid, "cpu")(t, p, vmr).numpy()
    np.testing.assert_allclose(host, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(device, want, rtol=1e-12,
                               atol=np.abs(want).max() * 1e-14)
    assert np.abs(want).max() > 0


def test_cross_sections_match_jax_host(database):
    path = database[0].arts_crossfit("CH4")
    t = np.asarray([200.0, 250.0, 300.0])
    p = np.asarray([100.0, 5.0e4, 1.0e5])
    want = JCrossSection("CH4", path).absorption_coefficient_batch(
        COARSE, t, p)
    xsec = TCrossSection("CH4", path)
    host = xsec.absorption_coefficient_batch(COARSE, t, p)
    device = xsec.device_absorption_fn(COARSE, "cpu")(t, p).numpy()
    np.testing.assert_allclose(host, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(device, want, rtol=1e-12,
                               atol=np.abs(want).max() * 1e-14)
    assert np.abs(want).max() > 0


def test_total_golden_float64(tmp_path):
    """In float64 the port's stacked path reproduces the 8-gas golden
    anchors of tests/test_goldens.py to rel 1e-6."""
    from pylbl_tpu_torch.models.lines import LinePack
    db = TDatabase(tmp_path / "frozen.db")
    for name in GOLDEN_VMR:
        db.ingest_line_pack(LinePack.load(DATA / f"{name.lower()}"
                                                 "_frozen.lpk.npz"))
    data = {"p": (["layer"], np.asarray([98388.0]),
                  {"standard_name": "air_pressure", "units": "Pa"}),
            "t": (["layer"], np.asarray([288.99]),
                  {"standard_name": "air_temperature", "units": "K"})}
    for name, value in GOLDEN_VMR.items():
        data[name.lower()] = (["layer"], np.asarray([value]), {
            "standard_name": f"mole_fraction_of_{STANDARD[name]}_in_air",
            "units": "mol mol-1"})
    spec = pylbl_tpu_torch.Spectroscopy(
        pylbl_tpu_torch.Dataset(data_vars=data), COARSE, db,
        dtype=torch.float64)
    lc.reset_launches()
    a = spec.compute_absorption(output_format=None)["absorption"].data
    assert all(count == 0 for count in lc.LAUNCHES.values())
    assert float(a.max()) == pytest.approx(TOTAL_MAX, rel=1e-6)
    assert float(np.log(a.sum())) == pytest.approx(TOTAL_LOG_SUM, rel=1e-6)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pylbl_tpu_torch.Spectroscopy(canonical_dataset(), COARSE, None,
                                     device="cuda")


def test_port_imports_neither_jax_nor_pylbl_tpu():
    code = (
        "import sys\n"
        "import pylbl_tpu_torch\n"
        "import pylbl_tpu_torch.spectroscopy, pylbl_tpu_torch.plugins\n"
        "import pylbl_tpu_torch.parallel.lines\n"
        "import pylbl_tpu_torch.ops.lineshape_cuda, pylbl_tpu_torch.ops.voigt\n"
        "import pylbl_tpu_torch.ops.interp\n"
        "import pylbl_tpu_torch.models.mt_ckd, pylbl_tpu_torch.models.tips\n"
        "import pylbl_tpu_torch.models.arts_crossfit\n"
        "import pylbl_tpu_torch.models.lines.pedestal\n"
        "import pylbl_tpu_torch.database.db\n"
        "import pylbl_tpu_torch.database.fixtures\n"
        "import pylbl_tpu_torch.runtime.native\n"
        "import pylbl_tpu_torch.utils.xrlite\n"
        "from pylbl_tpu_torch.models.mt_ckd import WaterVaporSelfContinuum\n"
        "WaterVaporSelfContinuum()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'pylbl_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
