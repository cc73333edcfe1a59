"""The port's pyarts bridge (models/arts_frontend.py), offline.

pyarts is not installed here, so the JAX package's scripted stand-in
(tests/test_arts_frontend.py ``make_fake_pyarts``) is injected and the
port's frontend and plugin registry are reloaded against it: ports of the
four JAX tests, the "arts" registration, and ``Spectroscopy(...,
lines_backend="arts")`` against the JAX package's on the canonical
column.  Each test restores both modules' namespaces afterwards (xdist
runs other files in the same worker); without pyarts the module imports,
"arts" is not registered and ``PyArtsGas`` raises ``ValueError``.
"""
import importlib
import sys

import numpy as np
import pytest

import pylbl_tpu
from pylbl_tpu import spectroscopy as jspectroscopy
from pylbl_tpu.database.db import Database as JDatabase
from pylbl_tpu.database.fixtures import synthetic_line_pack

import pylbl_tpu_torch
from pylbl_tpu_torch import plugins
from pylbl_tpu_torch import spectroscopy as tspectroscopy
from pylbl_tpu_torch.database.db import Database as TDatabase
from pylbl_tpu_torch.models import arts_frontend

from test_arts_frontend import make_fake_pyarts, pack_db
from test_torch_spectroscopy import canonical_dataset

GRID = np.linspace(1.0, 3000.0, 8)   # the stand-in's propmat has 8 points.


def reloaded(module):
    """Reloads ``module`` and returns a function restoring its namespace."""
    saved = dict(vars(module))
    importlib.reload(module)

    def restore():
        vars(module).clear()
        vars(module).update(saved)
    return restore


@pytest.fixture
def frontend(monkeypatch):
    """The port's frontend and registry reloaded against the stand-in."""
    fake = make_fake_pyarts()
    monkeypatch.setitem(sys.modules, "pyarts", fake)
    restores = [reloaded(arts_frontend), reloaded(plugins)]
    yield arts_frontend, fake
    for restore in reversed(restores):
        restore()


def test_iso_letter_codes(frontend):
    mod, _ = frontend
    assert mod._iso_code(11) == "A"
    assert mod._iso_code(12) == "B"
    assert mod._iso_code(1) == "1"
    assert mod._iso_code(10) == "10"


def test_absorption_line_structure(frontend):
    mod, _ = frontend
    qkey, line = mod.absorption_line(1, nu=1000.0, sw=4.0, gamma_air=0.07,
                                     gamma_self=0.3, n_air=0.6,
                                     elower=100.0, delta_air=-0.01,
                                     local_iso_id=11)
    assert qkey == "H2O-A"
    assert line.F0 == pytest.approx(1000.0 * 2.99792458e10)
    assert line.I0 == ("i0", 2.0)          # sw / hitran ratio
    assert line.E0 == ("e0", 100.0)
    self_model, air_model = line.lineshape
    assert self_model.G0 == ("T1", ("hzpa", 0.3), 0.6)
    assert self_model.D0 == ("T0", ("hzpa", -0.01))
    assert air_model.G0 == ("T1", ("hzpa", 0.07), 0.6)
    assert air_model.D0 == ("T0", ("hzpa", -0.01))


def test_absorption_lines_grouping_and_flags(frontend):
    mod, _ = frontend
    rows = [
        (1000.0, 1e-22, 0.07, 0.3, 0.6, 100.0, -0.01, 1),
        (1001.0, 1e-22, 0.07, 0.3, 0.6, 100.0, -0.01, 1),
        (1002.0, 1e-22, 0.07, 0.3, 0.6, 100.0, -0.01, 2),
    ]
    bands = mod.absorption_lines(1, rows)
    assert len(bands) == 2                 # grouped by quantum identity
    assert [b.quantumidentity for b in bands] == ["H2O-1", "H2O-2"]
    by_key = {b.quantumidentity: b for b in bands}
    assert len(by_key["H2O-1"].lines) == 2
    assert len(by_key["H2O-2"].lines) == 1
    band = by_key["H2O-1"]
    # Reference frontend.py:81-97 band flags.
    assert band.lineshapetype == "SplitVP"
    assert band.normalization == "SFS"
    assert band.cutoff == "None"
    assert band.mirroring == "None" and band.population == "LTE"
    assert band.T0 == 296
    assert band.broadeningspecies == ["H2O", "Bath"]
    assert band.selfbroadening and band.bathbroadening


def test_pyarts_gas_workspace_flow(frontend):
    mod, _ = frontend
    pack = synthetic_line_pack(num_lines=10, nu_min=1.0, nu_max=50.0,
                               seed=5)
    gas = mod.PyArtsGas(pack_db(pack), "H2O")
    grid = np.linspace(1.0, 50.0, 8)
    k = gas.absorption_coefficient(288.99, 98388.0, 6.6e-3, grid)
    # propmat value / (number density * vmr)
    density = 98388.0 / (1.380649e-23 * 288.99) * 6.6e-3
    np.testing.assert_allclose(k, 3.0 / density)
    names = [c[0] for c in gas.ws.calls]
    assert names[:1] == ["species"]
    assert "agendaAuto" in names and "lblChecked" in names
    assert names[-1] == "execute"
    assert gas.ws.stokes_dim == 1
    assert len(gas.ws.abs_lines_per_species[0]) == 3   # one per isotope


def test_arts_backend_registered(frontend):
    mod, _ = frontend
    assert mod.ARTS_INSTALLED
    assert plugins.molecular_lines["arts"] is mod.PyArtsGas
    assert "arts" in plugins.models


def test_spectroscopy_arts_matches_jax(frontend, monkeypatch, tmp_path):
    """``Spectroscopy(..., lines_backend="arts")`` in both packages, on
    the canonical column, over one database file."""
    jfront = importlib.import_module("pylbl_tpu.models.arts_frontend")
    restore = reloaded(jfront)
    try:
        monkeypatch.setitem(jspectroscopy.molecular_lines, "arts",
                            jfront.PyArtsGas)
        monkeypatch.setattr(tspectroscopy, "molecular_lines",
                            plugins.molecular_lines)
        jdb = JDatabase(tmp_path / "arts.db")
        for formula, seed in [("H2O", 11), ("CO2", 12)]:
            jdb.ingest_line_pack(synthetic_line_pack(
                formula=formula, num_lines=40, seed=seed))
        want = pylbl_tpu.Spectroscopy(
            canonical_dataset(), GRID, jdb,
            lines_backend="arts").compute_absorption(output_format="all")
        spec = pylbl_tpu_torch.Spectroscopy(
            canonical_dataset(), GRID, TDatabase(tmp_path / "arts.db"),
            lines_backend="arts", device="cpu")
        got = spec.compute_absorption(output_format="all")
    finally:
        restore()
    assert isinstance(spec.cache["H2O"].gas, frontend[0].PyArtsGas)
    assert list(got.data_vars) == list(want.data_vars)
    names = [n for n in want.data_vars if n.endswith("_absorption")]
    assert len(names) == 8
    for name in names:
        assert got[name].data.shape == want[name].data.shape == (4, 3, 8)
        np.testing.assert_allclose(got[name].data, want[name].data,
                                   rtol=1e-12, atol=1e-300)
    lines = got["H2O_absorption"].data[:, 0]
    assert (lines > 0).all()


def test_without_pyarts(monkeypatch):
    """With pyarts missing the module imports, "arts" is not registered
    and the engine refuses to start."""
    monkeypatch.setitem(sys.modules, "pyarts", None)
    restores = [reloaded(arts_frontend), reloaded(plugins)]
    try:
        assert arts_frontend.ARTS_INSTALLED is False
        assert arts_frontend.pyarts is None
        assert "arts" not in plugins.molecular_lines
        with pytest.raises(ValueError, match="pyarts is not installed"):
            arts_frontend.PyArtsGas(pack_db(None), "H2O")
    finally:
        for restore in reversed(restores):
            restore()
    assert "arts" not in pylbl_tpu_torch.molecular_lines
