"""The port's ``Database.create`` against the JAX package's, offline.

The JAX package's stand-in clients (tests/test_ingest.py ``FakeHitran``,
``FakeTips``) feed both packages' ``create``: the same rows in all seven
tables, the same prints.  Then the port of ``test_create_flow_offline``
(its spectrum through the port's ``Gas`` against the JAX float64 engine),
the native and the Python transition paths row for row, the skip and
filter semantics, the cross-section leg, and the exact round trip of line
packs written as CSV text by ``chip_smoke.py``'s stand-in clients (the
ones its phase 16 drives at A's width on the card).
"""
import importlib.util
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch

import pylbl_tpu
import pylbl_tpu.webapi as jweb
from pylbl_tpu.database.db import Database as JDatabase
from pylbl_tpu.webapi import arts_crossfit_api as jxsec

import pylbl_tpu_torch
import pylbl_tpu_torch.webapi as tweb
from pylbl_tpu_torch.database import fixtures
from pylbl_tpu_torch.database.db import Database as TDatabase
from pylbl_tpu_torch.webapi import arts_crossfit_api as txsec

from test_ingest import FakeHitran, FakeTips
from test_torch_spectroscopy import rel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TABLES = ("molecule", "isotopologue", "molecule_alias", "transition",
          "tips", "artscrossfit", "metadata")
PACK_ARRAYS = ("nu", "sw", "gamma_air", "gamma_self", "n_air", "elower",
               "delta_air", "iso", "mass_slots", "q_table", "q_temperature")


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rows(path, table):
    con = sqlite3.connect(path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
    finally:
        con.close()


def created(cls, path, hitran, tips, capsys, **kwargs):
    """(database, printed text) of ``cls(path).create``."""
    db = cls(path)
    capsys.readouterr()
    db.create(hitran, tips_webapi=tips, cross_section_directory=None,
              **kwargs)
    return db, capsys.readouterr().out


class RecordingHitran(FakeHitran):
    """FakeHitran recording the requests for transitions."""

    def __init__(self):
        super().__init__()
        self.requests = []

    def download_transitions_csv(self, isotopologues, numin, numax,
                                 parameters):
        self.requests.append(([x.id for x in isotopologues], numin, numax,
                              list(parameters)))
        return super().download_transitions_csv(isotopologues, numin, numax,
                                                parameters)


def test_create_rows_match_jax(tmp_path, capsys):
    """The same client answers give the same rows in all seven tables,
    after the same requests."""
    jax_client, port_client = RecordingHitran(), RecordingHitran()
    _, want_out = created(JDatabase, tmp_path / "jax.db", jax_client,
                          FakeTips(), capsys)
    _, got_out = created(TDatabase, tmp_path / "port.db", port_client,
                         FakeTips(), capsys)
    assert port_client.requests == jax_client.requests
    assert len(port_client.requests) == 2
    assert got_out == want_out and "Working on molecule 2 / 2" in got_out
    for table in TABLES:
        assert rows(tmp_path / "port.db", table) == \
            rows(tmp_path / "jax.db", table), table
    assert len(rows(tmp_path / "port.db", "transition")) == 100
    assert len(rows(tmp_path / "port.db", "tips")) == 2 * 2 * 500
    for name in ("H2O", "CO2"):
        for got, want in zip(TDatabase(tmp_path / "port.db").tips(name),
                             JDatabase(tmp_path / "jax.db").tips(name)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_create_flow_offline(tmp_path):
    """Port of tests/test_ingest.py:58, with the spectrum against the JAX
    package's float64 engine on the JAX package's own ingested file."""
    db = TDatabase(tmp_path / "ingest.db")
    db.create(FakeHitran(), molecules="all", tips_webapi=FakeTips(),
              cross_section_directory=None)
    assert db.molecules() == ["H2O", "CO2"]
    assert db.cross_section_directory is None
    pack = db.line_pack("water")   # alias lookup.
    assert pack.num_lines == 50    # malformed row dropped.
    assert pack.mass_slots[0] == 19.0
    temperature, q = db.tips("CO2")
    assert q.shape == (2, 500)
    gas = db.gas("H2O")
    assert gas[0] == "H2O"
    grid = np.arange(90.0, 160.0, 0.5)
    k = pylbl_tpu_torch.Gas(db, "H2O", device="cpu").absorption_coefficient(
        288.99, 98388.0, 6.6e-3, grid)
    assert np.isfinite(k).all() and k.max() > 0
    jdb = JDatabase(tmp_path / "jax.db")
    jdb.create(FakeHitran(), molecules="all", tips_webapi=FakeTips(),
               cross_section_directory=None)
    want = pylbl_tpu.Gas(jdb, "H2O", dtype=np.float64, backend="xla") \
        .absorption_coefficient(288.99, 98388.0, 6.6e-3, grid)
    assert rel(k, want) < 5e-6


class PythonPathHitran:
    """FakeHitran without ``download_transitions_csv``: ``create`` then
    takes the records of ``download_transitions``."""

    def __init__(self):
        self._fake = FakeHitran()
        self.download_molecules = self._fake.download_molecules
        self.download_isotopologues = self._fake.download_isotopologues
        self.download_transitions = self._fake.download_transitions


def test_native_and_python_paths_identical(tmp_path, capsys):
    """The native parser and the Python records give the same rows, in
    the port and in the JAX package."""
    created(TDatabase, tmp_path / "native.db", FakeHitran(), FakeTips(),
            capsys)
    _, out = created(TDatabase, tmp_path / "python.db", PythonPathHitran(),
                     FakeTips(), capsys)
    assert out.count("skipping transition: bad,row") == 2
    created(JDatabase, tmp_path / "jax.db", PythonPathHitran(), FakeTips(),
            capsys)
    want = rows(tmp_path / "native.db", "transition")
    assert len(want) == 100
    assert rows(tmp_path / "python.db", "transition") == want
    assert rows(tmp_path / "jax.db", "transition") == want


class SkippingHitran(FakeHitran):
    """Three molecules; CO2 has no transitions in ``module``'s terms."""

    def __init__(self, module):
        super().__init__()
        self.module = module
        self.molecules.append(module.Struct(
            id=6, stoichiometric_formula="CH4", ordinary_formula="CH4",
            common_name="methane", aliases=[{"alias": "CH4"}]))

    def download_transitions_csv(self, isotopologues, numin, numax,
                                 parameters):
        if isotopologues[0].molecule_alias == "CO2":
            raise self.module.NoTransitionsError("none")
        return super().download_transitions_csv(isotopologues, numin, numax,
                                                parameters)


class SkippingTips(FakeTips):
    def __init__(self, module):
        self.module = module

    def download(self, molecule):
        if molecule == "CH4":
            raise self.module.NoMoleculeError("none")
        return super().download(molecule)


@pytest.mark.parametrize("molecules", ["all", ["CH4", "CO2"]])
def test_create_skips_like_jax(tmp_path, capsys, molecules):
    """Missing transitions or TIPS tables skip a molecule with the same
    message and leave the same rows; a molecule list filters the same."""
    _, want_out = created(JDatabase, tmp_path / "jax.db",
                          SkippingHitran(jweb), SkippingTips(jweb), capsys,
                          molecules=molecules)
    _, got_out = created(TDatabase, tmp_path / "port.db",
                         SkippingHitran(tweb), SkippingTips(tweb), capsys,
                         molecules=molecules)
    assert got_out == want_out
    assert "No transitions for molecule CO2." in got_out
    assert "No molecule CH4 found in TIPS database." in got_out
    for table in TABLES:
        assert rows(tmp_path / "port.db", table) == \
            rows(tmp_path / "jax.db", table), table


def test_create_ingests_cross_sections(tmp_path, monkeypatch, capsys):
    """``create`` unpacks the arts-crossfit archive into the directory and
    records its files as the JAX package does."""
    def fake_download(directory, name=None, url=None):
        coefficients = Path(directory) / "coefficients"
        coefficients.mkdir()
        for formula in ("CFC11", "H2O", "SF6"):
            (coefficients / f"{formula}.nc").write_bytes(b"")
        return directory

    monkeypatch.setattr(jxsec, "download", fake_download)
    monkeypatch.setattr(txsec, "download", fake_download)
    jdb = JDatabase(tmp_path / "jax.db")
    jdb.create(FakeHitran(), tips_webapi=FakeTips(),
               cross_section_directory=str(tmp_path / "jax-xsec"))
    db = TDatabase(tmp_path / "port.db")
    db.create(FakeHitran(), tips_webapi=FakeTips(),
              cross_section_directory=str(tmp_path / "port-xsec"))
    assert db.cross_section_directory == str(tmp_path / "port-xsec")
    assert db.arts_crossfit("SF6") == str(
        tmp_path / "port-xsec" / "coefficients" / "SF6.nc")
    for table in TABLES:
        want = [tuple(str(v).replace("jax-xsec", "port-xsec")
                      if isinstance(v, str) else v for v in row)
                for row in rows(tmp_path / "jax.db", table)]
        assert rows(tmp_path / "port.db", table) == want, table
    assert db.molecules() == ["H2O", "CO2", "CFC11", "SF6"]


def test_packs_round_trip_through_csv(tmp_path, capsys):
    """Line packs served as CSV text by chip_smoke.py's stand-in clients
    come back from ``line_pack`` exactly, in both packages (isoid 10
    included)."""
    smoke = load_smoke()
    packs = {name: fixtures.synthetic_line_pack(
        name, num_lines=num, nu_min=0.5, nu_max=600.0, seed=seed,
        num_iso=iso) for name, num, seed, iso in [("H2O", 700, 1, 3),
                                                  ("CO2", 300, 2, 11)]}
    packs["CO2"].iso[::7] = 10
    for cls, path in ((TDatabase, tmp_path / "port.db"),
                      (JDatabase, tmp_path / "jax.db")):
        hitran = smoke.HitranStandIn(packs)
        db, _ = created(cls, path, hitran, smoke.TipsStandIn(packs), capsys)
        assert set(hitran.texts) == set(packs)
        for name, pack in packs.items():
            got = db.line_pack(name)
            for field in PACK_ARRAYS:
                a, b = getattr(got, field), getattr(pack, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (name, field)
    assert rows(tmp_path / "port.db", "transition") == \
        rows(tmp_path / "jax.db", "transition")
    isos = rows(tmp_path / "port.db", "isotopologue")
    assert len({row[0] for row in isos}) == len(isos) == 3 + 11
    assert (210, 2, 0, "CO2-10", 1.0, packs["CO2"].mass_slots[9]) in isos
