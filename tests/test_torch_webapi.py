"""The port's web clients against the JAX package's, offline.

Ports of the six tests of tests/test_webapi_parsers.py, then the clients
side by side with no network: ``HitranWebApi._download`` replaced by a
recorder serving the same canned JSON and CSV (the same URLs in the same
order, equal records), ``TipsWebApi.download`` over a patched ``urlopen``
(equal float32 arrays) and the arts-crossfit ``download`` of a ``file://``
zip built here (the same tree).
"""
import io
import json
import zipfile
from urllib.error import HTTPError

import numpy as np
import pytest

import pylbl_tpu.webapi as jweb
from pylbl_tpu.webapi import arts_crossfit_api as jxsec
from pylbl_tpu.webapi import tips_api as jtips

import pylbl_tpu_torch
import pylbl_tpu_torch.webapi as tweb
from pylbl_tpu_torch.models import arts_crossfit
from pylbl_tpu_torch.webapi import (NoMoleculeError, TipsWebApi,
                                    parse_transitions)
from pylbl_tpu_torch.webapi import tips_api as ttips

TIPS_TABLE = b"""c This is a comment line
c another comment
   H2O
    T / K    Q(161)      Q(181)
      1.0    1.000       2.000
      2.0    1.100       2.200
      3.0    1.250       2.450
   CO2
    T / K    Q(626)
      1.0    5.000
      2.0    5.500
"""


def test_tips_parser_extracts_molecule_block():
    api = TipsWebApi()
    records = api._records(io.BytesIO(TIPS_TABLE), "H2O")
    temperature, data = api._parse_records(records)
    np.testing.assert_allclose(temperature, [1.0, 2.0, 3.0])
    assert data.shape == (2, 3)
    np.testing.assert_allclose(data[0], [1.0, 1.1, 1.25])
    np.testing.assert_allclose(data[1], [2.0, 2.2, 2.45])


def test_tips_parser_second_molecule():
    api = TipsWebApi()
    temperature, data = api._parse_records(
        api._records(io.BytesIO(TIPS_TABLE), "CO2"))
    assert data.shape == (1, 2)
    np.testing.assert_allclose(data[0], [5.0, 5.5])


def test_tips_parser_missing_molecule():
    api = TipsWebApi()
    with pytest.raises(NoMoleculeError):
        list(api._records(io.BytesIO(TIPS_TABLE), "CH4"))


def test_tips_parser_small_blocks():
    """Line reassembly across block boundaries (reference
    tips_api.py:31-68), against the JAX client's at every block size."""
    lines_big = list(TipsWebApi._ascii_table_records(io.BytesIO(TIPS_TABLE),
                                                     block_size=512))
    for size in (1, 7, 64, 512):
        lines = list(TipsWebApi._ascii_table_records(io.BytesIO(TIPS_TABLE),
                                                     block_size=size))
        assert [x for x in lines if x] == [x for x in lines_big if x]
        assert lines == list(jweb.TipsWebApi._ascii_table_records(
            io.BytesIO(TIPS_TABLE), block_size=size))


def test_transition_csv_parser():
    csv = "1,1,1,100.5,1e-25,0.07,0.3,0.7,-0.001,50.0\n" \
          "2,1,1,bad,row,x,y,z,w,v\n" \
          "3,1,2,200.25,2e-26,0.06,0.2,0.6,0.002,150.0\n"
    parameters = ["global_iso_id", "molec_id", "local_iso_id", "nu", "sw",
                  "gamma_air", "gamma_self", "n_air", "delta_air", "elower"]
    types = [int, int, int, float, float, float, float, float, float, float]
    out = parse_transitions(csv, parameters, types)
    assert len(out) == 2  # malformed row skipped with a warning.
    assert out[0].nu == 100.5
    assert out[1].local_iso_id == 2
    assert out == jweb.parse_transitions(csv, parameters, types)


def test_hitran_client_constructs_offline():
    from pylbl_tpu_torch.webapi import HitranWebApi, query_string
    api = HitranWebApi("dummy-key")
    assert api.api_key == "dummy-key"
    assert query_string(iso_ids_list=[1, 2], numin=0.0, head=False) == \
        "iso_ids_list=1,2&numin=0.0&head=False"
    assert pylbl_tpu_torch.HitranWebApi is HitranWebApi
    assert pylbl_tpu_torch.TipsWebApi is TipsWebApi


# ----------------------- the clients side by side -----------------------

HOST = "https://hitran.example"
PARAMETER_METAS = [{"name": name, "type": kind} for name, kind in [
    ("global_iso_id", "int"), ("molec_id", "int"), ("local_iso_id", "int"),
    ("nu", "float"), ("sw", "float"), ("gamma_air", "float"),
    ("gamma_self", "float"), ("n_air", "float"), ("delta_air", "float"),
    ("elower", "float")]]
MOLECULES = [{"id": 1, "ordinary_formula": "H2O", "common_name": "water",
              "aliases": [{"alias": "H2O"}]},
             {"id": 2, "ordinary_formula": "CO2", "common_name": "carbon "
              "dioxide", "aliases": [{"alias": "CO2"}]}]
ISOTOPOLOGUES = [{"id": 11, "molecule_id": 1, "isoid": 1, "iso_name": "161",
                  "abundance": 0.997, "mass": 18.01,
                  "molecule_alias": "H2O"},
                 {"id": 12, "molecule_id": 1, "isoid": 2, "iso_name": "181",
                  "abundance": 2.0e-3, "mass": 20.01,
                  "molecule_alias": "H2O"}]
TRANSITIONS = ("1,1,1,100.5,1e-25,0.07,0.3,0.7,-0.001,50.0\n"
               "2,1,2,bad,row,x,y,z,w,v\n"
               "2,1,2,200.25,2e-26,0.06,0.2,0.6,0.002,150.0\n")
BANDS = [{"id": 5, "molecule_id": 2, "filename": "CO2_band1.xsc",
          "numin": 600.0},
         {"id": 6, "molecule_id": 2, "filename": "CO2_band2.xsc",
          "numin": 2000.0, "data": "from the record"}]


def canned(url):
    """The body a recording server gives for ``url``."""
    if url.startswith(f"{HOST}/results/"):
        return TRANSITIONS
    if url.startswith(f"{HOST}/xsec/"):
        return f"cross-section file {url.rsplit('/', 1)[-1]}\n"
    section = url.split("/")[6].split("?")[0]
    data = {"info": {"results_dir": "results", "xsec_dir": "xsec"},
            "parameter-metas": PARAMETER_METAS, "molecules": MOLECULES,
            "isotopologues": ISOTOPOLOGUES, "transitions": "out.csv",
            "cross-sections": BANDS, "sources": [{"id": 3}]}[section]
    return json.dumps({"timestamp": "2026-01-01", "content": {"data": data}})


def recorded(cls, monkeypatch, calls, fail=()):
    """A client of ``cls`` whose downloads go to :func:`canned`, appended
    to ``calls`` as (url, chunk); sections in ``fail`` raise HTTPError."""
    def download(self, url, chunk):
        calls.append((url, chunk))
        if any(f"/{name}?" in url for name in fail):
            raise HTTPError(url, 404, "not found", None, None)
        return canned(url)

    monkeypatch.setattr(cls, "_download", download)
    return cls("KEY", host=HOST)


def molecule(module, i):
    return module.Struct(**MOLECULES[i])


def isotopologues(module):
    return [module.Struct(**x) for x in ISOTOPOLOGUES]


CALLS = {
    "molecules": lambda m, api: api.download_molecules(),
    "isotopologues": lambda m, api: api.download_isotopologues(
        [molecule(m, 0), molecule(m, 1)]),
    "isotopologues_one": lambda m, api: api.download_isotopologues(
        molecule(m, 0)),
    "transitions_csv": lambda m, api: api.download_transitions_csv(
        isotopologues(m), 0.0, 1.0e8),
    "transitions": lambda m, api: api.download_transitions(
        isotopologues(m), 0.0, 1.0e8),
    "cross_sections": lambda m, api: api.download_cross_sections(
        molecule(m, 1)),
    "data_sources": lambda m, api: api.download_data_sources([3, 4]),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_hitran_client_matches_jax(call, monkeypatch, capsys):
    """The same URLs in the same order, and equal records."""
    want_calls, got_calls = [], []
    want = CALLS[call](jweb, recorded(jweb.HitranWebApi, monkeypatch,
                                      want_calls))
    jax_out = capsys.readouterr().out
    got = CALLS[call](tweb, recorded(tweb.HitranWebApi, monkeypatch,
                                     got_calls))
    assert capsys.readouterr().out == jax_out
    assert got_calls == want_calls and got_calls
    assert got == want


def test_hitran_client_errors_match_jax(monkeypatch):
    """A missing result file is NoTransitionsError, and an empty
    isotopologue list NoIsotopologueError, in both clients, after the same
    requests."""
    for module in (jweb, tweb):
        calls = []
        api = recorded(module.HitranWebApi, monkeypatch, calls,
                       fail=("transitions",))
        with pytest.raises(module.NoTransitionsError, match="H2O"):
            api.download_transitions_csv(isotopologues(module), 0.0, 1.0e8,
                                         ["nu"])
        with pytest.raises(module.NoIsotopologueError):
            api.download_transitions_csv([], 0.0, 1.0e8, ["nu"])
        assert [url for url, _ in calls] == [
            f"{HOST}/api/v2/KEY/transitions?iso_ids_list=11,12&numin=0.0&"
            "numax=100000000.0&head=False&fixwidth=0&request_params=nu"]


def tips_table(num_rows=300):
    """A TIPS table larger than one 512-byte block, three molecules."""
    lines = [b"c TIPS 2017 supplementary table"]
    for formula, num_iso in (("H2O", 3), ("CO2", 2), ("O3", 1)):
        lines += [f"   {formula}".encode(),
                  ("    T / K" + "    Q(x)" * num_iso).encode()]
        for t in range(1, num_rows + 1):
            qs = "".join(f" {0.1 * t * (i + 1) + 1.0 / 3.0:12.6f}"
                         for i in range(num_iso))
            lines.append(f"   {t:7.1f}{qs}".encode())
    return b"\n".join(lines) + b"\n"


@pytest.mark.parametrize("formula", ["H2O", "CO2", "O3"])
def test_tips_download_matches_jax(formula, monkeypatch):
    table = tips_table()
    urls = []

    def urlopen(url):
        urls.append(url)
        return io.BytesIO(table)

    monkeypatch.setattr(jtips, "urlopen", urlopen)
    monkeypatch.setattr(ttips, "urlopen", urlopen)
    want = jweb.TipsWebApi().download(formula)
    got = TipsWebApi().download(formula)
    assert urls[0] == urls[1] == TipsWebApi().url
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape and np.array_equal(a, b)
    assert got[0].shape == (300,)
    with pytest.raises(NoMoleculeError):
        TipsWebApi().download("CH4")


def test_arts_crossfit_download_matches_jax(tmp_path):
    """``download`` of a ``file://`` zip extracts the tree the JAX
    function extracts."""
    archive = tmp_path / "coefficients.zip"
    rng = np.random.default_rng(4)
    with zipfile.ZipFile(archive, "w") as handle:
        for name in ("CFC11", "CF4", "SF6"):
            handle.writestr(f"coefficients/{name}.nc",
                            rng.bytes(int(rng.integers(10, 5000))))
        handle.writestr("coefficients/README", "fit coefficients\n")
    url = archive.as_uri()
    assert jxsec.download(tmp_path / "jax", url=url) == tmp_path / "jax"
    assert arts_crossfit.download(tmp_path / "port", "ignored",
                                  url=url) == tmp_path / "port"

    def tree(root):
        return {p.relative_to(root).as_posix(): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert len(tree(tmp_path / "port")) == 4
    assert sorted(tmp_path.iterdir()) == [archive, tmp_path / "jax",
                                          tmp_path / "port"]
