"""The port's command line (``python -m pylbl_tpu_torch``) on the CPU.

A port of tests/test_cli_and_obs.py:49-92: ``compute`` (in-memory and
``--streamed``) against the port's own ``Spectroscopy`` (rtol 1e-12) and
the JAX package's (in process, rel 5e-4, the float32 device-physics
tolerance of tests/test_multigas.py), ``info``, the refusal to start
without a card unless ``--device cpu`` is given, ``bench``'s refusal to
start without a card, and ``create-db`` against the JAX package's with
stand-in web clients.  ``main(argv)`` runs
in process wherever a subprocess is not the point.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pylbl_tpu
from pylbl_tpu.database.fixtures import synthetic_line_pack

import pylbl_tpu_torch
from pylbl_tpu_torch.__main__ import main
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.utils.observability import metrics
from pylbl_tpu_torch.utils.xrlite import open_dataset

from test_torch_spectroscopy import rel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRID = "1:500:0.5"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A one-layer atmosphere file and a one-gas database (the inputs of
    tests/test_cli_and_obs.py:49)."""
    tmp = tmp_path_factory.mktemp("cli")
    db = Database(tmp / "cli.db")
    db.ingest_line_pack(synthetic_line_pack(num_lines=120, seed=3))
    atm = pylbl_tpu_torch.Dataset(data_vars={
        "p": (["layer"], np.asarray([98388.0]),
              {"standard_name": "air_pressure", "units": "Pa"}),
        "t": (["layer"], np.asarray([288.99]),
              {"standard_name": "air_temperature", "units": "K"}),
        "q": (["layer"], np.asarray([6.6e-3]),
              {"standard_name": "mole_fraction_of_water_vapor_in_air",
               "units": "mol mol-1"}),
    })
    atm.to_netcdf(tmp / "atm.nc")
    return tmp


def compute_args(tmp, output, *extra):
    return ["--device", "cpu", "compute", "--atmosphere", str(tmp / "atm.nc"),
            "--database", str(tmp / "cli.db"), "--grid", GRID, "--output",
            str(output), *extra]


def test_cli_compute_end_to_end(inputs, tmp_path, capsys):
    """Port of tests/test_cli_and_obs.py:49."""
    out_path = tmp_path / "absorption.nc"
    assert main(compute_args(inputs, out_path, "--format", "total",
                             "--metrics")) == 0
    printed = capsys.readouterr().out
    assert f"wrote {out_path}" in printed
    snapshot = json.loads(printed[:printed.rindex("}") + 1])
    assert set(snapshot) == {"counters", "timers"}
    got = open_dataset(out_path)["absorption"].data
    assert got.shape == (1, 998)
    assert np.isfinite(got).all() and got.max() > 0

    grid = np.arange(1.0, 500.0, 0.5)
    atm = open_dataset(inputs / "atm.nc")
    own = pylbl_tpu_torch.Spectroscopy(
        atm, grid, Database(inputs / "cli.db"), device="cpu") \
        .compute_absorption(output_format="total")["absorption"].data
    np.testing.assert_allclose(got, own, rtol=1e-12, atol=0)
    want = pylbl_tpu.Spectroscopy(
        pylbl_tpu.open_dataset(inputs / "atm.nc"), grid,
        pylbl_tpu.Database(inputs / "cli.db")).compute_absorption(
        output_format="total")["absorption"].data
    assert rel(got, want) < 5e-4


def test_cli_compute_metrics_print_the_spans(inputs, tmp_path, capsys):
    """``compute --metrics`` prints the stages of the request path and
    the counters of the per-instance work."""
    metrics.reset()
    assert main(compute_args(inputs, tmp_path / "spans.nc", "--format",
                             "total", "--metrics")) == 0
    printed = capsys.readouterr().out
    snapshot = json.loads(printed[:printed.rindex("}") + 1])
    stages = ("spectroscopy.init", "absorption", "molecules.load",
              "lines.build", "lines.stack", "lines.plan", "lines.upload",
              "lines.run", "lines.guard", "lines.assemble", "lines.wings",
              "lines.core", "continua.run", "output")
    assert all(snapshot["timers"][stage]["calls"] >= 1 for stage in stages)
    assert snapshot["counters"]["lines.builds"] == 1
    assert snapshot["counters"]["molecules.loaded"] == 1
    assert snapshot["counters"]["database.pack_reads"] == 1


def test_cli_compute_streamed(inputs, tmp_path, capsys):
    """``compute --streamed`` writes the file of
    ``compute_absorption_streamed``, timing each stage of its one block."""
    out_path = tmp_path / "streamed.nc"
    metrics.reset()
    assert main(compute_args(inputs, out_path, "--streamed",
                             "--metrics")) == 0
    assert f"wrote {out_path}" in capsys.readouterr().out
    timers = metrics.snapshot()["timers"]
    assert all(timers[f"stream.{stage}"]["calls"] == 1
               for stage in ("lines", "fetch", "mechanisms", "write"))
    want = pylbl_tpu_torch.Spectroscopy(
        open_dataset(inputs / "atm.nc"), np.arange(1.0, 500.0, 0.5),
        Database(inputs / "cli.db"), device="cpu") \
        .compute_absorption_streamed(tmp_path / "direct.nc")
    got = open_dataset(out_path)
    back = open_dataset(want)
    assert list(got.data_vars) == list(back.data_vars)
    assert got["H2O_absorption"].data.shape == (1, 3, 998)
    np.testing.assert_array_equal(got["H2O_absorption"].data,
                                  back["H2O_absorption"].data)
    assert got["H2O_absorption"].data[0, 0].max() > 0


def test_cli_info(capsys):
    """Port of tests/test_cli_and_obs.py:83, in process."""
    assert main(["--device", "cpu", "info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"pylbl_tpu_torch {pylbl_tpu_torch.__version__}")
    assert f"torch {torch.__version__}" in out
    assert "lines backends" in out and "pyLBL" in out
    assert "continua backends: ['mt_ckd']" in out
    assert "native runtime: available" in out
    assert "CUDA kernels: " in out


def test_cli_info_subprocess():
    """``python -m pylbl_tpu_torch --device cpu info`` as a user runs it,
    importing neither jax nor pylbl_tpu."""
    result = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pylbl_tpu_torch",
         "--device", "cpu", "info"],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "lines backends" in result.stdout
    assert "pyLBL" in result.stdout
    imported = {line.split("|")[-1].strip().split(".")[0]
                for line in result.stderr.splitlines()
                if line.startswith("import time:")}
    assert "torch" in imported
    assert not imported & {"jax", "jaxlib", "pylbl_tpu"}


def test_cli_refuses_without_a_card(inputs, tmp_path, capsys):
    """Without ``--device cpu`` the CLI asks for the card: with none it
    exits non-zero naming CUDA, in process and as a subprocess."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["info"], compute_args(inputs, tmp_path / "x.nc")[2:]):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code != 0
        assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "x.nc").exists()
    result = subprocess.run([sys.executable, "-m", "pylbl_tpu_torch", "info"],
                            capture_output=True, text=True, timeout=240,
                            cwd=REPO)
    assert result.returncode != 0
    assert "CUDA is not available" in result.stderr


@pytest.mark.parametrize("command", [["pylbl_tpu_torch", "bench"],
                                     ["pylbl_tpu_torch.bench"]])
def test_bench_refuses_without_a_card(command):
    """``python -m pylbl_tpu_torch bench`` (and the module itself) without
    CUDA exits 2 and says why: the bench has no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    result = subprocess.run([sys.executable, "-m", *command],
                            capture_output=True, text=True, timeout=240,
                            cwd=REPO)
    assert result.returncode == 2
    assert "needs a CUDA card" in result.stdout
    assert "{" not in result.stdout


def test_bench_refuses_another_device(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "bench"])
    assert exc.value.code == 2
    assert "CUDA card only" in capsys.readouterr().err


@pytest.mark.parametrize("molecules", [None, "CO2"])
def test_cli_create_db_matches_jax(tmp_path, monkeypatch, capsys,
                                   molecules):
    """``create-db`` with the web clients and the arts-crossfit download
    stood in writes the database of the JAX package's ``cmd_create_db``,
    and starts on a host without CUDA (it resolves no device)."""
    import sqlite3

    import pylbl_tpu.webapi as jweb
    from pylbl_tpu.__main__ import main as jmain
    from pylbl_tpu.webapi import arts_crossfit_api as jxsec

    import pylbl_tpu_torch.webapi as tweb
    from pylbl_tpu_torch.webapi import arts_crossfit_api as txsec

    from test_ingest import FakeHitran, FakeTips

    keys = []

    def hitran(api_key):
        keys.append(api_key)
        return FakeHitran()

    def download(directory, name=None, url=None):
        (Path(directory) / "coefficients").mkdir()
        for formula in ("CO2", "SF6"):
            (Path(directory) / "coefficients" / f"{formula}.nc").touch()
        return directory

    for module, xsec in ((jweb, jxsec), (tweb, txsec)):
        monkeypatch.setattr(module, "HitranWebApi", hitran)
        monkeypatch.setattr(module, "TipsWebApi", FakeTips)
        monkeypatch.setattr(xsec, "download", download)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = [] if molecules is None else ["--molecules", molecules]
    outs = {}
    for name, run in (("jax", jmain), ("port", main)):
        assert run(["create-db", "--database", str(tmp_path / f"{name}.db"),
                    "--api-key", "KEY", "--xsec-dir",
                    str(tmp_path / f"{name}-xsec"), *extra]) == 0
        outs[name] = capsys.readouterr().out
    assert keys == ["KEY", "KEY"]
    assert outs["port"] == outs["jax"].replace("jax.db", "port.db")
    assert outs["port"].endswith(f"created {tmp_path / 'port.db'}\n")
    for table in ("molecule", "isotopologue", "molecule_alias", "transition",
                  "tips", "artscrossfit"):
        got, want = (sqlite3.connect(tmp_path / f"{name}.db").execute(
            f"SELECT * FROM {table} ORDER BY id").fetchall()
            for name in ("port", "jax"))
        assert got == [tuple(v.replace("jax-xsec", "port-xsec")
                             if isinstance(v, str) else v for v in row)
                       for row in want], table
        assert got, table
