"""The port runs from its own directory: it owns every file it reads.

The port keeps copies of the two data files it needs from the JAX package,
the MT-CKD tables and the native C++ source; these tests hold each copy
byte-identical to its original, and run the port from a copy of
``pylbl_tpu_torch/`` alone in an isolated subprocess (``python -I``, the
copy's directory first on ``sys.path``) that refuses to import ``jax`` and
``pylbl_tpu`` and imports the bench entry point (which finds no oracle
beside the copy): the six MT-CKD continua and a pedestal-removed ``Gas``
spectrum (which builds the native scan with g++ into the copy's
``build/``), on the CPU, equal to the same calls in this process.
"""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pylbl_tpu_torch
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.models import mt_ckd
from pylbl_tpu_torch.models.mt_ckd import tables
from pylbl_tpu_torch.runtime import build, native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pylbl_tpu_torch"
CONTINUA = ["CarbonDioxideContinuum", "WaterVaporForeignContinuum",
            "WaterVaporSelfContinuum", "NitrogenContinuum",
            "OxygenContinuum", "OzoneContinuum"]
T = np.asarray([269.01, 288.99])
P = np.asarray([117.0, 98388.0])
VMR = {"H2O": np.asarray([5.244536e-06, 6.637074e-03]),
       "CO2": np.asarray([0.00036, 0.00035999]),
       "O3": np.asarray([2.936688e-06, 6.859128e-08]),
       "O2": np.asarray([0.209, 0.208996]),
       "N2": np.asarray([0.78, 0.78])}
CONTINUUM_GRID = (1.0, 20000.0, 5.0)
LINE_GRID = (50.0, 400.0, 0.2)

# Run from the copy: refuse jax and pylbl_tpu, compute, print JSON.
SCRIPT = """
import importlib.abc, json, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pylbl_tpu"):
            raise ImportError(f"{name} is refused")
        return None

sys.meta_path.insert(0, Refuse())
args = json.loads(sys.argv[1])
sys.path.insert(0, args["root"])
import numpy as np
import pylbl_tpu_torch
import pylbl_tpu_torch.bench
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.models import mt_ckd
from pylbl_tpu_torch.runtime import build, native

vmr = {k: np.asarray(v) for k, v in args["vmr"].items()}
grid = np.arange(*args["continuum_grid"])
out = {"package": pylbl_tpu_torch.__file__, "continua": {}}
for name in args["continua"]:
    k = getattr(mt_ckd, name)().spectra(np.asarray(args["t"]),
                                        np.asarray(args["p"]), vmr, grid)
    out["continua"][name] = np.asarray(k).tolist()
pack = synthetic_line_pack(num_lines=400, nu_min=30.0, nu_max=420.0, seed=5)
gas = pylbl_tpu_torch.Gas(pack, pack.formula, device="cpu")
out["gas"] = np.asarray(gas.absorption_coefficient(
    288.99, 98388.0, 6.6e-3, np.arange(*args["line_grid"]),
    remove_pedestal=True)).tolist()
out["native"] = str(build.BUILD_DIR / "libpylbl_native.so")
out["bench"] = pylbl_tpu_torch.bench.__file__
out["oracle"] = pylbl_tpu_torch.bench.load_oracle()
out["refused"] = [m for m in ("jax", "pylbl_tpu") if m in sys.modules]
print(json.dumps(out))
"""


def sha256(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.mark.parametrize("copy, original", [
    ("models/mt_ckd/mt_ckd_tables.npz",
     "pylbl_tpu/models/mt_ckd/mt_ckd_tables.npz"),
    ("csrc/pylbl_native.cpp", "csrc/pylbl_native.cpp"),
])
def test_copy_is_byte_identical(copy, original):
    """The port's copy of a JAX-package file equals it byte for byte."""
    assert sha256(PORT / copy) == sha256(REPO / original)


def test_port_reads_only_its_own_files():
    """The tables and the native source are read from the package
    directory; the tracked JAX library is never the port's."""
    assert tables.TABLES == PORT / "models" / "mt_ckd" / "mt_ckd_tables.npz"
    assert native.SOURCE == PORT / "csrc" / "pylbl_native.cpp"
    lib = native.load()
    assert Path(lib._name).parent == build.BUILD_DIR
    assert Path(lib._name) != REPO / "csrc" / "libpylbl_native.so"


def test_port_runs_from_its_own_directory(tmp_path):
    """A copy of ``pylbl_tpu_torch/`` alone, with jax and pylbl_tpu
    refused, computes the six continua and a pedestal-removed spectrum
    equal to this process's, building the native scan into the copy."""
    shutil.copytree(PORT, tmp_path / "pylbl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "run.py").write_text(SCRIPT)
    args = {"root": str(tmp_path), "t": T.tolist(), "p": P.tolist(),
            "vmr": {k: v.tolist() for k, v in VMR.items()},
            "continua": CONTINUA, "continuum_grid": CONTINUUM_GRID,
            "line_grid": LINE_GRID}
    result = subprocess.run(
        [sys.executable, "-I", str(tmp_path / "run.py"), json.dumps(args)],
        capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-3000:]
    out = json.loads(result.stdout.strip().splitlines()[-1])
    assert Path(out["package"]).parent == tmp_path / "pylbl_tpu_torch"
    assert out["refused"] == []
    assert Path(out["bench"]).parent == tmp_path / "pylbl_tpu_torch"
    assert out["oracle"] is None
    built = tmp_path / "build" / "pylbl_tpu_torch" / "libpylbl_native.so"
    assert out["native"] == str(built) and built.exists()

    grid = np.arange(*CONTINUUM_GRID)
    for name in CONTINUA:
        want = getattr(mt_ckd, name)().spectra(T, P, VMR, grid)
        got = np.asarray(out["continua"][name])
        assert got.shape == np.shape(want) and np.abs(got).max() > 0
        assert np.array_equal(got, np.asarray(want)), name
    pack = synthetic_line_pack(num_lines=400, nu_min=30.0, nu_max=420.0,
                               seed=5)
    want = pylbl_tpu_torch.Gas(pack, pack.formula, device="cpu") \
        .absorption_coefficient(288.99, 98388.0, 6.6e-3,
                                np.arange(*LINE_GRID), remove_pedestal=True)
    got = np.asarray(out["gas"])
    assert np.isfinite(got).all() and got.max() > 0
    assert np.array_equal(got, np.asarray(want))
