"""The port's native library: the HITRAN CSV parser and the pedestal scan.

Ports of tests/test_native.py:18, :34 and :47.  The parser agrees with the
Python record parser on the rows both accept; the native pedestal scan
agrees with its plain Python version (``_sequential_scan``) on a
pedestal-removed spectrum.  A host without a compiler gets ``BuildError``,
never a slower fallback.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.models.lines import Gas
from pylbl_tpu_torch.models.lines import pedestal
from pylbl_tpu_torch.runtime import build, native
from pylbl_tpu_torch.webapi import parse_transitions

torch.set_num_threads(1)

CSV = ("1,1,1,100.5,1e-25,0.07,0.3,0.7,-0.001,50.0\n"
       "2,1,1,not,a,valid,row,x,y,z\n"
       "3,1,2,200.25,2e-26,0.06,0.2,0.6,0.002,150.0\n"
       "7,1,0,3999.75,4.5e-27,0.05,0.25,0.55,0.0,950.25\n")
PARAMETERS = [name for name, _ in native.CSV_COLUMNS]
TYPES = [int, int, int] + [float] * 7


def test_csv_parser_matches_python():
    """Port of tests/test_native.py:18, on every column."""
    got = native.parse_transitions_csv(CSV)
    expected = parse_transitions(CSV, PARAMETERS, TYPES)
    assert got["nu"].size == len(expected) == 3
    for name, dtype in native.CSV_COLUMNS:
        assert got[name].dtype == dtype
        assert got[name].tolist() == [getattr(t, name) for t in expected]


def test_csv_parser_large_roundtrip():
    """Port of tests/test_native.py:34: 5000 rows, each one read back to
    the value Python reads from its text."""
    rng = np.random.default_rng(0)
    n = 5000
    rows = []
    for i in range(n):
        rows.append(f"{i},1,{int(rng.integers(0, 10))},"
                    f"{rng.uniform(1, 4e4):.6f},{rng.uniform(1e-30, 1e-20):.6e},"
                    f"{rng.uniform(0, 0.2):.4f},{rng.uniform(0, 0.8):.4f},"
                    f"{rng.uniform(0, 1):.4f},{rng.uniform(-0.02, 0.02):.5f},"
                    f"{rng.uniform(0, 5000):.4f}")
    text = "\n".join(rows) + "\n"
    got = native.parse_transitions_csv(text)
    assert got["nu"].size == n
    assert got["global_iso_id"][-1] == n - 1
    want = parse_transitions(text, PARAMETERS, TYPES)
    for name, _ in native.CSV_COLUMNS:
        assert got[name].tolist() == [getattr(t, name) for t in want]


def test_pedestal_scan_native_against_sequential(monkeypatch):
    """Port of tests/test_native.py:47: a 400-line pack with the pedestal
    removed, through the native scan and through ``_sequential_scan``."""
    pack = synthetic_line_pack(num_lines=400, nu_min=30.0, nu_max=420.0,
                               seed=5)
    grid = np.arange(50.0, 400.0, 0.2)
    gas = Gas(pack, pack.formula, device="cpu", dtype=torch.float64,
              backend="xla")
    calls = []

    def counted(scan):
        def run(*args):
            calls.append(scan.__name__)
            return scan(*args)
        return run

    monkeypatch.setattr(native, "pedestal_scan",
                        counted(native.pedestal_scan))
    with_native = gas.absorption_coefficient(288.99, 98388.0, 6.6e-3, grid,
                                             remove_pedestal=True)
    monkeypatch.setattr(native, "pedestal_scan",
                        counted(pedestal._sequential_scan))
    without = gas.absorption_coefficient(288.99, 98388.0, 6.6e-3, grid,
                                         remove_pedestal=True)
    assert calls == ["pedestal_scan", "_sequential_scan"]
    assert np.abs(without).max() > 0
    # Bucket-window sums associate differently (sequential C against numpy
    # pairwise); differences are at the 1e-44 absolute level.
    np.testing.assert_allclose(
        with_native, without, rtol=1e-12,
        atol=float(np.abs(without).max()) * 1e-15)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """Without a compiler the parser raises BuildError; it never returns
    None or falls back to Python."""
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_command", lambda sources, out: [
        str(tmp_path / "no-such-compiler"), *map(str, sources), str(out)])
    assert not native.available()
    with pytest.raises(build.BuildError, match="no-such-compiler"):
        native.parse_transitions_csv(CSV)
