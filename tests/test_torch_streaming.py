"""The port's streamed output (utils/streaming.py and
``Spectroscopy.compute_absorption_streamed``) against the JAX package's.

Ports of tests/test_streaming.py (resume, streamed equal to in-memory,
dimension scales, resume of a non-contiguous pending set), the port's file
against the JAX package's on the same database and column (lines rel
5e-4, the float32 device-physics tolerance of tests/test_multigas.py;
continua and cross sections rtol 1e-12, as tests/test_torch_spectroscopy.py),
files that one package starts and the other finishes, block sizes that
give bit-identical files, the per-gas fallbacks (and which engine entry
point a one-state call and a one-state block take), and the block loop on
a host without h5py.
"""
import json
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
from pylbl_tpu.utils.streaming import StreamingWriter as JStreamingWriter

import pylbl_tpu_torch
from pylbl_tpu_torch.database.db import Database as TDatabase
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.utils.streaming import StreamingWriter
from pylbl_tpu_torch.utils.xrlite import open_dataset

from test_torch_spectroscopy import rel, write_xsec

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COARSE = np.arange(1.0, 3000.0, 1.0)


def read_file(path):
    """{variable: data} of a streamed file, with its metadata, the
    per-variable dims, chunks and dtypes and the completion vector."""
    with h5py.File(path, "r") as f:
        meta = json.loads(f.attrs["pylbl_tpu_stream"])
        layout = {name: (f[name].attrs["_pylbl_dims"],
                         [d[0].name.lstrip("/") for d in f[name].dims],
                         f[name].shape, f[name].chunks, f[name].dtype,
                         f[name].attrs["units"])
                  for name in meta["variables"]}
        data = {name: f[name][()] for name in meta["variables"]}
        return {"keys": sorted(f.keys()), "meta": meta, "layout": layout,
                "data": data, "complete": f["_complete"][()],
                "wavenumber": f["wavenumber"][()]}


def port_spec(atmosphere_dataset, db, **kwargs):
    return pylbl_tpu_torch.Spectroscopy(atmosphere_dataset, COARSE, db,
                                        device="cpu", **kwargs)


@pytest.fixture(scope="module")
def database(tmp_path_factory):
    """One sqlite file written by the JAX package and opened by both: two
    line gases and a CH4 cross section."""
    tmp = tmp_path_factory.mktemp("stream")
    db = JDatabase(tmp / "stream.db")
    for formula, seed, num in [("H2O", 21, 200), ("CO2", 22, 150)]:
        db.ingest_line_pack(synthetic_line_pack(formula=formula,
                                                num_lines=num, seed=seed))
    write_xsec(tmp / "coefficients")
    db.ingest_arts_crossfit_directory(str(tmp / "coefficients"))
    return db, TDatabase(tmp / "stream.db"), tmp


@pytest.fixture(scope="module")
def canonical():
    """The canonical 4-layer column (tests/conftest.py), module-scoped."""
    from test_torch_spectroscopy import canonical_dataset
    return canonical_dataset()


@pytest.fixture(scope="module")
def jax_file(database, canonical):
    _, _, tmp = database
    return pylbl_tpu.Spectroscopy(canonical, COARSE, database[0]) \
        .compute_absorption_streamed(tmp / "jax.nc")


@pytest.fixture(scope="module")
def port_file(database, canonical):
    _, _, tmp = database
    return port_spec(canonical, database[1]).compute_absorption_streamed(
        tmp / "port.nc")


def test_streaming_writer_resume(tmp_path):
    """Port of tests/test_streaming.py:10."""
    path = tmp_path / "stream.nc"
    grid = np.arange(1.0, 50.0, 0.5)
    with StreamingWriter(path, 3, grid, ["a"]) as writer:
        assert list(writer.pending_states()) == [0, 1, 2]
        writer.write_state(0, {"a": np.full(grid.size, 1.0)})
        writer.write_state(2, {"a": np.full(grid.size, 3.0)})
    with StreamingWriter(path, 3, grid, ["a"]) as writer:
        assert list(writer.pending_states()) == [1]
        writer.write_state(1, {"a": np.full(grid.size, 2.0)})
    back = open_dataset(path)
    np.testing.assert_array_equal(back["a"].data[:, 0], [1.0, 2.0, 3.0])
    with StreamingWriter(path, 3, grid, ["a"], mode="w") as writer:
        assert list(writer.pending_states()) == [0, 1, 2]


def test_streamed_matches_in_memory(tmp_path, atmosphere_dataset,
                                    coarse_grid):
    """Port of tests/test_streaming.py:25."""
    db = TDatabase(tmp_path / "s.db")
    db.ingest_line_pack(synthetic_line_pack(num_lines=200, seed=21))
    spec = pylbl_tpu_torch.Spectroscopy(atmosphere_dataset, coarse_grid, db,
                                        device="cpu")
    full = spec.compute_absorption(output_format="all")
    lc.reset_launches()
    out = spec.compute_absorption_streamed(tmp_path / "out.nc")
    assert sum(lc.LAUNCHES.values()) == 0
    back = open_dataset(out)
    np.testing.assert_allclose(
        back["H2O_absorption"].data,
        full.data_vars["H2O_absorption"].data, rtol=1e-12)
    np.testing.assert_array_equal(back["wavenumber"].data, coarse_grid)


def test_streaming_writer_dimension_scales(tmp_path):
    """Port of tests/test_streaming.py:83."""
    grid = np.arange(1.0, 5.0, 0.5)
    path = tmp_path / "scales.nc"
    with StreamingWriter(path, 3, grid, ["a"],
                         extra_dims={"mechanism": 2}) as w:
        for i in range(3):
            w.write_state(i, {"a": np.full((2, grid.size), float(i))})
    with h5py.File(path) as f:
        assert f["wavenumber"].attrs["CLASS"] == b"DIMENSION_SCALE"
        for dim, size in (("state", 3), ("mechanism", 2)):
            assert f[dim].attrs["CLASS"] == b"DIMENSION_SCALE"
            assert f[dim].attrs["NAME"].startswith(
                b"This is a netCDF dimension but not a netCDF variable.")
            assert f[dim].shape == (size,)
        assert [d[0].name.lstrip("/") for d in f["a"].dims] == \
            ["state", "mechanism", "wavenumber"]


def test_streamed_resume_skips_complete_states(tmp_path, atmosphere_dataset,
                                               coarse_grid):
    """Port of tests/test_streaming.py:107: with states 0 and 2 done the
    pending set [1, 3] is non-contiguous; resume computes only it and
    leaves the sentinels alone."""
    db = TDatabase(tmp_path / "r.db")
    db.ingest_line_pack(synthetic_line_pack(num_lines=200, seed=21))
    spec = pylbl_tpu_torch.Spectroscopy(atmosphere_dataset, coarse_grid, db,
                                        device="cpu")
    full = spec.compute_absorption_streamed(tmp_path / "full.nc",
                                            block_layers=2)
    ref = open_dataset(full)["H2O_absorption"].data
    num_states = ref.shape[0]
    assert num_states >= 3
    with h5py.File(tmp_path / "full.nc", "r") as f:
        meta = json.loads(f.attrs["pylbl_tpu_stream"])
        var_names = meta["variables"]
        shape_tail = f[var_names[0]].shape[1:]
    path = tmp_path / "resume.nc"
    with StreamingWriter(path, num_states, coarse_grid, var_names,
                         extra_dims={"mechanism": shape_tail[0]}) as w:
        for i in (0, 2):
            w.write_state(i, {n: np.full(shape_tail, -7.0)
                              for n in var_names})
    out = spec.compute_absorption_streamed(path, block_layers=2)
    back = open_dataset(out)["H2O_absorption"].data
    assert np.all(back[0] == -7.0) and np.all(back[2] == -7.0)
    for i in range(num_states):
        if i in (0, 2):
            continue
        np.testing.assert_allclose(back[i], ref[i], rtol=1e-12)


def test_streamed_file_matches_jax(jax_file, port_file, canonical):
    """The port's file against the JAX package's on the same database and
    column: the same layout, metadata and completion vector; lines within
    5e-4, continua and cross sections to round-off."""
    got, want = read_file(port_file), read_file(jax_file)
    assert got["keys"] == want["keys"]
    assert got["meta"] == want["meta"]
    assert got["meta"]["variables"] == [
        f"{n}_absorption" for n in pylbl_tpu_torch.Atmosphere(canonical).gases]
    assert got["meta"]["extra_dims"] == {"mechanism": 3}
    assert got["layout"] == want["layout"]
    np.testing.assert_array_equal(got["complete"], np.ones(4, np.int8))
    np.testing.assert_array_equal(want["complete"], got["complete"])
    np.testing.assert_array_equal(got["wavenumber"], want["wavenumber"])
    for name, data in want["data"].items():
        assert got["data"][name].shape == data.shape == (4, 3, COARSE.size)
        assert rel(got["data"][name][:, 0], data[:, 0]) < 5e-4
        np.testing.assert_allclose(got["data"][name][:, 1:], data[:, 1:],
                                   rtol=1e-12, atol=1e-300)
    assert want["data"]["H2O_absorption"][:, 0].max() > 0
    assert want["data"]["CH4_absorption"][:, 2].max() > 0


def test_streamed_file_matches_own_in_memory(database, canonical,
                                             port_file):
    """Every variable of the port's file equals its in-memory "all"
    output."""
    full = port_spec(canonical, database[1]).compute_absorption("all")
    back = read_file(port_file)["data"]
    for name, data in back.items():
        np.testing.assert_allclose(data, full[name].data, rtol=1e-12,
                                   atol=0)


@pytest.mark.parametrize("starter", ["jax", "port"])
def test_cross_resume(database, canonical, jax_file, port_file, tmp_path,
                      starter):
    """A file one package's writer started is finished by the other
    package's ``compute_absorption_streamed``: only the pending states
    are computed and the file then equals the finisher's own full file."""
    finisher_file = port_file if starter == "jax" else jax_file
    full = read_file(finisher_file)
    done = (0, 2) if starter == "jax" else (1, 3)
    writer_cls = JStreamingWriter if starter == "jax" else StreamingWriter
    path = tmp_path / "started.nc"
    with writer_cls(path, 4, COARSE, full["meta"]["variables"],
                    extra_dims=full["meta"]["extra_dims"]) as writer:
        for i in done:
            writer.write_state(i, {n: v[i] for n, v in full["data"].items()})
        assert sorted(set(range(4)) - set(done)) == \
            list(writer.pending_states())
    if starter == "jax":
        port_spec(canonical, database[1]).compute_absorption_streamed(path)
    else:
        pylbl_tpu.Spectroscopy(canonical, COARSE, database[0]) \
            .compute_absorption_streamed(path)
    back = read_file(path)
    assert back["meta"] == full["meta"] and back["layout"] == full["layout"]
    np.testing.assert_array_equal(back["complete"], np.ones(4, np.int8))
    for name, data in full["data"].items():
        np.testing.assert_array_equal(back["data"][name][list(done)],
                                      data[list(done)])
        np.testing.assert_allclose(back["data"][name], data, rtol=1e-12,
                                   atol=0)


def test_block_sizes_bit_identical(database, canonical, port_file, tmp_path):
    """block_layers 1, 3 and 4 (a block of 3 against a final block of 1)
    give the file of the default single block bit for bit."""
    want = read_file(port_file)["data"]
    spec = port_spec(canonical, database[1])
    for block_layers in (1, 3, 4):
        path = spec.compute_absorption_streamed(
            tmp_path / f"b{block_layers}.nc", block_layers=block_layers)
        got = read_file(path)["data"]
        for name, data in want.items():
            np.testing.assert_array_equal(got[name], data)


class LayerByLayer:
    """A lines engine with neither packed lines nor a batch entry point
    (as a third-party plugin may be): every layer is its own call."""

    def __init__(self, database, name):
        self._gas = pylbl_tpu_torch.Gas(database, name, device="cpu")

    def absorption_coefficient(self, *args, **kwargs):
        return self._gas.absorption_coefficient(*args, **kwargs)


class BothEntryPoints(LayerByLayer):
    """A lines engine without packed lines that has both entry points and
    records in ``calls`` which one ran (the portable backend, whose batch
    is a loop of single layers, so both give the same bits)."""

    def __init__(self, database, name):
        self._gas = pylbl_tpu_torch.Gas(database, name, device="cpu",
                                        backend="xla")
        self.calls = []

    def absorption_coefficient(self, *args, **kwargs):
        self.calls.append("absorption_coefficient")
        return super().absorption_coefficient(*args, **kwargs)

    def absorption_coefficient_batch(self, *args, **kwargs):
        self.calls.append("absorption_coefficient_batch")
        return self._gas.absorption_coefficient_batch(*args, **kwargs)


def engine_calls(spec):
    """{gas: the entry points its engine ran since the last look}."""
    calls = {}
    for name, data in spec.cache.items():
        if data.gas is not None:
            calls[name], data.gas.calls = data.gas.calls, []
    return calls


@pytest.mark.parametrize("fallback", ["xla", "layer_by_layer", "one_state"])
def test_streamed_per_gas_fallback(database, canonical, tmp_path,
                                   monkeypatch, fallback):
    """Lines the stacked path leaves to the per-gas engines: under
    backend="xla" one ``absorption_coefficient_batch`` per gas and block,
    for an engine without one a loop over the block's layers.  The file
    equals the in-memory "all" output of the same engine and backend.

    On a one-state column with both entry points, ``compute_absorption``
    takes ``absorption_coefficient`` and a streamed block
    ``absorption_coefficient_batch``, as the JAX package does."""
    if fallback == "xla":
        spec = port_spec(canonical, database[1], backend="xla")
    else:
        engine = LayerByLayer
        atmosphere = canonical
        if fallback == "one_state":
            engine = BothEntryPoints
            atmosphere = pylbl_tpu_torch.Dataset(data_vars={
                name: (var.dims, var.data[3:], var.attrs)
                for name, var in canonical.data_vars.items()})
        monkeypatch.setitem(pylbl_tpu_torch.plugins.molecular_lines,
                            fallback, engine)
        spec = port_spec(atmosphere, database[1], lines_backend=fallback)
    full = spec.compute_absorption("all")
    if fallback == "one_state":
        assert engine_calls(spec) == {
            "H2O": ["absorption_coefficient"],
            "CO2": ["absorption_coefficient"]}
    back = read_file(spec.compute_absorption_streamed(
        tmp_path / "fallback.nc", block_layers=3))["data"]
    if fallback == "one_state":
        assert engine_calls(spec) == {
            "H2O": ["absorption_coefficient_batch"],
            "CO2": ["absorption_coefficient_batch"]}
    assert not spec._multigas_fns
    assert back["H2O_absorption"][:, 0].max() > 0
    for name, data in back.items():
        np.testing.assert_allclose(data, full[name].data, rtol=1e-12,
                                   atol=0)


def test_stream_blocks_without_h5py(tmp_path):
    """As on a host without h5py: the streaming module imports, and the
    block loop runs into an in-memory writer and matches
    ``compute_absorption("all")``."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import pylbl_tpu_torch.utils.streaming\n"
        "import pylbl_tpu_torch as P\n"
        "from pylbl_tpu_torch.database.fixtures import synthetic_line_pack\n"
        "class Memory:\n"
        "    def __init__(self, names, num, shape):\n"
        "        self.out = {n: np.full((num,) + shape, np.nan)\n"
        "                    for n in names}\n"
        "        self.complete = np.zeros(num, np.int8)\n"
        "    def pending_states(self):\n"
        "        return np.where(self.complete == 0)[0]\n"
        "    def write_state(self, index, values):\n"
        "        for name in self.out:\n"
        "            self.out[name][index] = values[name]\n"
        "        self.complete[index] = 1\n"
        "db = P.Database(sys.argv[1])\n"
        "db.ingest_line_pack(synthetic_line_pack(num_lines=200, seed=21))\n"
        "attrs = lambda s: {'standard_name': s}\n"
        "atm = P.Dataset(data_vars={\n"
        "    'p': (['layer'], np.asarray([117.0, 1032.0, 11419.0]),\n"
        "          attrs('air_pressure')),\n"
        "    't': (['layer'], np.asarray([269.01, 227.74, 203.37]),\n"
        "          attrs('air_temperature')),\n"
        "    'q': (['layer'], np.asarray([5.2e-6, 4.8e-6, 3.0e-6]),\n"
        "          attrs('mole_fraction_of_water_vapor_in_air'))})\n"
        "grid = np.arange(1.0, 3000.0, 1.0)\n"
        "spec = P.Spectroscopy(atm, grid, db, device='cpu')\n"
        "mem = Memory(['H2O_absorption'], 3, (3, grid.size))\n"
        "spec._stream_blocks(mem, block_layers=2)\n"
        "full = spec.compute_absorption('all')['H2O_absorption'].data\n"
        "assert mem.complete.all()\n"
        "np.testing.assert_allclose(mem.out['H2O_absorption'], full,\n"
        "                           rtol=1e-12, atol=0)\n"
        "assert full[:, 0].max() > 0\n"
        "assert sys.modules['h5py'] is None\n"
        "print('streamed without h5py')\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "lines.db")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "streamed without h5py"
