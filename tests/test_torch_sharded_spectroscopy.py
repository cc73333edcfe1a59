"""The port's sharded pipelines, ``Spectroscopy(mesh=...)``, the streamed
loop and ``compute --mesh`` on gloo ranks.

One group of four CPU ranks serves the module (a (2, 2) mesh: two batch
groups of two spec ranks); the command line runs on a group of two.
Results are held to the port's float64 host engine (the JAX tests'
anchor, tests/test_multigas.py) and to the port without a mesh, within
5e-4, and every rank must return the same bits.  Mirrors
tests/test_multigas.py:158, :196, :232, :253, :296, :333,
tests/test_streaming.py:39, tests/test_spectroscopy.py:101 and
tests/test_parallel.py:206.
"""
import numpy as np
import pytest
import torch

import pylbl_tpu_torch
from pylbl_tpu_torch.database import fixtures as tfix
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.parallel import launch
from pylbl_tpu_torch.parallel import mesh as tmesh
from pylbl_tpu_torch.parallel import shard_plans as sp
from pylbl_tpu_torch.parallel import sharded as sh
from pylbl_tpu_torch.utils.xrlite import open_dataset

torch.set_num_threads(1)

GRID = np.arange(1.0, 220.0, 0.2)
GRID_ARG = "1:220:0.2"
T = np.asarray([288.99, 227.74])
P = np.asarray([98388.0, 1032.0])
VMR = np.asarray([[6.637074e-03, 3.9e-04, 6.7e-08],
                  [4.2e-06, 3.9e-04, 7.8e-06]])
# The canonical 4-layer column (tests/conftest.py) for Spectroscopy.
COL_P = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
COL_T = np.asarray([269.01, 227.74, 203.37, 288.99])
COL_VMR = {"water_vapor": [5.244536e-06, 4.763972e-06, 3.039952e-06,
                           6.637074e-03],
           "carbon_dioxide": [0.00036, 0.00036, 0.00036, 0.00035999],
           "ozone": [2.936688e-06, 7.415223e-06, 2.609510e-07,
                     6.859128e-08]}
MODES = ["balanced", "halo", "ring"]
_MESHES = {}


def packs():
    return {"H2O": tfix.synthetic_line_pack(
                "H2O", num_lines=300, nu_min=0.6, nu_max=260.0, seed=21,
                band_centers=(150.0,)),
            "CO2": tfix.synthetic_line_pack(
                "CO2", num_lines=200, nu_min=0.6, nu_max=260.0, seed=22,
                band_centers=(60.0, 200.0)),
            "O3": tfix.synthetic_line_pack(
                "O3", num_lines=100, nu_min=0.6, nu_max=260.0, seed=23,
                band_centers=(100.0,))}


def column(layers=slice(None)):
    data = {"p": (["layer"], COL_P[layers],
                  {"standard_name": "air_pressure", "units": "Pa"}),
            "t": (["layer"], COL_T[layers],
                  {"standard_name": "air_temperature", "units": "K"})}
    for name, values in COL_VMR.items():
        data[name] = (["layer"], np.asarray(values)[layers], {
            "standard_name": f"mole_fraction_of_{name}_in_air",
            "units": "mol mol-1"})
    return pylbl_tpu_torch.Dataset(data_vars=data)


def rank_mesh(batch=2, spec=2):
    if (batch, spec) not in _MESHES:
        _MESHES[batch, spec] = tmesh.make_mesh(batch=batch, spec=spec,
                                               device="cpu")
    return _MESHES[batch, spec]


# -- rank tasks --------------------------------------------------------------

def task_multigas(mode, backend):
    """make_multigas_sharded_pipeline with the pedestal: the numpy result,
    this rank's device Slab and the gas total."""
    fn = sh.make_multigas_sharded_pipeline(packs(), GRID, rank_mesh(),
                                           mode=mode, remove_pedestal=True,
                                           backend=backend, tile=1024)
    slab = fn.device(T, P, VMR)
    return {"k": fn(T, P, VMR), "backend": fn.step.backend,
            "slab": (slab.data.numpy(), slab.rows, slab.points),
            "total": fn.total(T, P, VMR).numpy()}


def task_density(mode, backend):
    """The raw stacked step with weight_density=True: the full array."""
    mesh = rank_mesh()
    blocks, q_table, static, info, names = sp.shard_stacked_packs(
        packs(), GRID, 2, mode=mode)
    step = sh.make_lines_sharded_step(static, info, mesh, blocks=blocks,
                                      q_table=q_table,
                                      weight_density=True, backend=backend,
                                      tile=1024)
    return step.backend, step.gather(step(T, P, VMR)).numpy()


def task_single_gas(mode):
    fn = sh.make_sharded_pipeline(packs()["H2O"], GRID, rank_mesh(),
                                  mode=mode, remove_pedestal=True,
                                  weight_density=False, tile=1024)
    return fn(T, P, VMR[:, 0])


def task_spectroscopy(db_path, mode, output_format, device_mechanisms):
    spec = pylbl_tpu_torch.Spectroscopy(
        column(), GRID, Database(db_path), mesh=rank_mesh(),
        sharding_mode=mode, device_mechanisms=device_mechanisms)
    out = spec.compute_absorption(output_format=output_format)
    return {name: np.asarray(var.data) for name, var in
            out.data_vars.items() if name.endswith("absorption")}


def task_continua_only(db_path):
    """A column whose gases have no lines (an empty database): under a
    mesh the reduced format still takes each rank's rows and gathers
    them."""
    spec = pylbl_tpu_torch.Spectroscopy(
        column(slice(0, 3)), GRID, Database(db_path), mesh=rank_mesh(),
        device_mechanisms=True)
    return np.asarray(spec.compute_absorption("total")["absorption"].data)


def task_streamed(db_path, out_path):
    spec = pylbl_tpu_torch.Spectroscopy(column(slice(0, 3)), GRID,
                                        Database(db_path), mesh=rank_mesh())
    return str(spec.compute_absorption_streamed(out_path, block_layers=2))


def task_cli(args):
    from pylbl_tpu_torch.__main__ import main
    return main(args)


# -- parent side -------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    with launch.RankGroup(4, timeout=600) as ranks:
        yield ranks


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    db = Database(tmp / "lines.db")
    for pack in packs().values():
        db.ingest_line_pack(pack)
    column().to_netcdf(tmp / "atm.nc")
    return tmp


@pytest.fixture(scope="module")
def per_gas_f64():
    """[B, G, points] float64 cross sections of the port's host engine,
    with and without the pedestal."""
    from pylbl_tpu_torch.models.lines import Gas

    out = {}
    for ped in (False, True):
        rows = []
        for g, (name, pack) in enumerate(packs().items()):
            gas = Gas(pack, name, device="cpu", dtype=torch.float64,
                      backend="xla")
            rows.append(np.stack([np.asarray(gas.absorption_coefficient(
                T[i], P[i], VMR[i, g], GRID, remove_pedestal=ped))
                for i in range(T.size)]))
        out[ped] = np.stack(rows, axis=1)
    return out


def rel(got, want, floor=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), scale * floor)).max())


def same_on_every_rank(outs, key=None):
    first = outs[0] if key is None else outs[0][key]
    for out in outs[1:]:
        other = out if key is None else out[key]
        if isinstance(first, dict):
            assert all(np.array_equal(first[k], other[k]) for k in first)
        else:
            assert np.array_equal(first, other)
    return first


@pytest.mark.parametrize("backend", ["kernel", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_multigas_sharded_pipeline(group, per_gas_f64, mode, backend):
    """tests/test_multigas.py:196, :232, :333: gas stacking with line
    sharding, the pedestal removed once per batch group, equals the
    per-gas float64 engine (5e-4); the device Slab is the numpy result's
    block bit for bit; fn.total is the weighted gas sum (1e-4)."""
    from pylbl_tpu_torch.spectroscopy import number_density

    outs = group.run_all(task_multigas, mode, backend)
    got = same_on_every_rank(outs, "k")
    same_on_every_rank(outs, "total")
    assert outs[0]["backend"] == backend
    for g in range(3):
        assert rel(got[:, g], per_gas_f64[True][:, g]) < 5e-4
    flat = got.reshape(T.size, -1)
    for out in outs:
        data, rows, points = out["slab"]
        assert np.array_equal(data.astype(np.float64), flat[rows, points])
    want = np.einsum("bgn,bg->bn", got,
                     number_density(T[:, None], P[:, None], VMR))
    assert rel(outs[0]["total"], want) < 1e-4


@pytest.mark.parametrize("backend", ["kernel", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_stacked_sharded_step_density_weighting(group, per_gas_f64, mode,
                                                backend):
    """tests/test_multigas.py:296: weight_density on the stacked step
    weights every flat point by its own gas's density on every slab."""
    from pylbl_tpu_torch.spectroscopy import number_density

    outs = group.run_all(task_density, mode, backend)
    assert outs[0][0] == backend
    full = same_on_every_rank([o[1] for o in outs])
    n = GRID.size
    num_points = per_gas_f64[False].shape[2]
    got = full[:, :3 * num_points].reshape(T.size, 3, num_points)
    for g in range(3):
        want = per_gas_f64[False][:, g] \
            * number_density(T, P, VMR[:, g])[:, None]
        assert rel(got[:, g, :n], want[:, :n]) < 5e-4


def test_single_gas_sharded_pipeline_pedestal(group, per_gas_f64):
    """make_sharded_pipeline with the pedestal equals the float64 engine."""
    got = same_on_every_rank(group.run_all(task_single_gas, "halo"))
    assert rel(got, per_gas_f64[True][:, 0]) < 5e-4


def test_sharded_pipeline_pedestal_matches_oracle():
    """tests/test_parallel.py:206: against the compiled reference C, which
    needs the reference sources (absent here: skipped, as the JAX test)."""
    import oracle

    if not oracle.available():
        pytest.skip("oracle unavailable")


@pytest.mark.parametrize("mode", MODES)
def test_spectroscopy_with_mesh_matches_default(group, inputs, mode):
    """tests/test_multigas.py:158: Spectroscopy(mesh=...) (sharded lines,
    pedestal per batch group) equals the port without a mesh (5e-4), the
    same on every rank."""
    got = same_on_every_rank(group.run_all(
        task_spectroscopy, str(inputs / "lines.db"), mode, "gas", None))
    want = pylbl_tpu_torch.Spectroscopy(
        column(), GRID, Database(inputs / "lines.db"), device="cpu") \
        .compute_absorption(output_format="gas")
    for name in ("H2O_absorption", "CO2_absorption", "O3_absorption"):
        assert rel(got[name], want[name].data) < 5e-4, name


def test_reduced_formats_under_mesh(group, inputs):
    """tests/test_spectroscopy.py:101: with device mechanisms under a mesh
    each rank computes its batch rows' "total" and "gas" sums, gathered
    over "batch"; they match the host-summed "all" output (5e-4)."""
    host = pylbl_tpu_torch.Spectroscopy(
        column(), GRID, Database(inputs / "lines.db"), device="cpu",
        device_mechanisms=False).compute_absorption(output_format="all")
    gases = ("H2O", "CO2", "O3")
    want = {g: host[f"{g}_absorption"].data.sum(axis=-2) for g in gases}
    total = same_on_every_rank(group.run_all(
        task_spectroscopy, str(inputs / "lines.db"), "balanced", "total",
        True))
    assert total["absorption"].shape == (4, GRID.size)
    assert rel(total["absorption"], sum(want.values())) < 5e-4
    per_gas = same_on_every_rank(group.run_all(
        task_spectroscopy, str(inputs / "lines.db"), "ring", "gas", True))
    for g in gases:
        assert rel(per_gas[f"{g}_absorption"], want[g]) < 5e-4


def test_reduced_format_without_lines_under_mesh(group, tmp_path):
    """Gases with continua and no lines, 3 layers padded to the batch
    axis: every rank returns the unsharded port's total."""
    db_path = tmp_path / "empty.db"
    Database(db_path)
    got = same_on_every_rank(group.run_all(task_continua_only, str(db_path)))
    want = pylbl_tpu_torch.Spectroscopy(
        column(slice(0, 3)), GRID, Database(db_path), device="cpu",
        device_mechanisms=True).compute_absorption(
        "total")["absorption"].data
    assert got.shape == want.shape == (3, GRID.size)
    assert np.abs(want).max() > 0
    assert rel(got, want) < 1e-12


def test_streamed_with_mesh(group, inputs, tmp_path):
    """tests/test_streaming.py:39 and tests/test_multigas.py:253: the
    streamed loop under a mesh (3 layers padded to the batch axis, blocks
    of 2), rank 0 alone writing, matches the in-memory port."""
    out = tmp_path / "mesh.nc"
    paths = group.run_all(task_streamed, str(inputs / "lines.db"), str(out))
    assert set(paths) == {str(out)}
    back = open_dataset(out)
    full = pylbl_tpu_torch.Spectroscopy(
        column(slice(0, 3)), GRID, Database(inputs / "lines.db"),
        device="cpu").compute_absorption(output_format="all")
    for name in ("H2O_absorption", "CO2_absorption", "O3_absorption"):
        want = full[name].data
        scale = max(np.abs(want).max(), 1e-300)
        np.testing.assert_allclose(back[name].data, want, rtol=5e-4,
                                   atol=scale * 5e-4)


def test_cli_compute_mesh(inputs, tmp_path):
    """``compute --mesh 1x2`` on two gloo ranks writes the file of the
    port's command line without a mesh (5e-4)."""
    from pylbl_tpu_torch.__main__ import main

    def args(output, *extra):
        return ["--device", "cpu", "compute", "--atmosphere",
                str(inputs / "atm.nc"), "--database",
                str(inputs / "lines.db"), "--grid", GRID_ARG, "--output",
                str(output), "--format", "total", *extra]

    with launch.RankGroup(2, timeout=300) as pair:
        codes = pair.run_all(task_cli, args(tmp_path / "mesh.nc", "--mesh",
                                            "1x2", "--sharding-mode", "ring"))
    assert codes == [0, 0]
    assert main(args(tmp_path / "single.nc")) == 0
    got = open_dataset(tmp_path / "mesh.nc")["absorption"].data
    want = open_dataset(tmp_path / "single.nc")["absorption"].data
    assert got.shape == want.shape == (4, GRID.size)
    assert rel(got, want) < 5e-4
