"""The port's sharded steps on gloo ranks against the JAX package's.

One group of four CPU ranks (parallel/launch.py ``RankGroup``) serves the
module; each case runs a module-level function on every rank (the ranks
import this module, which therefore imports JAX only inside the tests).
Port meshes (1, 4) and (2, 2) are held against the JAX step on its
8-virtual-device (2, 4) mesh (the same spec, so the same plans: the batch
axis only splits rows) and against the port's float64 host engine.
Mirrors tests/test_parallel.py:20-80, :165-204, :234-298, :354 and
tests/test_distributed_mp.py:31.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu_torch.database import fixtures as tfix
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel import collectives, launch
from pylbl_tpu_torch.parallel import mesh as tmesh
from pylbl_tpu_torch.parallel import shard_plans as sp
from pylbl_tpu_torch.parallel import sharded as sh

torch.set_num_threads(1)

GRID = np.arange(1.0, 320.0, 0.5)
T = np.asarray([288.99, 269.01, 227.74, 203.37])
P = np.asarray([98388.0, 117.0, 1032.0, 11419.0])
X = np.asarray([6.637074e-03, 5.244536e-06, 4.763972e-06, 3.039952e-06])
MODES = ["halo", "ring", "balanced"]
_MESHES = {}


def port_pack():
    return tfix.synthetic_line_pack(num_lines=400, nu_min=0.6, nu_max=360.0,
                                    seed=31)


def rank_mesh(batch, spec):
    """This rank's (batch, spec) CPU mesh, built once per rank."""
    if (batch, spec) not in _MESHES:
        _MESHES[batch, spec] = tmesh.make_mesh(batch=batch, spec=spec,
                                               device="cpu")
    return _MESHES[batch, spec]


# -- rank tasks --------------------------------------------------------------

def task_runtime():
    """Mesh split rule, global mesh, rows and placements on one rank."""
    import torch.distributed as dist

    from pylbl_tpu_torch.parallel import distributed as tdist

    out = {"initialized": tdist.initialize()}
    mesh = tmesh.make_mesh(device="cpu")
    out["default_shape"] = dict(mesh.shape)
    out["coords"] = mesh.coords
    out["global_shape"] = dict(tdist.global_mesh(device="cpu").shape)
    out["rows"] = tdist.process_local_rows(10, mesh)
    local, rows = tdist.host_local_batch_array(
        np.arange(3 * (mesh.batch_index + 1), dtype=np.float32), mesh)
    out["host_rows"] = (rows, local.numpy())
    out["placements"] = [str(p) for p in (tmesh.replicated(mesh),
                                          tmesh.batch_sharded(mesh),
                                          tmesh.grid_sharded(mesh))]
    for call, exc in ((lambda: tmesh.make_mesh(batch=3, spec=1,
                                               device="cpu"), ValueError),
                      (lambda: tmesh.make_mesh(batch=2, spec=2,
                                               device="cuda"),
                       RuntimeError)):
        try:
            call()
            out.setdefault("raised", []).append(None)
        except exc as err:
            out.setdefault("raised", []).append(type(err).__name__)
    out["backend"] = (mesh.backend, mesh.transport, dist.get_world_size())
    return out


def task_sharded_step(batch, spec):
    """make_sharded_step (lines replicated): the full array."""
    from pylbl_tpu_torch.parallel.lines import device_line_pack

    mesh = rank_mesh(batch, spec)
    arrays, static = device_line_pack(port_pack(), GRID)
    step, info = sh.make_sharded_step(arrays, static, mesh)
    slab = step(T, P, X)
    return step.gather(slab).numpy(), info


def task_lines_step(batch, spec, mode, backend):
    """make_lines_sharded_step: the full array, the slab, a repeat's
    equality, the launches and the step's backend and info."""
    mesh = rank_mesh(batch, spec)
    blocks, q_table, static, info = sp.shard_line_pack(port_pack(), GRID,
                                                       spec, mode=mode)
    lc.reset_launches()
    step = sh.make_lines_sharded_step(static, info, mesh, blocks=blocks,
                                      q_table=q_table,
                                      backend=backend, tile=256)
    slab = step(T, P, X)
    again = step(T, P, X)
    return {"full": step.gather(slab).numpy(), "local": slab.data.numpy(),
            "rows": slab.rows, "points": slab.points,
            "repeat": bool(torch.equal(slab.data, again.data)),
            "launches": dict(lc.LAUNCHES), "backend": step.backend,
            "info": info}


def task_reduce_scatter(batch, spec, seed):
    """The reduce-scatter against the explicit rank-order sum of every
    rank's input."""
    mesh = rank_mesh(batch, spec)
    rng = np.random.default_rng(seed + mesh.rank)
    x = torch.as_tensor(rng.standard_normal((2, 8 * spec)),
                        dtype=torch.float32)
    got = collectives.reduce_scatter(x, mesh)
    parts = collectives.all_gather(x[None], mesh, tmesh.SPEC_AXIS)
    s = mesh.spec_index
    want = parts[0, :, 8 * s:8 * (s + 1)]
    for j in range(1, spec):
        want = want + parts[j, :, 8 * s:8 * (s + 1)]
    return bool(torch.equal(got, want))


def task_two_process_rows():
    """tests/test_distributed_mp.py:31 on two ranks: rows over "batch",
    each rank loading only its own rows."""
    from pylbl_tpu_torch.parallel import distributed as tdist

    mesh = tdist.global_mesh(batch=2, spec=1, device="cpu")
    rows = tdist.process_local_rows(2, mesh)
    local, global_rows = tdist.host_local_batch_array(T[:2][rows], mesh)
    blocks, q_table, static, info = sp.shard_line_pack(port_pack(), GRID, 1,
                                                       mode="halo")
    step = sh.make_lines_sharded_step(static, info, mesh, blocks=blocks,
                                      q_table=q_table,
                                      backend="kernel", tile=256)
    slab = step(T[:2], P[:2], X[:2])
    assert slab.rows == global_rows == rows
    assert np.array_equal(local.numpy(), T[:2][rows])
    return slab.rows, slab.data.numpy()


# -- parent side -------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    with launch.RankGroup(4, timeout=600) as ranks:
        yield ranks


@pytest.fixture(scope="module")
def f64():
    """The port's float64 host engine, density-weighted [4, points]."""
    from pylbl_tpu_torch.models.lines import Gas
    from pylbl_tpu_torch.spectroscopy import number_density

    gas = Gas(port_pack(), "H2O", device="cpu", dtype=torch.float64,
              backend="xla")
    out = []
    for i in range(T.size):
        k = gas.absorption_coefficient(T[i], P[i], X[i], GRID)
        out.append(number_density(T[i], P[i], X[i]) * np.asarray(k))
    return np.stack(out)


def rel(got, want, floor):
    scale = max(np.abs(want).max(), 1e-300)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), scale * floor)).max())


def jax_lines_step(mode, backend):
    """The JAX step on its (2, 4) mesh: [4, padded_points]."""
    import jax
    import jax.numpy as jnp

    from pylbl_tpu.database.fixtures import synthetic_line_pack
    from pylbl_tpu.parallel import (make_lines_sharded_step, make_mesh,
                                    shard_line_pack)

    pack = synthetic_line_pack(num_lines=400, nu_min=0.6, nu_max=360.0,
                               seed=31)
    blocks, q_table, static, info = shard_line_pack(pack, GRID, 4, mode=mode)
    step = make_lines_sharded_step(static, info, make_mesh(batch=2, spec=4),
                                   blocks=blocks, backend=backend, tile=256,
                                   interpret=True)
    call = blocks if step.call_blocks is None else step.call_blocks
    return np.asarray(step(jax.tree.map(jnp.asarray, call),
                           jnp.asarray(q_table), T.astype(np.float32),
                           P.astype(np.float32), X.astype(np.float32)))


def check_against(outs, f64_want, n):
    """Every rank holds the same bits, within 5e-4 of float64."""
    for out in outs[1:]:
        assert np.array_equal(out["full"], outs[0]["full"])
    assert rel(outs[0]["full"][:, :n], f64_want, 1e-6) < 5e-4


def test_mesh_and_runtime(group):
    """tests/test_parallel.py:20, :234, :246 on four ranks."""
    outs = group.run_all(task_runtime)
    for rank, out in enumerate(outs):
        assert out["initialized"] is True
        assert out["default_shape"] == {"batch": 2, "spec": 2}
        assert out["coords"] == divmod(rank, 2)
        # spec = ranks per host: the ring stays on one host.
        assert out["global_shape"] == {"batch": 1, "spec": 4}
        assert out["rows"] == (slice(0, 5) if rank < 2 else slice(5, 10))
        rows, local = out["host_rows"]
        assert rows == (slice(0, 3) if rank < 2 else slice(3, 9))
        assert local.size == rows.stop - rows.start
        assert out["placements"] == [
            "(Replicate(), Replicate())", "(Shard(dim=0), Replicate())",
            "(Shard(dim=0), Shard(dim=1))"]
        # No CUDA fallback: a CUDA mesh without a card raises.
        assert out["raised"] == ["ValueError", "RuntimeError"]
        assert out["backend"] == ("gloo", "host", 4)


def test_sharded_step_matches_jax_and_host(group, f64):
    """tests/test_parallel.py:26-80: make_sharded_step on three meshes,
    one held to the JAX step (rel 5e-6), all to float64 (5e-4), and the
    meshes to each other (batch padding invariance)."""
    import jax

    from pylbl_tpu.database.fixtures import synthetic_line_pack
    from pylbl_tpu.parallel import device_line_pack, make_mesh, \
        make_sharded_step

    n = f64.shape[1]
    fulls = []
    for batch, spec in [(1, 4), (2, 2), (4, 1)]:
        outs = group.run_all(task_sharded_step, batch, spec)
        for full, _ in outs[1:]:
            assert np.array_equal(full, outs[0][0])
        full, info = outs[0]
        assert full.shape == (4, info["padded_points"])
        assert rel(full[:, :n], f64, 1e-6) < 5e-4
        fulls.append(full[:, :n])
    for other in fulls[1:]:
        np.testing.assert_allclose(other, fulls[0], rtol=1e-6,
                                   atol=float(np.abs(fulls[0]).max()) * 1e-7)
    arrays, static = device_line_pack(
        synthetic_line_pack(num_lines=400, nu_min=0.6, nu_max=360.0,
                            seed=31), GRID)
    step, _ = make_sharded_step(arrays, static, make_mesh(batch=2, spec=4))
    want = np.asarray(step(jax.tree.map(np.asarray, arrays),
                           T.astype(np.float32), P.astype(np.float32),
                           X.astype(np.float32)))[:, :n]
    assert rel(fulls[0], want, 1e-7) < 5e-6


@pytest.mark.parametrize("mode", MODES)
def test_lines_sharded_step_portable(group, f64, mode):
    """tests/test_parallel.py:165-204: the portable branch on (1, 4) equals
    the JAX XLA step (rel 5e-6) and (2, 2) float64 (5e-4), with the
    partition's stats."""
    n = f64.shape[1]
    outs = group.run_all(task_lines_step, 1, 4, mode, "xla")
    info = outs[0]["info"]
    assert outs[0]["backend"] == "xla" and info["mode"] == mode
    if mode == "ring":
        assert info["duplication"] == 1.0 and info["ring_steps"] >= 1
    if mode == "balanced":
        assert info["duplication"] == 1.0
        assert info["block_len"] <= -(-400 // 4) + 1
    check_against(outs, f64, n)
    assert rel(outs[0]["full"], jax_lines_step(mode, "xla"), 1e-7) < 5e-6
    check_against(group.run_all(task_lines_step, 2, 2, mode, "xla"), f64, n)


@pytest.mark.parametrize("mode", MODES)
def test_lines_sharded_step_kernel(group, f64, mode):
    """tests/test_parallel.py:255-296: the kernel branch (the strided wings
    and mixed-slot core on each shard's plan, their plain versions on these
    CPU tensors) equals the JAX Pallas step in interpret mode at tile 256
    (rel 5e-6) and float64 (5e-4), launches no CUDA kernel, and repeats
    bit for bit on every rank."""
    n = f64.shape[1]
    outs = group.run_all(task_lines_step, 1, 4, mode, "kernel")
    for out in outs:
        assert out["backend"] == "kernel" and out["repeat"]
        assert not any(out["launches"].values())
        assert np.array_equal(out["local"],
                              out["full"][out["rows"], out["points"]])
    check_against(outs, f64, n)
    assert rel(outs[0]["full"], jax_lines_step(mode, "pallas"), 1e-7) < 5e-6
    check_against(group.run_all(task_lines_step, 2, 2, mode, "kernel"), f64,
                  n)


def test_plain_backend_equals_kernel_wrappers_on_cpu(group):
    """backend="plain" runs the same plain versions the wrappers run on CPU
    tensors: the same bits."""
    a = group.run(task_lines_step, 2, 2, "balanced", "kernel")
    b = group.run(task_lines_step, 2, 2, "balanced", "plain")
    assert b["backend"] == "plain"
    assert np.array_equal(a["full"], b["full"])


@pytest.mark.parametrize("batch,spec", [(1, 4), (2, 2)])
def test_reduce_scatter_is_a_rank_order_sum(group, batch, spec):
    assert all(group.run_all(task_reduce_scatter, batch, spec, 7))


def test_two_process_rows(f64):
    """tests/test_distributed_mp.py:31 (slow in JAX, a normal test here):
    two processes, rows split over "batch"; each rank's row sums equal the
    unsharded float32 engine's at rtol 2e-6 and its points float64 at
    5e-4."""
    from pylbl_tpu_torch.parallel.lines import make_batched_fn
    from pylbl_tpu_torch.spectroscopy import number_density

    with launch.RankGroup(2, timeout=300) as pair:
        results = pair.run_all(task_two_process_rows)
    fn = make_batched_fn(port_pack(), GRID, tile=256, device="cpu")
    n = f64.shape[1]
    f32 = fn(T[:2], P[:2], X[:2]).numpy().astype(np.float64)[:, :n] \
        * number_density(T[:2], P[:2], X[:2])[:, None]
    assert [rows for rows, _ in results] == [slice(0, 1), slice(1, 2)]
    for rows, local in results:
        np.testing.assert_allclose(local[:, :n].sum(axis=1),
                                   f32[rows].sum(axis=1), rtol=2e-6)
        assert rel(local[:, :n], f64[rows], 1e-6) < 5e-4
