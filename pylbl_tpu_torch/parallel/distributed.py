"""Multi-process runtime: process-group initialization and global meshes
(counterpart of pylbl_tpu/parallel/distributed.py).

One process per rank, as torchrun starts them::

    torchrun --nproc-per-node 4 -m pylbl_tpu_torch compute --mesh 2x2 ...

    import pylbl_tpu_torch.parallel.distributed as dist
    dist.initialize()                      # reads torchrun's environment
    mesh = dist.global_mesh(spec=4)        # (batch, spec) over all ranks
    ...make_multigas_sharded_pipeline(packs, grid, mesh)

Axis layout rule: the "spec" axis, which carries the line exchange, lies
within a host (ranks of one host are consecutive under torchrun, and
:func:`global_mesh` defaults spec to the ranks per host); "batch" spans
hosts.
"""
import logging
import os

import torch
import torch.distributed as dist

from .mesh import BATCH_AXIS, make_mesh

logger = logging.getLogger("pylbl_tpu_torch")


def local_world_size():
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else the world."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def check_nccl_devices():
    """Raises when NCCL would put two ranks of this host on one card (NCCL
    refuses ranks that share a GPU; ranks sharing a card need gloo)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world_size() > cards:
        raise RuntimeError(
            f"NCCL needs a card per rank: {local_world_size()} ranks on this "
            f"host, {cards} CUDA device(s); ranks that share a card need "
            "backend='gloo'")


def pick_backend():
    """"nccl" when each local rank has a card of its own, "gloo"
    otherwise."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if cards and local_world_size() <= cards else "gloo"


def initialize(init_method=None, world_size=None, rank=None,
               local_rank=None, backend=None):
    """Initializes the default process group for multi-process runs.

    With no argument it reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  Safe to call in a
    single-process run: with no cluster environment and no argument it is
    a no-op, so entry scripts can call it unconditionally.

    Args:
        init_method: e.g. ``"tcp://localhost:29500"`` (default: the env://
            rendezvous of MASTER_ADDR/MASTER_PORT).
        world_size / rank / local_rank: explicit ranks (default: the
            environment's).
        backend: "nccl", "gloo" or None for :func:`pick_backend`'s choice.
            NCCL asked for with more ranks on this host than cards raises.

    Returns:
        True if the process group was (or already is) initialized, False
        for the single-process no-op path.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and world_size is None \
            and not ("WORLD_SIZE" in env and "MASTER_ADDR" in env):
        return False
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    if local_rank is not None:
        os.environ["LOCAL_RANK"] = str(local_rank)
    backend = backend or pick_backend()
    if backend == "nccl":
        check_nccl_devices()
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    logger.info("process group: rank %d of %d, backend %s", rank,
                world_size, backend)
    return True


def global_mesh(batch=None, spec=None, device="cuda"):
    """Builds a (batch, spec) mesh over every rank of the default group.

    Rank order is host-major: each host's ranks lie contiguous along the
    trailing "spec" axis, so the ring crosses hosts at most twice per host.

    Args:
        batch / spec: axis sizes; they must multiply to the world size.
            Defaults: spec = ranks per host (so "spec" never leaves a host)
            and batch = the number of hosts.
        device: as parallel/mesh.py ``make_mesh``.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if batch is None and spec is None:
        spec = max(min(local_world_size(), n), 1)
        batch = n // spec
    return make_mesh(batch=batch, spec=spec, device=device)


def process_local_rows(num_rows, mesh=None):
    """The slice of a batch-sharded leading axis owned by this process.

    The JAX arithmetic per process: ``ceil(num_rows / procs)`` rows each,
    in order.  A process here is a batch row of ``mesh`` (its spec ranks
    share the rows); without a mesh, a rank of the default group (or the
    only process).
    """
    if mesh is not None:
        procs, pid = mesh.shape[BATCH_AXIS], mesh.batch_index
    elif dist.is_initialized():
        procs, pid = dist.get_world_size(), dist.get_rank()
    else:
        procs, pid = 1, 0
    per = -(-num_rows // procs)
    lo = min(pid * per, num_rows)
    return slice(lo, min(lo + per, num_rows))


def host_local_batch_array(values, mesh):
    """This rank's batch rows on its device, with their global row slice.

    Args:
        values: numpy array holding only this process's rows (the
            :func:`process_local_rows` slice of the global batch).
        mesh: mesh from :func:`global_mesh`.

    Returns:
        (tensor on ``mesh.device``, global row slice): the offset is the
        row count of the lower batch indices (gathered over "batch").
    """
    from . import collectives

    local = torch.as_tensor(values, device=mesh.device)
    counts = collectives.all_gather(
        torch.tensor([local.shape[0]], dtype=torch.int64,
                     device=mesh.device), mesh, BATCH_AXIS)
    counts = counts.cpu().tolist()
    lo = int(sum(counts[:mesh.batch_index]))
    return local, slice(lo, lo + local.shape[0])

