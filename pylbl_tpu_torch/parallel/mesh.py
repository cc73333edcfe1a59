"""The (batch, spec) rank mesh of the sharded pipelines (counterpart of
pylbl_tpu/parallel/mesh.py).

The problem decomposes on two axes:

- "batch": layers/columns, pure data parallelism;
- "spec": the wavenumber grid, a domain decomposition.  Each spec rank
  owns a contiguous slab of grid points; a line reaches a slab iff its
  integer-aligned +/-cutoff window intersects it (reference
  spectra.c:48-62), so the halo is fixed at cutoff+1 wavenumbers of line
  inputs, not output points.

The JAX package runs one controller over a device ``Mesh``.  The port
runs one process per rank in the default ``torch.distributed`` group
(parallel/distributed.py ``initialize``, or parallel/launch.py): every
rank calls the same entry point with the same host inputs and computes
the block its (batch, spec) coordinate owns.  :class:`Mesh` carries the
``DeviceMesh`` of those ranks, the rank's compute device and the
collectives' transport (parallel/collectives.py).
"""
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.device import resolve_device

BATCH_AXIS = "batch"
SPEC_AXIS = "spec"

logger = logging.getLogger("pylbl_tpu_torch")


def _placements():
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:     # torch before 2.4
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


class Mesh:
    """A (batch, spec) mesh over the ranks of the default process group.

    Rank r sits at (r // spec, r % spec): spec neighbours are consecutive
    ranks, so under a host-major launch (torchrun) the spec axis, which
    carries the halo/ring/reduce-scatter traffic, stays within a host.

    Attributes:
        device_mesh: the ``DeviceMesh`` with ``mesh_dim_names = ("batch",
            "spec")`` (device type "cuda" under NCCL, "cpu" under gloo: the
            transport's device).
        shape: {"batch": B, "spec": S}, as the JAX ``Mesh.shape``.
        device: this rank's compute device: ``cuda:{local_rank %
            device_count}``, or the CPU when asked for.
        backend: the process group's backend, "nccl" or "gloo".
        transport: "device" (NCCL moves the card's tensors) or "host"
            (gloo: a CUDA tensor is copied to the host and back inside
            each collective, counted in collectives.BYTES["host_staged"]).
        rank, world: this rank and the group size.
        coords: (batch index, spec index) of this rank.
    """

    def __init__(self, batch, spec, device):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.shape = {BATCH_AXIS: batch, SPEC_AXIS: spec}
        self.coords = divmod(self.rank, spec)
        self.device = device
        self.backend = str(dist.get_backend()).lower()
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL mesh computes on the card; pass a "
                             "CUDA device")
        self.transport = "device" if self.backend == "nccl" else "host"
        self.device_mesh = _device_mesh(
            "cuda" if self.backend == "nccl" else "cpu", batch, spec)
        self.ranks = np.arange(self.world).reshape(batch, spec)

    @property
    def batch_index(self):
        return self.coords[0]

    @property
    def spec_index(self):
        return self.coords[1]

    def group(self, axis=None):
        """The process group of this rank's row along ``axis`` ("batch" or
        "spec"), or the whole mesh for None."""
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def axis_ranks(self, axis):
        """Global ranks of this rank's row along ``axis``, in axis order."""
        b, s = self.coords
        row = self.ranks[:, s] if axis == BATCH_AXIS else self.ranks[b]
        return [int(r) for r in row]

    def __repr__(self):
        return (f"Mesh(batch={self.shape[BATCH_AXIS]}, "
                f"spec={self.shape[SPEC_AXIS]}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def _device_mesh(device_type, batch, spec):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (batch, spec),
                            mesh_dim_names=(BATCH_AXIS, SPEC_AXIS))


def rank_device(device="cuda"):
    """This rank's compute device: ``cuda:{local_rank % device_count}`` for
    a CUDA request (raising without a card), the given device otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(device)


def make_mesh(batch=None, spec=None, device="cuda"):
    """Builds a (batch, spec) mesh over the ranks of the default group.

    The split rule is the JAX ``make_mesh``'s: unspecified, it favours the
    spectral axis while keeping batch >= 2 when possible.  Every rank of
    the group must call it (the mesh's subgroups are created
    collectively).

    Args:
        batch / spec: axis sizes; they must multiply to the world size.
        device: the compute device; "cuda" (default) is this rank's card
            (:func:`rank_device`), raising without one; "cpu" runs the
            plain versions on the host.

    Raises:
        RuntimeError: without an initialized process group (no group is
            invented: call parallel/distributed.py ``initialize`` or run
            under parallel/launch.py or torchrun).
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (parallel.distributed.initialize, "
                           "torchrun or parallel.launch)")
    device = rank_device(device)
    n = dist.get_world_size()
    if batch is None and spec is None:
        batch = 2 if n % 2 == 0 and n > 2 else 1
        spec = n // batch
    elif batch is None:
        batch = n // spec
    elif spec is None:
        spec = n // batch
    if batch * spec != n:
        raise ValueError(f"mesh {batch}x{spec} does not cover {n} ranks")
    if str(dist.get_backend()).lower() == "nccl" and device.type == "cuda":
        from .distributed import check_nccl_devices
        check_nccl_devices()
    mesh = Mesh(batch, spec, device)
    logger.info("mesh %dx%d on rank %d: device %s, backend %s (transport "
                "%s)", batch, spec, mesh.rank, device, mesh.backend,
                mesh.transport)
    return mesh


def replicated(mesh):
    """Placements of an array replicated over the mesh (JAX ``P()``)."""
    replicate, _ = _placements()
    return (replicate(), replicate())


def batch_sharded(mesh):
    """Placements of an array whose leading axis is split over "batch"
    (JAX ``P("batch")``)."""
    replicate, shard = _placements()
    return (shard(0), replicate())


def grid_sharded(mesh):
    """Placements of a [batch, points] array split over both axes (JAX
    ``P("batch", "spec")``)."""
    _, shard = _placements()
    return (shard(0), shard(1))
