"""The sharded pipelines' collectives, one place for all of them.

Counterparts of the ``lax`` collectives of pylbl_tpu/parallel/lines.py
over the rank mesh (parallel/mesh.py):

- :func:`reduce_scatter` for ``lax.psum_scatter(k, "spec",
  scatter_dimension=1, tiled=True)`` (balanced mode): an
  ``all_to_all_single`` of the spec slabs, then the received slabs added
  in rank order.  The summation order is fixed, so repeats are
  bit-identical and gloo and NCCL give the same bits (no float atomics);
- :func:`ring_shift` for ``lax.ppermute`` one step up or down the spec
  ring (ring mode): ``batch_isend_irecv`` of the block;
- :func:`all_gather` for materializing a sharded array (``np.asarray`` of
  a sharded ``jax.Array``), :func:`broadcast` for the per-batch-group
  pedestal result and the streamed loop's pending states.

Transport is explicit: under NCCL (``mesh.transport == "device"``) the
card's tensors move as they are; under gloo (``"host"``) a CUDA tensor is
copied to the host and back inside the collective, and the copied bytes
are counted in ``BYTES["host_staged"]`` (``make_mesh`` logs the
transport).  Nothing falls back silently.  ``BYTES`` counts what each collective sent
from this rank since :func:`reset_bytes`.
"""
import numpy as np
import torch
import torch.distributed as dist

from .mesh import SPEC_AXIS

BYTES = {"reduce_scatter": 0, "ring": 0, "gather": 0, "broadcast": 0,
         "host_staged": 0}


def reset_bytes():
    for key in BYTES:
        BYTES[key] = 0


def _nbytes(t):
    return t.numel() * t.element_size()


def _stage(t, mesh):
    """The tensor the transport moves: a host copy of a CUDA tensor under
    gloo (counted), the tensor itself otherwise."""
    if mesh.transport == "host" and t.is_cuda:
        BYTES["host_staged"] += _nbytes(t)
        return t.cpu()
    return t


def _unstage(t, like, mesh):
    if t.device != like.device:
        BYTES["host_staged"] += _nbytes(t)
        return t.to(like.device)
    return t


def reduce_scatter(x, mesh, axis=SPEC_AXIS):
    """Sums ``x`` [B, S * L] over the ranks of ``axis`` and returns this
    rank's tile [B, L] (``lax.psum_scatter(..., tiled=True)``).

    Each rank receives every rank's copy of its tile (``all_to_all_single``)
    and adds them in rank order, ((k_0 + k_1) + k_2) + ..., on its own
    device: a fixed order, the same on every transport.
    """
    size = mesh.shape[axis]
    if size == 1:
        return x
    batch, width = x.shape
    tile = width // size
    send = _stage(x.reshape(batch, size, tile).transpose(0, 1).contiguous(),
                  mesh)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    BYTES["reduce_scatter"] += _nbytes(send) * (size - 1) // size
    recv = _unstage(recv, x, mesh)
    out = recv[0]
    for j in range(1, size):
        out = out + recv[j]
    return out


def ring_shift(tensor, mesh, step, axis=SPEC_AXIS):
    """``lax.ppermute`` one place along the ``axis`` ring: step +1 sends to
    the next rank and receives from the previous one (perm (i, i+1)), step
    -1 the mirror.  Returns the received tensor."""
    size = mesh.shape[axis]
    if size == 1:
        return tensor
    ranks = mesh.axis_ranks(axis)
    me = ranks.index(mesh.rank)
    send = _stage(tensor.contiguous(), mesh)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(me + step) % size]),
           dist.P2POp(dist.irecv, recv, ranks[(me - step) % size])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    BYTES["ring"] += _nbytes(send)
    return _unstage(recv, tensor, mesh)


def all_gather(tensor, mesh, axis=None):
    """Every rank's ``tensor`` along ``axis`` ("batch", "spec", or the whole
    mesh for None), concatenated on dim 0 in rank order, on the tensor's
    device."""
    group = mesh.group(axis)
    size = dist.get_world_size(group)
    if size == 1:
        return tensor
    send = _stage(tensor.contiguous(), mesh)
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=group)
    BYTES["gather"] += _nbytes(send) * (size - 1)
    return _unstage(torch.cat(parts, dim=0), tensor, mesh)


def broadcast(tensor, mesh, axis=None, src_index=0):
    """``tensor`` of the rank at index ``src_index`` along ``axis`` (or of
    global rank ``src_index`` for the whole mesh), on every rank of that
    row; the other ranks pass a tensor of the same shape and dtype."""
    group = mesh.group(axis)
    if dist.get_world_size(group) == 1:
        return tensor
    src = mesh.axis_ranks(axis)[src_index] if axis is not None else src_index
    buf = _stage(tensor.contiguous(), mesh)
    dist.broadcast(buf, src, group=group)
    if mesh.rank == src:
        BYTES["broadcast"] += _nbytes(buf)
    return _unstage(buf, tensor, mesh)


def broadcast_array(values, mesh):
    """A 1-D int64 numpy array of global rank 0, on every rank."""
    device = mesh.device if mesh.transport == "device" else "cpu"
    size = torch.tensor([0 if values is None else len(values)],
                        dtype=torch.int64, device=device)
    size = broadcast(size, mesh)
    buf = torch.as_tensor(np.asarray(values, np.int64), device=device) \
        if mesh.rank == 0 else torch.empty(int(size), dtype=torch.int64,
                                           device=device)
    return broadcast(buf, mesh).cpu().numpy()


def barrier(mesh):
    dist.barrier(group=mesh.group())
