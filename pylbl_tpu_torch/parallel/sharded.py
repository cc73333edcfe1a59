"""Line-sharded multi-rank pipelines (counterpart of the multi-device part
of pylbl_tpu/parallel/lines.py: ``make_lines_sharded_step`` and its
kernel variants, ``make_sharded_pipeline``,
``make_multigas_sharded_pipeline`` and ``make_sharded_step``).

SPMD over ``torch.distributed``: every rank of the mesh (parallel/mesh.py)
calls the same entry point with the same host inputs (global [B] layer
arrays, as a JAX caller passes numpy arrays) and computes the block its
(batch, spec) coordinate owns: the layer rows of its batch index, on the
grid slab (halo, ring) or the line block (balanced) of its spec index.

- A step returns the rank's :class:`Slab` ([B / batch, local_n] on the
  rank's device, with its global row and point slices); ``step.gather``
  assembles the full [B, padded_points] array on every rank.
- The kernel branch (``step.backend == "kernel"``, or "plain" for the
  plain versions) runs the strided prepacked wings (``wings_strided``)
  and the mixed-slot core (``core_segmix``) of ops/lineshape_cuda.py on
  the shard's own plan (parallel/shard_plans.py): once per call in halo
  and balanced mode, once per ring stop in ring mode.  Where no stride
  fits the windows (0.01 cm-1) it takes the portable branch, as the JAX
  step does, and ``step.backend`` says "xla".
- The portable branch runs ops/lineshape.py ``accumulate_segment``.

Collectives (parallel/collectives.py): the balanced reduce-scatter (fixed
rank-order sum), the ring's block shifts up and down the spec ring, the
gathers that materialize results and the broadcast of each batch group's
pedestal result.
"""
from collections import namedtuple

import numpy as np
import torch

from ..ops import lineshape_cuda as lc
from ..ops.lineshape import accumulate_segment, core_halfwidth
from ..runtime.device import resolve_backend, resolve_dtype
from ..utils import constants as c
from . import collectives
from .lines import (_LineStage, _layer_tensor, _pad_to_chunk, as_tensors,
                    line_kernel_arrays, make_stacked_pedestal_remover,
                    shift_origin, wings_soa)
from .mesh import BATCH_AXIS, SPEC_AXIS
from .shard_plans import (ring_plan_list, ring_schedule, shard_line_pack,
                          shard_plan_list, shard_stacked_packs)


class Slab(namedtuple("Slab", ["data", "rows", "points"])):
    """A rank's block of a sharded [B, points] (or [B, G, N]) array: the
    tensor on the rank's device, its global row slice and point slice
    (the counterpart of one device's shard of a sharded ``jax.Array``)."""


def row_slice(num_rows, mesh):
    """This rank's rows of a [num_rows] batch split over "batch"."""
    batch = mesh.shape[BATCH_AXIS]
    if num_rows % batch:
        raise ValueError(f"{num_rows} layers do not split over the mesh's "
                         f"batch axis of {batch}; pad the batch")
    per = num_rows // batch
    return slice(mesh.batch_index * per, (mesh.batch_index + 1) * per)


def _local_layers(temperature, pressure, vmr, mesh, dtype):
    """(row slice, this rank's t, p [Bl] and vmr [Bl] or [Bl, G] tensors)
    from the global host arrays."""
    t64 = np.atleast_1d(np.asarray(temperature, np.float64))
    rows = row_slice(t64.size, mesh)
    p64 = np.atleast_1d(np.asarray(pressure, np.float64))
    x64 = np.asarray(vmr, np.float64)
    x64 = np.atleast_1d(x64) if x64.ndim <= 1 else x64
    return rows, tuple(_layer_tensor(a[rows], mesh.device, dtype)
                       for a in (t64, p64, x64))


def _weight(k, t, p, x, static, origin, local_n, stacked):
    """Density weighting of a [Bl, local_n] slab whose first point is
    ``origin``: per layer, or per flat point by its own gas's density on
    the stacked grid."""
    if stacked:
        n_density = p[:, None] * x / (c.KB * t[:, None])
        pts = origin + torch.arange(local_n, device=k.device)
        gas_pt = torch.clamp(pts // static["num_points"], max=x.shape[1] - 1)
        return k * n_density[:, gas_pt]
    return k * (p * x / (c.KB * t))[:, None]


def _gather_grid(slab, mesh):
    """Every rank's [Bl, L] slab -> the full [B, spec * L] array."""
    data = slab.data
    parts = collectives.all_gather(data, mesh)
    batch, spec = mesh.shape[BATCH_AXIS], mesh.shape[SPEC_AXIS]
    rows, width = data.shape
    return parts.reshape(batch, spec, rows, width).permute(0, 2, 1, 3) \
        .reshape(batch * rows, spec * width)


def _gather_points(data, mesh):
    """The spec group's [Bl, L] slabs -> [Bl, spec * L]."""
    parts = collectives.all_gather(data, mesh, SPEC_AXIS)
    spec = mesh.shape[SPEC_AXIS]
    rows, width = data.shape
    return parts.reshape(spec, rows, width).permute(1, 0, 2) \
        .reshape(rows, spec * width)


class _Step:
    """A sharded step: ``step(t, p, x)`` -> this rank's :class:`Slab`."""

    def __init__(self, run, mesh, info, backend, local_n):
        self._run = run
        self.mesh = mesh
        self.info = info
        self.backend = backend
        self.local_n = local_n

    def __call__(self, temperature, pressure, vmr):
        return self._run(temperature, pressure, vmr)

    def gather(self, slab):
        """The full [B, padded_points] array on every rank."""
        return _gather_grid(slab, self.mesh)


class _BlockCarrier:
    """A block's constants as two tensors (floats in the pipeline dtype,
    int32 fields), the unit the ring shifts; ``fields()`` unpacks them."""

    def __init__(self, block, device, dtype):
        self.names_f = [k for k, v in block.items()
                        if np.issubdtype(v.dtype, np.floating)]
        self.names_i = [k for k in block if k not in self.names_f]
        self.floats = torch.as_tensor(np.stack([block[k] for k in
                                                self.names_f]),
                                      device=device).to(dtype)
        self.ints = torch.as_tensor(np.stack([block[k] for k in
                                              self.names_i]), device=device)

    def shifted(self, mesh, step):
        out = object.__new__(_BlockCarrier)
        out.names_f, out.names_i = self.names_f, self.names_i
        out.floats = collectives.ring_shift(self.floats, mesh, step)
        out.ints = collectives.ring_shift(self.ints, mesh, step)
        return out

    def fields(self):
        out = dict(zip(self.names_f, self.floats))
        out.update(zip(self.names_i, self.ints))
        return out


class _RingStop:
    """One ring stop of this rank's slab: the resident gather plan of the
    arriving block (``wsel``/``isel`` indices, dead masks, the wings and
    core CSRs and the core's per-instance rows) and the two kernel passes
    (``_make_pallas_ring_step`` of the JAX package, one loop iteration)."""

    def __init__(self, entry, static, n_out, tile, stride, tail, device,
                 plain):
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        # An all-dead pair has no core instance: one chunk of dead lanes
        # keeps the core pass's shapes whole (the JAX plans pad to 128).
        size = max(entry["isel"].size, lc.ROWS_CHUNK)
        pad = size - entry["isel"].size
        self.wsel = dev(entry["wsel"].astype(np.int64))
        self.wdead = dev(entry["wdead"])
        self.isel = dev(np.concatenate([entry["isel"].astype(np.int64),
                                        np.zeros(pad, np.int64)]))
        self.idead = dev(np.concatenate([entry["idead"],
                                         np.ones(pad, bool)]))
        self.seg0f = dev(np.concatenate([entry["seg0f"],
                                         np.zeros(pad, np.float32)]))
        self.slotf = dev(np.concatenate([entry["slotf"],
                                         np.zeros(pad, np.float32)]))
        self.w_csr = [dev(entry["w_start"]), dev(entry["w_n"])]
        tail_csr = [entry.get("tw_start"), entry.get("tw_n")]
        self.tail_csr = [None if a is None else dev(a) for a in tail_csr]
        self.wings_pieces = lc.TilePieces.of_csr(entry["w_n"],
                                                 entry.get("tw_n"))
        self.t_start = dev(entry["t_start"])
        self.t_chunks = dev(entry["t_chunks"])
        self.core_pieces = lc.TilePieces.of_core(entry["t_chunks"])
        self.static = static
        self.n_out = n_out
        self.tile = tile
        self.stride = stride
        self.tail = tail or 128
        self.plain = plain

    def assemble(self, block, q_table, t, p, x, origin):
        """The stop's kernel inputs from the arriving ``block`` (name -> [L]
        tensors): (wings SoA [Bl, 8, M], core params [Bl, 8, I])."""
        wl = {k: v.index_select(0, self.wsel) for k, v in block.items()}
        il = {k: v.index_select(0, self.isel) for k, v in block.items()}
        # Dead slots get zero strength, so they contribute exactly 0.
        for key in ("sw", "sw_pre"):
            wl[key] = torch.where(self.wdead, torch.zeros_like(wl[key]),
                                  wl[key])
            il[key] = torch.where(self.idead, torch.zeros_like(il[key]),
                                  il[key])
        wl["q_table"] = il["q_table"] = q_table
        ka = shift_origin(line_kernel_arrays(wl, self.static, t, p, x),
                          origin)
        soa = wings_soa(ka, True, ka["c_frac"].dtype)
        ka_i = shift_origin(line_kernel_arrays(il, self.static, t, p, x),
                            origin)
        return soa, lc.segment_params(ka_i, self.seg0f, self.slotf,
                                      self.idead).contiguous()

    def wings_pass(self, soa, plain=None):
        args = (self.n_out, self.tile, self.stride, lc.STRIDED_CHUNK,
                *self.tail_csr)
        if self.plain if plain is None else plain:
            return lc.wings_strided_plain(soa, *self.w_csr, *args,
                                          tail=self.tail)
        return lc.wings_strided_pass(soa, *self.w_csr, *args, tail=self.tail,
                                     pieces=self.wings_pieces)

    def core_pass(self, core, plain=None):
        if self.plain if plain is None else plain:
            return lc.core_segmix_plain(core, self.t_start, self.t_chunks,
                                        self.n_out, self.tile,
                                        piece=self.core_pieces.piece)
        return lc.core_segmix_pass(core, self.t_start, self.t_chunks,
                                   self.n_out, self.tile,
                                   pieces=self.core_pieces)


def _kernel_step(blocks, q_table, static, info, mesh, weight_density, tile,
                 t_max, p_max_atm, dtype, plain):
    """The kernel branch (``_make_pallas_sharded_step`` and
    ``_make_pallas_ring_step`` of the JAX package) for this rank's shard,
    or None when no stride fits."""
    s = mesh.spec_index
    local_n = info["local_points"]
    stacked = "flat_points" in info
    ring = info.get("mode") == "ring"
    device = mesh.device
    maker = ring_plan_list if ring else shard_plan_list
    built = maker(blocks, static, info, tile, t_max, p_max_atm, shards=[s])
    if built is None:
        return None
    per, meta = built
    q_dev = torch.as_tensor(q_table, device=device).to(dtype)
    n_out = meta["n_out"]
    # Kernel coordinates: from the slab origin, or from 0 in balanced mode
    # (every rank accumulates the full grid; the reduce-scatter lands its
    # slab).  Density weighting always uses the slab origin.
    balanced = meta.get("balanced", False)
    origin = 0 if balanced else s * local_n
    if ring:
        stops = [_RingStop(step[0][0], static, n_out, tile, meta["stride"],
                           meta["tail"], device, plain) for step in per]
        own = _BlockCarrier({k: v[s] for k, v in blocks.items()}, device,
                            dtype)

        def compute(t, p, x):
            k = torch.zeros((t.shape[0], n_out), dtype=dtype, device=device)
            cur_up = cur_dn = own
            for (kind, r), stop in zip(meta["schedule"], stops):
                if kind == "up" and r >= 1:
                    cur_up = cur_up.shifted(mesh, +1)
                elif kind == "dn":
                    cur_dn = cur_dn.shifted(mesh, -1)
                cur = cur_dn if kind == "dn" else cur_up
                soa, core = stop.assemble(cur.fields(), q_dev, t, p, x,
                                          origin)
                k = k + stop.wings_pass(soa)
                k = k + stop.core_pass(core)
            return k
    else:
        (plan, lay, cp), = per
        lines = dict(plan["lines"], q_table=q_table)
        stage = _LineStage(lines, static, None, None, None, None, None,
                           n_out, tile, lc.STRIDED_CHUNK, "segmix",
                           meta["tail"], device, dtype, plain,
                           planned=(meta["stride"], lay, cp))

        def compute(t, p, x):
            k = stage.run(t, p, x, origin)
            if balanced:
                k = collectives.reduce_scatter(k, mesh)
            return k

    def run(temperature, pressure, vmr):
        rows, (t, p, x) = _local_layers(temperature, pressure, vmr, mesh,
                                        dtype)
        k = compute(t, p, x)
        if weight_density:
            k = _weight(k, t, p, x, static, s * local_n, local_n, stacked)
        return Slab(k, rows, slice(s * local_n, (s + 1) * local_n))

    def kernel_inputs(temperature, pressure, vmr):
        """(stage, wings SoA, core params) of this rank's first stop (its
        own block) on its rows: ``stage.wings_pass(soa, plain=...)`` and
        ``stage.core_pass(core, plain=...)`` run the two kernels or their
        plain versions on them."""
        _, (t, p, x) = _local_layers(temperature, pressure, vmr, mesh, dtype)
        if ring:
            return (stops[0], *stops[0].assemble(own.fields(), q_dev, t, p,
                                                   x, origin))
        return (stage, *stage.assemble(t, p, x, origin))

    step = _Step(run, mesh, info, "plain" if plain else "kernel", local_n)
    step.kernel_inputs = kernel_inputs
    step.stride = meta["stride"]
    return step


def make_lines_sharded_step(static, info, mesh, weight_density=True,
                            chunk=512, backend=None, blocks=None, tile=None,
                            t_max=350.0, p_max_atm=5.0, interpret=False, *,
                            q_table=None, dtype=torch.float32):
    """Builds this rank's line-sharded absorption step.

    Each rank touches only its own block, so per-rank compute and line
    memory scale ~1/spec.  In "ring" mode the blocks circulate over the
    spec ring while each stop accumulates the masked contributions; in
    "balanced" mode every rank accumulates the full grid for its lines
    and one reduce-scatter lands each rank its slab.

    The parameters up to ``interpret`` are the JAX function's, in its
    order.

    Args:
        static / info / blocks / q_table: from parallel/shard_plans.py
            :func:`shard_line_pack` or :func:`shard_stacked_packs`, both
            required (the JAX step takes the blocks at call time; this one
            keeps them on the rank's device from the build).
        mesh: parallel/mesh.py mesh; the step runs on ``mesh.device``.
        backend: "kernel" (the wrappers: CUDA kernels for CUDA tensors,
            plain versions for CPU tensors), "plain" (plain versions on
            any device), "xla" (the portable ``accumulate_segment``
            branch), None or "auto" ("kernel" on a card, "xla" on the
            CPU; "pallas" is "kernel").  Where no stride fits, "kernel"
            and "plain" take the portable branch (``step.backend`` says
            which ran).
        interpret: the JAX package's Pallas interpret mode: True runs the
            plain versions (``backend="plain"``) unless ``backend`` is
            "xla".
        dtype: float dtype (the CUDA kernels take float32).

    Returns:
        ``step(temperature[B], pressure[B], vmr[B] or [B, G])`` -> this
        rank's :class:`Slab` of [B / batch, local_points]: cross sections
        [m2], or absorption [m-1] when ``weight_density``;
        ``step.gather(slab)`` the full [B, padded_points] on every rank.
    """
    if blocks is None or q_table is None:
        raise ValueError("make_lines_sharded_step keeps the line blocks "
                         "from the build: pass blocks= and q_table= (from "
                         "shard_line_pack or shard_stacked_packs)")
    dtype = resolve_dtype(dtype)
    backend = resolve_backend(backend, mesh.device, interpret)
    if backend in ("kernel", "plain"):
        step = _kernel_step(blocks, q_table, static, info, mesh,
                            weight_density, tile or lc.DEFAULT_TILE, t_max,
                            p_max_atm, dtype, backend == "plain")
        if step is not None:
            return step
        # Window too wide for any stride: the portable branch.
    return _portable_step(blocks, q_table, static, info, mesh,
                          weight_density, chunk, dtype)


def _portable_step(blocks, q_table, static, info, mesh, weight_density,
                   chunk, dtype):
    """The portable branch of :func:`make_lines_sharded_step`."""
    s = mesh.spec_index
    device = mesh.device
    stacked = "flat_points" in info
    num_points = info.get("flat_points", static["num_points"])
    local_n = info["local_points"]
    window = (2 * static["cut_off"] + 1) * static["n_per_v"] + 1
    core_w = min(128, (static["cut_off"] + 1) * static["n_per_v"])
    spec = mesh.shape[SPEC_AXIS]
    schedule = ring_schedule(info, spec)
    balanced = info.get("mode") == "balanced"
    seg_n = local_n * spec if balanced else local_n
    origin = 0 if balanced else s * local_n
    q_dev = torch.as_tensor(q_table, device=device).to(dtype)
    own = _BlockCarrier({k: v[s] for k, v in blocks.items()}, device, dtype)

    def accumulate_block(carrier, t, p, x, k):
        lines = dict(carrier.fields(), q_table=q_dev)
        ka = _pad_to_chunk(line_kernel_arrays(lines, static, t, p, x), chunk)
        return k + accumulate_segment(ka, origin, seg_n, num_points, window,
                                      core_w, chunk)

    def run(temperature, pressure, vmr):
        rows, (t, p, x) = _local_layers(temperature, pressure, vmr, mesh,
                                        dtype)
        k = accumulate_block(own, t, p, x, torch.zeros(
            (t.shape[0], seg_n), dtype=dtype, device=device))
        cur = {"up": own, "dn": own}
        for kind, _ in schedule[1:]:
            cur[kind] = cur[kind].shifted(mesh, +1 if kind == "up" else -1)
            k = accumulate_block(cur[kind], t, p, x, k)
        if balanced:
            k = collectives.reduce_scatter(k, mesh)
        if weight_density:
            k = _weight(k, t, p, x, static, s * local_n, local_n, stacked)
        return Slab(k, rows, slice(s * local_n, (s + 1) * local_n))

    return _Step(run, mesh, info, "xla", local_n)


def make_sharded_step(arrays, static, mesh, kin=None, chunk=512,
                      dtype=torch.float32):
    """Builds this rank's replicated-lines step: every rank holds every
    line and accumulates its grid slab with the portable
    ``accumulate_segment`` (the JAX ``make_sharded_step``).

    Returns:
        (step, info): ``step(temperature[B], pressure[B], vmr[B])`` -> this
        rank's :class:`Slab` [B / batch, local_points] of number-density
        weighted absorption [m-1] (``step.gather`` the full [B,
        padded_points]); info {"padded_points", "local_points"}.  Callers
        slice to num_points.
    """
    dtype = resolve_dtype(dtype)
    spec = mesh.shape[SPEC_AXIS]
    num_points = static["num_points"]
    local_n = -(-num_points // spec)
    padded_n = local_n * spec
    window = (2 * static["cut_off"] + 1) * static["n_per_v"] + 1
    if kin is not None:
        core_w = core_halfwidth(kin, static["n_per_v"], static["cut_off"])
    else:
        core_w = min(128, (static["cut_off"] + 1) * static["n_per_v"])
    origin = mesh.spec_index * local_n
    lines = as_tensors(arrays, mesh.device, dtype)

    def run(temperature, pressure, vmr):
        rows, (t, p, x) = _local_layers(temperature, pressure, vmr, mesh,
                                        dtype)
        ka = _pad_to_chunk(line_kernel_arrays(lines, static, t, p, x), chunk)
        k = accumulate_segment(ka, origin, local_n, num_points, window,
                               core_w, chunk)
        return Slab(k * (p * x / (c.KB * t))[:, None], rows,
                    slice(origin, origin + local_n))

    info = {"padded_points": padded_n, "local_points": local_n}
    return _Step(run, mesh, info, "xla", local_n), info


def _pipeline(step, mesh, static, remover, num_gases, flat, dtype):
    """The pipelines' shared finish: gather a batch group's slabs over
    spec, remove the pedestal once per batch group (on its first spec
    rank, then broadcast), reshape and weight.  Returns rows(t, p, x,
    weight) -> Slab of [Bl, G, N] (G = 1 squeezed by the caller)."""
    num_points = static["num_points"]
    stacked = "flat_points" in step.info

    def rows(temperature, pressure, vmr, weight):
        t64 = np.atleast_1d(np.asarray(temperature, np.float64))
        p64 = np.atleast_1d(np.asarray(pressure, np.float64))
        x64 = np.asarray(vmr, np.float64).reshape(t64.size, -1)
        slab = step(t64, p64, x64 if stacked else x64[:, 0])
        k = _gather_points(slab.data, mesh)[:, :flat]
        k = k.reshape(k.shape[0], num_gases, num_points)
        if remover is not None:
            if mesh.spec_index == 0:
                r = slab.rows
                k = remover(k, t64[r], p64[r], x64[r])
            k = collectives.broadcast(k.contiguous(), mesh, SPEC_AXIS)
        if weight:
            _, (t, p, x) = _local_layers(t64, p64, x64, mesh, dtype)
            n_density = p[:, None] * x / (c.KB * t[:, None])
            k = k * n_density[..., None]
        return Slab(k, slab.rows, slice(None))

    return rows


def _attach(fn, rows, mesh, flat, local_n, squeeze):
    """fn, fn.device, fn.rows on top of a pipeline's rows()."""
    def full(temperature, pressure, vmr, weight):
        k = collectives.all_gather(rows(temperature, pressure, vmr,
                                        weight).data, mesh, BATCH_AXIS)
        return k[:, 0] if squeeze else k

    def device_fn(temperature, pressure, vmr, weight=None):
        out = rows(temperature, pressure, vmr,
                   fn.weight_density if weight is None else weight)
        lo = min(mesh.spec_index * local_n, flat)
        hi = min(lo + local_n, flat)
        data = out.data.reshape(out.data.shape[0], -1)[:, lo:hi]
        return Slab(data, out.rows, slice(lo, hi))

    fn.full = full
    fn.device = device_fn
    fn.rows = rows
    return fn


def make_multigas_sharded_pipeline(packs, grid, mesh,
                                   cut_off=c.DEFAULT_CUT_OFF,
                                   mode="balanced", remove_pedestal=False,
                                   weight_density=False, chunk=512,
                                   backend=None, interpret=False, *,
                                   tile=None, dtype=torch.float32):
    """All gases, one sharded launch per rank: the config-5 composition.

    Gas stacking (one wings and one core pass for every molecule) composed
    with line sharding over the mesh's "spec" axis and layer batching over
    "batch".  The pedestal is removed once per batch group, after its
    slabs are gathered over "spec", on the group's first spec rank
    (parallel/lines.py ``make_stacked_pedestal_remover``), and broadcast
    to the group.  The parameters up to ``interpret`` are the JAX
    function's, in its order; ``interpret`` and ``backend`` as
    :func:`make_lines_sharded_step`.

    Returns:
        ``fn(temperature[B], pressure[B], vmr[B, G])`` -> numpy float64
        [B, G, num_points] cross sections [m2] (absorption [m-1] when
        ``weight_density``), gases ordered as ``fn.names`` =
        ``list(packs)``, the same bits on every rank.
        ``fn.device(...)`` returns this rank's :class:`Slab` of that array
        ([B / batch, flat points of its spec slab] on its device, with its
        row slice and flat-point slice of the [B, G * num_points] view);
        ``fn.rows(t, p, x, weight)`` the batch group's [B / batch, G,
        num_points] rows; ``fn.total(...)`` the density-weighted gas sum
        [B, num_points] in m-1 on every rank's device; ``fn.step`` the
        sharded step.
    """
    dtype = resolve_dtype(dtype)
    spec = mesh.shape[SPEC_AXIS]
    blocks, q_table, static, info, names = shard_stacked_packs(
        packs, grid, spec, cut_off, mode)
    step = make_lines_sharded_step(static, info, mesh, weight_density=False,
                                   chunk=chunk, backend=backend,
                                   blocks=blocks, tile=tile,
                                   interpret=interpret, q_table=q_table,
                                   dtype=dtype)
    remover = make_stacked_pedestal_remover(packs, grid, cut_off) \
        if remove_pedestal else None
    flat = static["flat_points"]
    rows = _pipeline(step, mesh, static, remover, static["num_gases"], flat,
                     dtype)

    def fn(temperature, pressure, vmr):
        return fn.full(temperature, pressure, vmr, weight_density) \
            .cpu().numpy().astype(np.float64)

    def total(temperature, pressure, vmr):
        k = rows(temperature, pressure, vmr, True).data
        out = k[:, 0]
        for g in range(1, k.shape[1]):
            out = out + k[:, g]
        return collectives.all_gather(out, mesh, BATCH_AXIS)

    fn.weight_density = weight_density
    fn.total = total
    fn.names = names
    fn.step = step
    fn.info = info
    return _attach(fn, rows, mesh, flat, info["local_points"], False)


def make_sharded_pipeline(pack, grid, mesh, cut_off=c.DEFAULT_CUT_OFF,
                          mode="balanced", remove_pedestal=False,
                          weight_density=True, chunk=512, backend=None,
                          interpret=False, *, tile=None,
                          dtype=torch.float32):
    """End-to-end sharded absorption of one gas, with optional pedestal
    removal (once per batch group, as
    :func:`make_multigas_sharded_pipeline`).  The parameters up to
    ``interpret`` are the JAX function's, in its order.

    Returns:
        ``fn(temperature[B], pressure[B], vmr[B])`` -> numpy float64 [B,
        num_points] cross sections [m2] (absorption [m-1] when
        ``weight_density``), the same bits on every rank; ``fn.device``
        this rank's :class:`Slab` of it; ``fn.step`` the sharded step.
    """
    from ..models.lines.gas import internal_grid

    dtype = resolve_dtype(dtype)
    spec = mesh.shape[SPEC_AXIS]
    v0, vn, _, num_points = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, cut_off)
    blocks, q_table, static, info = shard_line_pack(pack, grid, spec,
                                                    cut_off, mode)
    step = make_lines_sharded_step(static, info, mesh, weight_density=False,
                                   chunk=chunk, backend=backend,
                                   blocks=blocks, tile=tile,
                                   interpret=interpret, q_table=q_table,
                                   dtype=dtype)
    remover = make_stacked_pedestal_remover({pack.formula: pack}, grid,
                                            cut_off) \
        if remove_pedestal and keep else None
    rows = _pipeline(step, mesh, static, remover, 1, num_points, dtype)

    def fn(temperature, pressure, vmr):
        return fn.full(temperature, pressure, vmr, weight_density) \
            .cpu().numpy().astype(np.float64)

    fn.weight_density = weight_density
    fn.step = step
    fn.info = info
    return _attach(fn, rows, mesh, num_points, info["local_points"], True)
