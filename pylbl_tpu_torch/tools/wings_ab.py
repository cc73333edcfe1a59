"""The wings kernel against other builds of ``csrc/lineshape.cu``, in turns.

Times the tile kernel's Lorentzian passes (the prepacked strided wings of
the stacked and single-layer paths, the prepacked splat wings, the raw
splat and the ownership-checked strided wings) through this checkout's
library and through libraries built from other versions of the kernel
source, in one process on one card, on the inputs of ``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.wings_ab --other PATH.cu[:K] [...]
        [--cells D,Cr,Bs,Co,E2,A16,A,B,C,Ct,F,G,Sw] [--reps N]
        [--json OUT]

Each ``--other`` names a source file or ``this``, and the chunks per
piece its wings walk takes (default: :data:`WINGS_PIECE_CHUNKS`), as
``tools/ab.py`` says; another library must have this checkout's C entry
``pylbl_wings``.  Cells of the prepacked line function (PRE):

- ``A16`` / ``A``: the 7-gas column A at 0.1 cm-1 (strided wings with the
  tail class), 16 layers / the first 2 (phase 5);
- ``B``: the same gases at 0.01 cm-1 over 1-1000 cm-1 (the splat), layers
  0 and 5 of the 16 (phase 5);
- ``C``: the 300k-line headline layer's single-layer device plan
  (phase 8); ``Ct``: the same layer on the strided layout with the tail
  class (phase 11);
- ``F``: config 5, 0.01 cm-1 over 1-5000 cm-1, the first block of 4
  layers (phase 14);
- ``G``: rank 0's balanced shard of a (2, 2) mesh on A: spec shard 0,
  layers 0-7 (phase 15).

Of the raw Lorentzian (RAW, ``tile_lorentz``):

- ``D``: the headline layer at 0.01 cm-1 over 1-1000 cm-1, ``Gas``'s
  default plan, where no stride fits (phase 9);
- ``Cr``: C's plan with ``wings_mode="tile"`` (phase 11);
- ``Bs``: B's two layers through ``make_multigas_batched_fn(core_mode=
  "seg")``, whose splat keeps the raw rows.

Of the ownership-checked raw Lorentzian (OWN):

- ``Co``: C's layer on the straddle CSR at the strided plan's stride
  (``wings_strided_checked_single``, phase 12);
- ``E2``: layers 0 and 15 of E (C's pack over the canonical 16-layer
  column) on one straddle CSR at the batched pipeline's stride
  (``wings_strided_checked``, phase 12).

Of the segment wings (``pylbl_seg``, kind "wings"):

- ``Sw``: C's plan with ``wings_mode="seg"`` (phase 11); its bound the
  larger of 7 operations a term and the bytes of the 7 rows read, the
  stream walk and the output (``seg_bytes``); its grid is the
  library's, so K is not read.

Per cell the builds run in turns and are compared with the plain version
at their piece size (``tools/ab.py``), each timed with CUDA events and
the wings kernel alone from a profiler trace (``lorentz_walk_kernel`` or
``wings_kernel``; Sw: the chunk kernel ``seg_wings_kernel``, or an
earlier build's ``seg_chunk_kernel``, and ``seg_fold_kernel``).  Each cell prints its line kind, its counted
evaluations, its bound (``tile_ops`` at 67 TFLOP/s), its reciprocal floor
(:func:`rcp_floor_ms` at the SM clock nvidia-smi reads under load) and
each build's times; each build prints its Lorentzian walk's registers
and spills by line kind, and its segment wings', from ``-Xptxas -v``.  This build reads 0 against
its plain version on every cell; a build whose RAW or OWN term is still
the IEEE quotient (before the walk took them) differs from it by that
rounding.  Without CUDA it exits with code 2.
"""
import numpy as np
import torch

from . import (CUT_OFF, OPS_LORENTZ, PEAK_BYTES, PEAK_OPS, ab,
               canonical_layers, card, core_usage, headline_pack,
               headline_workload, layer_workload, rcp_floor_ms,
               require_cuda, sm_clock_mhz, tile_ops, walk_usage)
from ..database.fixtures import synthetic_line_pack
from ..ops import lineshape_cuda as lc

CELLS = ("D", "Cr", "Bs", "Co", "E2", "A16", "A", "B", "C", "Ct", "F",
         "G", "Sw")
# The line kind of each cell that is not the prepacked wings'.
LINES = {"D": "raw", "Cr": "raw", "Bs": "raw", "Co": "own", "E2": "own"}
# The wings kernels' names in a profiler trace: the Lorentzian walk, and
# the earlier walk that served RAW and OWN before it.
KERNELS = ("lorentz_walk_kernel", "wings_kernel")
GASES = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]
GRIDS = {"A": (1.0, 5000.0, 0.1), "B": (1.0, 1000.0, 0.01),
         "F": (1.0, 5000.0, 0.01)}


def column_packs():
    """The seven-gas synthetic line lists of the smoke's column (the JAX
    bench's ``multigas_packs``)."""
    return {name: synthetic_line_pack(
        name, num_lines=300000 if name == "H2O" else 20000, nu_min=0.5,
        nu_max=5100.0, seed=g + 1,
        band_centers=(150.0 + 400 * g, 1600.0, 3700.0))
        for g, name in enumerate(GASES)}


def layer_inputs(names, layers):
    """(t, p, x [B, G]) of the canonical 16-layer column's ``layers``."""
    t, p, vmr = canonical_layers(16)
    x = np.stack([vmr[n] for n in names], axis=1)
    return t[layers], p[layers], x[layers]


class Cell:
    """One cell's wings inputs: ``run(piece)`` runs the pass with pieces
    of ``piece`` chunks through the current library, ``plain(piece)`` its
    plain version, ``evals`` its counted terms, ``line`` its line kind,
    ``kernel`` its kernels' names in a profiler trace."""

    kernel = KERNELS

    def __init__(self, name, soa, n_out, launch, plain, counts, inputs):
        self.name = name
        self.line = LINES.get(name, "pre")
        self.soa = soa
        self.launch = launch
        self.plain = plain
        self.counts = counts
        self.ops = tile_ops(soa, n_out, self.line)
        self.evals = self.ops / OPS_LORENTZ
        nbytes = sum(t.numel() * t.element_size() for t in inputs
                     if t is not None)
        self.bound_ms = max(self.ops / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3
        self._pieces = {}

    def run(self, piece):
        if piece not in self._pieces:
            self._pieces[piece] = lc.TilePieces.of_csr(*self.counts,
                                                       piece=piece)
        return self.launch(self._pieces[piece])


def stage_cell(name, stage, soa):
    """A cell of a stacked stage's wings pass (strided or splat)."""
    csr = stage.csr_dev
    if stage.wings_stride is not None:
        tail_csr = csr[2:] or [None, None]
        args = (stage.n_out, stage.tile, stage.wings_stride,
                stage.wings_chunk, *tail_csr)
        tail = stage.wings_tail or 128

        def launch(pieces):
            return lc.wings_strided_pass(soa, csr[0], csr[1], *args,
                                         tail=tail, pieces=pieces)

        def plain(piece):
            return lc.wings_strided_plain(soa, csr[0], csr[1], *args,
                                          tail=tail, piece=piece)
    else:
        args = (stage.n_out, stage.tile, stage.wings_chunk,
                "wings_pre" if stage.prepacked else "wings")

        def launch(pieces):
            return lc.tile_pass(soa, csr[0], csr[1], *args, pieces)

        def plain(piece):
            return lc.tile_plain(soa, csr[0], csr[1], *args, piece=piece)
    return Cell(name, soa, stage.n_out, launch, plain, stage.csr[1::2],
                [soa, *csr])


def stacked_stage(packs, grid, layers, device, core_mode=None):
    """(stage, wings SoA, core parameters) of the stacked pipeline on
    ``grid`` for the canonical column's ``layers``."""
    from ..parallel.lines import make_multigas_batched_fn

    fn = make_multigas_batched_fn(packs, grid, device=device,
                                  core_mode=core_mode)
    soa, core = fn.assemble(*layer_inputs(fn.names, layers))
    return fn.stage, soa, core


def stacked_cell(name, packs, grid, layers, device, core_mode=None):
    stage, soa, _ = stacked_stage(packs, grid, layers, device, core_mode)
    return stage_cell(name, stage, soa)


def single_cell(device):
    """C: the headline layer's single-layer device plan."""
    work = headline_workload()
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device)
    args = (plan.w_start, plan.w_n, plan.num_points, plan.tile,
            plan.wings_stride)
    return Cell("C", plan.soa, plan.num_points,
                lambda pieces: lc.wings_strided_pass(plan.soa, *args,
                                                     pieces=pieces),
                lambda piece: lc.wings_strided_plain(plan.soa, *args,
                                                     piece=piece),
                [plan.w_n], [plan.soa, plan.w_start, plan.w_n])


def raw_cell(name, work, device, **plan_kwargs):
    """D or Cr: the raw Lorentzian splat of a single-layer device plan
    where no stride fits (D) or with ``wings_mode="tile"`` (Cr)."""
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device,
                               **plan_kwargs)
    assert plan.wings_stride is None and plan.wings is None
    args = (plan.w_start, plan.w_n, plan.num_points, plan.tile, plan.chunk,
            "wings")
    return Cell(name, plan.soa, plan.num_points,
                lambda pieces: lc.tile_pass(plan.soa, *args, pieces),
                lambda piece: lc.tile_plain(plan.soa, *args, piece=piece),
                [plan.w_n], [plan.soa, plan.w_start, plan.w_n])


def straddle_inputs(arrays, n, stride, device):
    """The ownership-checked wings' inputs for kernel ``arrays`` (one
    layer, or a batch that shares the CSR) at ``stride``: the raw SoA with
    each line's tile (its earliest window start over the layers //
    stride) in the _PAD row (-1 for pad lines) and the straddle CSR
    [start, nchunks] of :func:`lc.strided_line_ranges`, on ``device``."""
    soa, num = lc.pack_lines_soa(arrays, 512)
    s = arrays["s_idx"].astype(np.int64)
    s = s.min(axis=0) if s.ndim == 2 else s
    assign = np.clip(s, 0, None) // stride
    soa[..., lc._PAD, :num] = assign.astype(np.float32)
    soa[..., lc._PAD, num:] = -1.0
    csr = lc.strided_line_ranges(assign, (n - 1) // stride + 1)
    return (torch.as_tensor(soa, device=device),
            [torch.as_tensor(a, device=device) for a in csr])


def straddle_cell(name, arrays, n, stride, device):
    """Co or E2: the ownership-checked wings over the straddle CSR of
    ``arrays`` at ``stride`` (:func:`straddle_inputs`, as ``chip_smoke.py``
    phase 12 builds them)."""
    soa, csr = straddle_inputs(arrays, n, stride, device)
    args = (*csr, n, lc.DEFAULT_TILE, stride)
    return Cell(name, soa, n,
                lambda pieces: lc.wings_strided_checked_pass(
                    soa, *args, pieces=pieces),
                lambda piece: lc.wings_strided_checked_plain(
                    soa, *args, piece=piece),
                [csr[1]], [soa, *csr])


def own_single_cell(device):
    """Co: C's layer at the single-layer strided plan's stride."""
    work = headline_workload()
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device)
    return straddle_cell("Co", work["arrays"], work["n"], plan.wings_stride,
                         device)


def own_batch_cell(device):
    """E2: layers 0 and 15 of the canonical 16-layer column through C's
    pack, at the stride of the batched pipeline over the column."""
    from ..models.lines import internal_grid
    from ..models.lines.physics import kernel_inputs, line_profile_params
    from ..ops.lineshape import prepare_kernel_arrays
    from ..parallel.lines import make_batched_fn

    work = headline_workload()
    t, p, vmr = canonical_layers(16)
    two = [0, 15]
    stride = make_batched_fn(work["pack"], work["grid"],
                             device=device).wings_stride
    kin = kernel_inputs(line_profile_params(work["pack"], t[two], p[two],
                                            vmr["H2O"][two],
                                            keep=work["keep"]),
                        internal_grid(work["grid"])[0], work["npv"], CUT_OFF)
    arrays = prepare_kernel_arrays(kin, work["npv"], np.float32)
    return straddle_cell("E2", arrays, work["n"], stride, device)


def tail_cell(device):
    """Ct: the headline layer on the two-class strided layout (phase 11):
    the device plan's stride, chunks of 256 lines and tails of 128."""
    work = headline_workload()
    arrays, n = work["arrays"], work["n"]
    plan = lc.make_device_plan(arrays, work["kin"], n, work["npv"], CUT_OFF,
                               device=device)
    lay = lc.build_strided_layout(arrays["s_idx"].astype(np.int64),
                                  plan.wings_stride, n, tail=128)
    ka = {k: lay.gather(v) for k, v in arrays.items()}
    for key, fill in (("prefactor", 0.0), ("s_idx", -1), ("e_idx", -2)):
        ka[key] = np.where(lay.dead, fill, ka[key]).astype(ka[key].dtype)
    soa = lc.pack_lines_soa(ka, 512)[0]
    soa[lc.PREF] = soa[lc.PREF] * soa[lc.Y] * np.float32(1 / np.sqrt(np.pi))
    soa[lc.Y] = soa[lc.Y] * soa[lc.Y]
    soa = torch.as_tensor(soa, device=device)
    csr = [torch.as_tensor(a, device=device)
           for a in (lay.w_start, lay.w_n, lay.t_start, lay.t_n)]
    args = (csr[0], csr[1], n, lc.DEFAULT_TILE, plan.wings_stride,
            lc.STRIDED_CHUNK, csr[2], csr[3])
    return Cell("Ct", soa, n,
                lambda pieces: lc.wings_strided_pass(soa, *args, tail=128,
                                                     pieces=pieces),
                lambda piece: lc.wings_strided_plain(soa, *args, tail=128,
                                                     piece=piece),
                [lay.w_n, lay.t_n], [soa, *csr])


def shard_cell(packs, grid, device):
    """G: spec shard 0 of a balanced (2, 2) mesh, its batch group's 8
    layers, planned as the sharded step plans rank 0's stage."""
    stage, soa, _ = shard_stage(packs, grid, device)
    return stage_cell("G", stage, soa)


def shard_stage(packs, grid, device, spec=2, mode="balanced", tile=1024):
    """(stage, wings SoA, core parameters) of G (:func:`shard_cell`)."""
    from ..parallel.lines import _LineStage
    from ..parallel.shard_plans import shard_plan_list, shard_stacked_packs

    blocks, q_table, static, info, names = shard_stacked_packs(
        packs, grid, spec, CUT_OFF, mode)
    ((plan, lay, core),), meta = shard_plan_list(
        blocks, static, info, tile, 350.0, 5.0, shards=[0])
    stage = _LineStage(dict(plan["lines"], q_table=q_table), static, None,
                       None, None, None, None, meta["n_out"], tile,
                       lc.STRIDED_CHUNK, "segmix", meta["tail"], device,
                       torch.float32, False,
                       planned=(meta["stride"], lay, core))
    soa, core = stage.assemble(*(torch.as_tensor(a, device=device,
                                                 dtype=torch.float32)
                                 for a in layer_inputs(names, slice(0, 8))))
    return stage, soa, core


def seg_wings_cell(device, work=None):
    """Sw: the segment wings (``pylbl_seg``) of C's plan with
    ``wings_mode="seg"`` (phase 11), a ``core_census.SegCell``: its bound
    the larger of 7 operations a term and the 7 rows read
    (``seg_bytes``)."""
    from .core_census import seg_layer_cell

    return seg_layer_cell("Sw", device, work, wings_mode="seg")


def build_cells(names, device):
    packs = column_packs() if set(names) & {"A16", "A", "B", "Bs", "F",
                                            "G"} else None
    grid = {k: np.arange(*v) for k, v in GRIDS.items()}
    makers = {
        "D": lambda: raw_cell("D", layer_workload(headline_pack(),
                                                  grid["B"]), device),
        "Cr": lambda: raw_cell("Cr", headline_workload(), device,
                               wings_mode="tile"),
        "Bs": lambda: stacked_cell("Bs", packs, grid["B"], [0, 5], device,
                                   core_mode="seg"),
        "Co": lambda: own_single_cell(device),
        "E2": lambda: own_batch_cell(device),
        "A16": lambda: stacked_cell("A16", packs, grid["A"], slice(0, 16),
                                    device),
        "A": lambda: stacked_cell("A", packs, grid["A"], slice(0, 2), device),
        "B": lambda: stacked_cell("B", packs, grid["B"], [0, 5], device),
        "C": lambda: single_cell(device),
        "Ct": lambda: tail_cell(device),
        "F": lambda: stacked_cell("F", packs, grid["F"], slice(0, 4),
                                  device),
        "G": lambda: shard_cell(packs, grid["A"], device),
        "Sw": lambda: seg_wings_cell(device),
    }
    unknown = [name for name in names if name not in makers]
    if unknown:
        raise ValueError(f"unknown cell(s) {unknown}; cells: {CELLS}")
    return [makers[name]() for name in names]


def seg_wings_usage(log):
    """The segment wings' chunk kernel's ``ptxas_usage`` (an earlier
    build's ``seg_chunk_kernel<1>``); None when the log has neither."""
    return (core_usage(log, "seg_wings_kernel")
            or core_usage(log, "seg_chunk_kernelILi1E"))


def run(others, cells=CELLS, reps=10, out=None):
    require_cuda("wings_ab")
    builds = ab.load_builds(others, lc.WINGS_PIECE_CHUNKS)
    print(f"wings_ab on {card()}")
    usage = ab.build_usage(builds, walk_usage)
    for label, kinds in usage.items():
        for kind, use in (kinds or {}).items():
            print(f"  {label}: Lorentzian walk ({kind.upper()}) {use}")
    seg = ab.build_usage(builds, seg_wings_usage)
    for label, use in seg.items():
        print(f"  {label}: segment wings {use}")
    report = {"card": card(), "walk_usage": usage, "seg_wings_usage": seg,
              "cells": {}}
    for cell in build_cells(list(cells), torch.device("cuda")):
        turns = ab.in_turns(builds, cell.run, cell.plain, reps, cell.kernel)
        mhz = sm_clock_mhz(lambda: cell.run(lc.WINGS_PIECE_CHUNKS))
        record = {"line": cell.line, "evals": cell.evals,
                  "bound_ms": cell.bound_ms, "sm_mhz": mhz,
                  "rcp_floor_ms": rcp_floor_ms(cell.evals, mhz),
                  "builds": turns}
        report["cells"][cell.name] = record
        print(f"{cell.name} ({cell.line.upper()}): {cell.evals:.6e} "
              f"evaluations, bound {cell.bound_ms:.6f} ms, reciprocal floor "
              f"{record['rcp_floor_ms']:.6f} ms at {mhz:.0f} MHz")
        ab.print_turns(turns)
    return ab.write_report(report, out)


def main(argv=None):
    return ab.main("wings_ab", __doc__, run, CELLS, lc.WINGS_PIECE_CHUNKS,
                   argv)


if __name__ == "__main__":
    raise SystemExit(main())
