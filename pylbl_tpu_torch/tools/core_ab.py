"""The Humlicek core kernels against other builds of ``csrc/lineshape.cu``.

Times the mixed-slot core pass (``pylbl_core_segmix``) and the unit
walk's two kernels, CORR (``pylbl_wings`` with the correction line
function) and the rows core (``pylbl_rows``), through this checkout's
library and through libraries built from other versions of the kernel
source, in one process on one card, on the inputs of ``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.core_ab --other PATH.cu[:K] [...]
        [--cells A16,A,B,C,D,F,G,Cc,Rc,Rv,R16,Sc,S16] [--reps N]
        [--json OUT]

Each ``--other`` names a source file or ``this``, and the chunks per
piece its walk takes (default: the plan's, :func:`core_piece_chunks`,
for the mixed-slot core, :data:`WINGS_PIECE_CHUNKS` for CORR; the rows
core's pieces are fixed), as ``tools/ab.py`` says; another library must
have this checkout's C entries.  The cells are ``core_census``'s: the
mixed-slot core's A x 16, A, B, C, D, F's block of 4 and G's shard; CORR
on C's core CSR ``Cc``; the rows core on C ``Rc``, the same with the
separate min-y block ``Rv``, and on E x 16 ``R16``; the segment core
(``pylbl_seg``, its chunk kernel and fold summed in the kernel-alone
time) on C's plan with ``core_mode="seg"`` ``Sc`` and on E x 16 ``S16``
(its grid is the library's: K is not read).

Per cell the builds run in turns, timed with CUDA events and the kernel
alone from a profiler trace (the call's host work, a scratch allocation
and a memset among it, bounds the first on the small cells), and are
compared with the plain version at their piece size (``tools/ab.py``).
Each cell prints its census, the plan's piece size, its census bound
(:func:`pylbl_tpu_torch.tools.census_bound`) and its 41-operation bound
(``core_ops``, ``tile_ops`` or ``rows_ops``: 41 operations an in-window
point, 28 in class 1), both the larger of the operations at 67 TFLOP/s
and the bytes, and each build's times; each build prints the kernels'
registers and spills from ``-Xptxas -v`` (the unit walk's at tile 1024).
Without CUDA it exits with code 2.
"""
import torch

from . import (PEAK_BYTES, PEAK_OPS, ab, card, census_bound, census_ops,
               core_usage, pair_usage, require_cuda)
from .core_census import (CORE_CELLS, SEG_CELLS, PairCell, SegCell,
                          build_cells, describe_cell)
from ..ops import lineshape_cuda as lc

KERNEL = "core_segmix_kernel"
CELLS = CORE_CELLS + ("Cc", "Rc", "Rv", "R16") + SEG_CELLS


class Runner:
    """A core cell's launches: ``run(piece)`` through the current library
    with pieces of ``piece`` chunks (None: the plan's), ``plain(piece)``
    its plain version."""

    def __init__(self, cell):
        self.cell = cell
        self._pieces = {}

    def pieces(self, piece):
        if piece not in self._pieces:
            t_chunks = self.cell.plan.t_chunks
            self._pieces[piece] = (lc.TilePieces.of_core(t_chunks)
                                   if piece is None else
                                   lc.TilePieces(t_chunks, piece=piece))
        return self._pieces[piece]

    def run(self, piece):
        cell = self.cell
        return lc.core_segmix_pass(cell.params, cell.t_start, cell.t_chunks,
                                   cell.plan.num_points, cell.plan.tile,
                                   pieces=self.pieces(piece))

    def plain(self, piece):
        cell = self.cell
        return lc.core_segmix_plain(cell.params, cell.t_start, cell.t_chunks,
                                    cell.plan.num_points, cell.plan.tile,
                                    piece=self.pieces(piece).piece)


def usage_line(use):
    if use is None:
        return "no -Xptxas -v report"
    return (f"{use['registers']} registers, {use['smem']} bytes smem, "
            f"{use['spill_stores']} bytes spill stores, "
            f"{use['spill_loads']} bytes spill loads")


def build_usages(log):
    """The mixed-slot core's, the unit walk's and the segment core's
    ``ptxas_usage`` (an earlier build's: its chunk kernel's)."""
    return {"segmix": core_usage(log), **pair_usage(log),
            "seg_core": core_usage(log, "seg_core_kernel")
            or core_usage(log, "seg_chunk_kernelILi0E")}


def run(others, cells=CELLS, reps=10, out=None):
    require_cuda("core_ab")
    builds = ab.load_builds(others, None)
    print(f"core_ab on {card()}")
    report = {"card": card(), "builds": ab.build_usage(builds, build_usages),
              "cells": {}}
    for label, uses in report["builds"].items():
        for kernel, use in uses.items():
            print(f"  {label}: {kernel} {usage_line(use)}")
    for cell in build_cells(list(cells), torch.device("cuda")):
        pair = isinstance(cell, (PairCell, SegCell))
        runner = cell if pair else Runner(cell)
        counts = cell.census()
        print(describe_cell(cell, counts))
        turns = ab.in_turns(builds, runner.run, runner.plain, reps,
                            cell.kernel if pair else KERNEL)
        ops41 = cell.ops41
        bound, bound_by = census_bound(counts, cell.nbytes)
        record = {"census": counts, "census_ops": census_ops(counts),
                  "bound_ms": bound, "bound_by": bound_by,
                  "bytes": cell.nbytes, "ops41": ops41,
                  "ops41_bound_ms": max(ops41 / PEAK_OPS,
                                        cell.nbytes / PEAK_BYTES) * 1e3,
                  "builds": turns}
        if pair:
            record["kind"] = cell.kind
        else:
            record["plan_piece"] = runner.pieces(None).piece
        report["cells"][cell.name] = record
        print(f"  {cell.name}: bounds (the larger of operations and "
              f"{cell.nbytes} bytes): census {bound:.6f} ms ({bound_by}), "
              f"41-operation {record['ops41_bound_ms']:.6f} ms"
              + ("" if pair else
                 f"; the plan's pieces: {record['plan_piece']} chunks"))
        ab.print_turns(turns)
    return ab.write_report(report, out)


def main(argv=None):
    return ab.main("core_ab", __doc__, run, CELLS, None, argv)


if __name__ == "__main__":
    raise SystemExit(main())
