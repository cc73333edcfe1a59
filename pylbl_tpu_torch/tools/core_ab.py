"""The mixed-slot core kernel against other builds of ``csrc/lineshape.cu``.

Times the mixed-slot core pass (``pylbl_core_segmix``) through this
checkout's library and through libraries built from other versions of the
kernel source, in one process on one card, on the inputs of
``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.core_ab --other PATH.cu[:K] [...]
        [--cells A16,A,B,C,D,F,G] [--reps N] [--json OUT]

Each ``--other`` names a source file or ``this``, and the chunks per
piece its walk takes (default: the plan's, :func:`core_piece_chunks`),
as ``tools/ab.py`` says; another library must have this checkout's C
entry ``pylbl_core_segmix``.  The cells are ``core_census``'s (A x 16,
A, B, C, D, F's block of 4, G's shard).

Per cell the builds run in turns, timed with CUDA events and the kernel
alone from a profiler trace (the call's host work, a scratch allocation
and a memset among it, bounds the first on the small cells), and are
compared with the plain version at their piece size (``tools/ab.py``).
Each cell prints its census, the plan's piece size, its census bound
(:func:`pylbl_tpu_torch.tools.census_bound`) and its 41-operation bound
(``core_ops``: 41 operations an in-window point), both the larger of the
operations at 67 TFLOP/s and the bytes, and each build's times; each
build prints the core kernel's registers and spills from ``-Xptxas -v``.
Without CUDA it exits with code 2.
"""
import torch

from . import (PEAK_BYTES, PEAK_OPS, ab, card, census_bound, census_ops,
               core_ops, core_usage, require_cuda)
from .core_census import CELLS, build_cells, describe
from ..ops import lineshape_cuda as lc

KERNEL = "core_segmix_kernel"


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


def run(others, cells=CELLS, reps=10, out=None):
    require_cuda("core_ab")
    builds = ab.load_builds(others, None)
    print(f"core_ab on {card()}")
    report = {"card": card(), "builds": ab.build_usage(builds, core_usage),
              "cells": {}}
    for label, use in report["builds"].items():
        print(f"  {label}: {KERNEL} {usage_line(use)}")
    for cell in build_cells(list(cells), torch.device("cuda")):
        runner = Runner(cell)
        counts = cell.census()
        print(describe(cell.name, counts, cell.params, cell.nbytes))
        turns = ab.in_turns(builds, runner.run, runner.plain, reps, KERNEL)
        ops41 = core_ops(cell.params)
        bound, bound_by = census_bound(counts, cell.nbytes)
        record = {"census": counts, "census_ops": census_ops(counts),
                  "plan_piece": runner.pieces(None).piece,
                  "bound_ms": bound, "bound_by": bound_by,
                  "bytes": cell.nbytes, "ops41": ops41,
                  "ops41_bound_ms": max(ops41 / PEAK_OPS,
                                        cell.nbytes / PEAK_BYTES) * 1e3,
                  "builds": turns}
        report["cells"][cell.name] = record
        print(f"  the plan's pieces: {record['plan_piece']} chunks; bounds "
              f"(the larger of operations and {cell.nbytes} bytes): census "
              f"{bound:.6f} ms ({bound_by}), 41-operation "
              f"{record['ops41_bound_ms']:.6f} ms")
        ab.print_turns(turns)
    return ab.write_report(report, out)


def main(argv=None):
    return ab.main("core_ab", __doc__, run, CELLS, None, argv)


if __name__ == "__main__":
    raise SystemExit(main())
