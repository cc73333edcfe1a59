"""The wings kernel against other builds of ``csrc/lineshape.cu``, in turns.

Times the tile kernel's prepacked Lorentzian passes (the strided wings of
the stacked and single-layer paths, the splat wings) through this
checkout's library and through libraries built from other versions of the
kernel source, in one process on one card, on the inputs of
``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.wings_ab --other PATH.cu[:K] [...]
        [--cells A16,A,B,C,Ct,F,G] [--reps N] [--json OUT]

Each ``--other`` names a source file or ``this``, and the chunks per
piece its wings walk takes (default: :data:`WINGS_PIECE_CHUNKS`), as
``tools/ab.py`` says; another library must have this checkout's C entry
``pylbl_wings``.  Cells:

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

Per cell the builds run in turns and are compared with the plain version
at their piece size (``tools/ab.py``).  Each cell prints its
counted evaluations, its bound (``tile_ops`` at 67 TFLOP/s), its
reciprocal floor (:func:`rcp_floor_ms` at the SM clock nvidia-smi reads
under load) and each build's times; each build prints its Lorentzian
walk's registers and spills from ``-Xptxas -v``.  Without CUDA it exits
with code 2.
"""
import numpy as np
import torch

from . import (CUT_OFF, OPS_LORENTZ, PEAK_BYTES, PEAK_OPS, ab,
               canonical_layers, card, headline_workload, rcp_floor_ms,
               require_cuda, sm_clock_mhz, tile_ops, walk_usage)
from ..database.fixtures import synthetic_line_pack
from ..ops import lineshape_cuda as lc

CELLS = ("A16", "A", "B", "C", "Ct", "F", "G")
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
    plain version, ``evals`` its counted terms."""

    def __init__(self, name, soa, n_out, launch, plain, counts, inputs):
        self.name = name
        self.soa = soa
        self.launch = launch
        self.plain = plain
        self.counts = counts
        self.ops = tile_ops(soa, n_out, "pre")
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
        args = (stage.n_out, stage.tile, stage.wings_chunk, "wings_pre")

        def launch(pieces):
            return lc.tile_pass(soa, csr[0], csr[1], *args, pieces)

        def plain(piece):
            return lc.tile_plain(soa, csr[0], csr[1], *args, piece=piece)
    return Cell(name, soa, stage.n_out, launch, plain, stage.csr[1::2],
                [soa, *csr])


def stacked_stage(packs, grid, layers, device):
    """(stage, wings SoA, core parameters) of the stacked pipeline on
    ``grid`` for the canonical column's ``layers``."""
    from ..parallel.lines import make_multigas_batched_fn

    fn = make_multigas_batched_fn(packs, grid, device=device)
    soa, core = fn.assemble(*layer_inputs(fn.names, layers))
    return fn.stage, soa, core


def stacked_cell(name, packs, grid, layers, device):
    stage, soa, _ = stacked_stage(packs, grid, layers, device)
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


def build_cells(names, device):
    packs = column_packs() if set(names) - {"C", "Ct"} else None
    grid = {k: np.arange(*v) for k, v in GRIDS.items()}
    makers = {
        "A16": lambda: stacked_cell("A16", packs, grid["A"], slice(0, 16),
                                    device),
        "A": lambda: stacked_cell("A", packs, grid["A"], slice(0, 2), device),
        "B": lambda: stacked_cell("B", packs, grid["B"], [0, 5], device),
        "C": lambda: single_cell(device),
        "Ct": lambda: tail_cell(device),
        "F": lambda: stacked_cell("F", packs, grid["F"], slice(0, 4),
                                  device),
        "G": lambda: shard_cell(packs, grid["A"], device),
    }
    return [makers[name]() for name in names]


def run(others, cells=CELLS, reps=10, out=None):
    require_cuda("wings_ab")
    builds = ab.load_builds(others, lc.WINGS_PIECE_CHUNKS)
    print(f"wings_ab on {card()}")
    for label, use in ab.build_usage(builds, walk_usage).items():
        print(f"  {label}: Lorentzian walk (PRE) {use}")
    report = {"card": card(), "cells": {}}
    for cell in build_cells(list(cells), torch.device("cuda")):
        turns = ab.in_turns(builds, cell.run, cell.plain, reps)
        mhz = sm_clock_mhz(lambda: cell.run(lc.WINGS_PIECE_CHUNKS))
        record = {"evals": cell.evals, "bound_ms": cell.bound_ms,
                  "sm_mhz": mhz,
                  "rcp_floor_ms": rcp_floor_ms(cell.evals, mhz),
                  "builds": turns}
        report["cells"][cell.name] = record
        print(f"{cell.name}: {cell.evals:.6e} evaluations, bound "
              f"{cell.bound_ms:.6f} ms, reciprocal floor "
              f"{record['rcp_floor_ms']:.6f} ms at {mhz:.0f} MHz")
        ab.print_turns(turns)
    return ab.write_report(report, out)


def main(argv=None):
    return ab.main("wings_ab", __doc__, run, CELLS, lc.WINGS_PIECE_CHUNKS,
                   argv)


if __name__ == "__main__":
    raise SystemExit(main())
