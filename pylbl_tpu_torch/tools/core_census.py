"""A census of the mixed-slot core's work, by chunk class and Humlicek region.

Labels every (instance, offset) pair of every chunk the mixed-slot core
walks (``csrc/lineshape.cu`` ``core_segmix_kernel``) as the kernel does, in
its float32 arithmetic: the chunk's class from its min y (skipped at >=
70.55), the offset in or out of the instance's window, and an in-window
offset's correction needed or not (|x| < xlim0; x^2 < k1_limit in class 1)
and, if needed, its list: K1 (class 1) or region 1, 2, 3 or CPF12 (split
by |x| <= xlim4 into its regions I and II), by ``region_limits``.  It
runs on any device (the CPU too) on the inputs of ``chip_smoke.py``::

    python -m pylbl_tpu_torch.tools.core_census [--cells A16,A,B,C,D,F,G]
        [--device cpu|cuda] [--json OUT]

Cells, built by ``wings_ab``'s builders: ``A16`` / ``A`` the 7-gas column
at 0.1 cm-1, 16 layers / the first 2; ``B`` the same at 0.01 cm-1 over
1-1000 cm-1, layers 0 and 5; ``C`` the 300k-line headline layer's
single-layer device plan; ``D`` the same layer at 0.01 cm-1 over 1-1000
cm-1; ``F`` config 5's first block of 4 layers (0.01 cm-1 over 1-5000
cm-1); ``G`` rank 0's balanced shard of a (2, 2) mesh on A.

Per cell it prints the walked chunks by class, the lane evaluations of a
lane-per-offset walk (every walked chunk's 128 x 32 pairs), the in-window
points, the needed points by list, the instances with an in-window point
and those of them that need nothing, the instances with a point of each
list, the evaluation rounds of 32 pairs the kernel's lists take, and the
operation count of :func:`pylbl_tpu_torch.tools.census_ops` with its
bound (:func:`pylbl_tpu_torch.tools.census_bound`: the larger of the
operations at the FP32 peak and the bytes) beside the 41-operation
``core_ops`` one.  The
census leaves out what a plan never holds: a non-finite prefactor or a
slot outside the tile.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from . import (CUT_OFF, PEAK_BYTES, PEAK_OPS, census_bound, census_ops,
               core_bytes, core_ops, headline_pack, layer_workload,
               run_main)
from . import wings_ab
from ..ops import lineshape_cuda as lc
from ..ops.voigt import region_limits

CELLS = ("A16", "A", "B", "C", "D", "F", "G")
# Pair labels: offset outside the window, in the window with a +0.0
# correction, then the lists.
OUT, NONE, K1, R1, R2, R3, CPF_I, CPF_II = range(8)
LISTS = {"k1": (K1,), "r1": (R1,), "r2": (R2,), "r3": (R3,),
         "cpf12": (CPF_I, CPF_II)}
CLASS_NAMES = ("skip", "k1", "c2", "c3", "c4")
SLAB = 512


def chunk_classes(blocks):
    """[M] class of each chunk [M, 8, 128] from its min y: 0 (>= 70.55,
    skipped), 1 (>= 8.425, K1), 2 (>= 6.8), 3 (>= 2.0), else 4."""
    ymin = blocks[:, lc.SR_Y].amin(dim=-1)
    cls = torch.full(ymin.shape, 4, dtype=torch.int64, device=ymin.device)
    for threshold, value in ((2.0, 3), (6.8, 2), (8.425, 1), (70.55, 0)):
        cls = torch.where(ymin >= threshold, value, cls)
    return cls


def pair_labels(blocks):
    """([M, 128, 32] int8 labels, [M] classes) of chunks [M, 8, 128] in
    their float dtype (float32: the kernel's arithmetic)."""
    cls = chunk_classes(blocks)
    c = cls[:, None, None]
    row = {r: blocks[:, r, :, None] for r in range(lc.SEGP_ROWS)}
    o = torch.arange(lc.SEG, device=blocks.device).to(blocks.dtype)
    x = ((row[lc.SR_SEG0REL] + o) - row[lc.SR_CFRAC]) * row[lc.SR_SRW]
    inside = (o >= row[lc.SR_SREL]) & (o <= row[lc.SR_EREL])
    y = row[lc.SR_Y]
    xlim0, xlim1, xlim2, xlim3, xlim4, _ = region_limits(y)
    abx = x.abs()
    k1_need = x * x < torch.clamp_min(15100.0 + y * (40.0 - y * 3.6), 0.0)
    need = torch.where(c == 1, k1_need, abx < xlim0) & (y < 70.55) \
        & inside & (c > 0)
    region = torch.where(
        abx >= xlim1, R1, torch.where(
            (c == 2) | (abx >= xlim2), R2, torch.where(
                (c == 3) | (abx < xlim3), R3,
                torch.where(abx <= xlim4, CPF_I, CPF_II))))
    label = torch.where(need, torch.where(c == 1, K1, region),
                        torch.where(inside, NONE, OUT))
    return label.to(torch.int8), cls


def walked_blocks(params, t_start, t_chunks):
    """The [B * n, 8, 128] blocks of the chunks every layer walks (tile
    t's chunks t_start[t] .. t_start[t] + t_chunks[t] - 1), tile-major."""
    params = params if params.dim() == 3 else params[None]
    device = params.device
    t_start = torch.as_tensor(t_start, device=device)
    t_chunks = torch.as_tensor(t_chunks, device=device)
    _, _, ids = lc._chunk_refs(t_start, t_chunks, t_chunks.numel(), device)
    blocks = params.reshape(params.shape[0], lc.SEGP_ROWS, -1, lc.ROWS_CHUNK)
    return blocks.index_select(2, ids).permute(0, 2, 1, 3).reshape(
        -1, lc.SEGP_ROWS, lc.ROWS_CHUNK)


def census(params, t_start, t_chunks, slab=SLAB):
    """The census of a core parameter block [B, 8, I] or [8, I] walked
    through the chunk CSR (``t_start``, ``t_chunks``, [T], numpy or
    tensors): a dict of int counts (see the module's note)."""
    blocks = walked_blocks(params, t_start, t_chunks)
    pairs = torch.zeros(8, dtype=torch.int64, device=blocks.device)
    classes = torch.zeros(5, dtype=torch.int64, device=blocks.device)
    inst = {k: 0 for k in LISTS}
    out = dict(instances=0, instances_needing_nothing=0,
               needing_k1_chunks=0, needing_region_chunks=0, rounds=0)
    for lo in range(0, blocks.shape[0], slab):
        label, cls = pair_labels(blocks[lo:lo + slab])
        pairs += torch.bincount(label.reshape(-1).long(), minlength=8)
        classes += torch.bincount(cls, minlength=5)
        live = (label != OUT).any(dim=-1)
        needing = (label >= K1).any(dim=-1)
        out["instances"] += int(live.sum())
        out["instances_needing_nothing"] += int((live & ~needing).sum())
        k1_chunk = (cls == 1)[:, None]
        out["needing_k1_chunks"] += int((needing & k1_chunk).sum())
        out["needing_region_chunks"] += int((needing & ~k1_chunk).sum())
        for key, labels in LISTS.items():
            hit = sum((label == v).long() for v in labels)
            inst[key] += int((hit.sum(dim=-1) > 0).sum())
            per_chunk = hit.sum(dim=(1, 2))
            out["rounds"] += int(((per_chunk + 31) // 32).sum())
    pairs = pairs.tolist()
    classes = classes.tolist()
    chunks = sum(classes)
    out.update(
        chunks=chunks,
        chunks_by_class=dict(zip(CLASS_NAMES, classes)),
        lane_evals=chunks * lc.ROWS_CHUNK * lc.SEG,
        in_window=chunks * lc.ROWS_CHUNK * lc.SEG - pairs[OUT],
        needed={"k1": pairs[K1], "r1": pairs[R1], "r2": pairs[R2],
                "r3": pairs[R3], "cpf12_i": pairs[CPF_I],
                "cpf12_ii": pairs[CPF_II]},
        needed_total=sum(pairs[K1:]),
        instances_by_list=inst,
        parent_warp_iterations=(chunks - classes[0]) * lc.ROWS_CHUNK)
    return out


# Synthetic chunks by class: (y low, y high) of the instances and the min
# y one instance takes (the class's threshold or a tiny y).
_SYNTH_Y = {0: (70.6, 95.0, 70.55), 1: (8.5, 80.0, 8.425),
            2: (6.9, 30.0, 6.8), 3: (2.1, 12.0, 2.0), 4: (0.0, 3.0, 1e-7)}


def synthetic_core(seed=0, layers=2, tile=256, tile_chunks=(3, 0, 6),
                   classes=(0, 1, 2, 3, 4), dead=0.1):
    """A mixed-slot core input made from ``seed`` with numpy: ([B, 8, I]
    float32 parameters, t_start, t_chunks int32 [T], num_points), the
    chunks' classes cycling through ``classes`` (0: every y >= 70.55).
    Instances take windows inside, across and outside offsets 0..31 (some
    empty), x over the Humlicek regions (srw log-uniform 0.02-20), a
    ``dead`` share of dead fills (y = 100, empty window, zero prefactor),
    y inside a non-skip chunk up to past 70.55, one tiny or threshold y a
    chunk; layer b > 0 scales y by 1 + 0.1 b."""
    rng = np.random.default_rng(seed)
    t_chunks = np.asarray(tile_chunks, np.int32)
    t_start = (np.cumsum(t_chunks) - t_chunks).astype(np.int32)
    n = int(t_chunks.sum()) * lc.ROWS_CHUNK
    rows = np.zeros((lc.SEGP_ROWS, n), np.float32)
    cls = np.repeat([classes[k % len(classes)]
                     for k in range(int(t_chunks.sum()))], lc.ROWS_CHUNK)
    lo = np.asarray([_SYNTH_Y[c][0] for c in cls])
    hi = np.asarray([_SYNTH_Y[c][1] for c in cls])
    y = lo + (hi - lo) * rng.random(n) ** 2
    y[::lc.ROWS_CHUNK] = [_SYNTH_Y[c][2] for c in cls[::lc.ROWS_CHUNK]]
    y[cls > 0] = np.where(rng.random(int((cls > 0).sum())) < 0.03, 72.0,
                          y[cls > 0])
    y[cls == 4] = np.where(rng.random(int((cls == 4).sum())) < 0.05, 0.0,
                           y[cls == 4])
    s_rel = rng.integers(-12, 36, n).astype(np.float32)
    rows[lc.SR_SEG0REL] = rng.uniform(-40.0, 8.0, n)
    rows[lc.SR_CFRAC] = rng.random(n)
    rows[lc.SR_SRW] = np.exp(rng.uniform(np.log(0.02), np.log(20.0), n))
    rows[lc.SR_Y] = y
    rows[lc.SR_PREF] = rng.uniform(0.1, 2.0, n)
    rows[lc.SR_SREL] = s_rel
    rows[lc.SR_EREL] = s_rel + rng.integers(-3, 40, n)
    rows[lc.SR_SLOT] = rng.integers(0, tile // lc.SEG, n)
    gone = rng.random(n) < dead
    fills = np.asarray(lc._SEG_FILLS, np.float32)
    rows[:, gone] = fills[:, None]
    params = np.stack([rows] * layers)
    for b in range(1, layers):
        params[b, lc.SR_Y] = np.where(gone, rows[lc.SR_Y],
                                      rows[lc.SR_Y] * np.float32(1 + 0.1 * b))
    return params, t_start, t_chunks, t_chunks.size * tile


class CoreCell:
    """One cell's core inputs: ``params`` [B, 8, I] (or [8, I] for a
    single layer) and the plan's chunk CSR and pieces."""

    def __init__(self, name, plan, params):
        self.name = name
        self.plan = plan
        self.params = params
        consts = plan._device_consts(params.device)
        self.t_start, self.t_chunks = consts["t_start"], consts["t_chunks"]
        self.nbytes = core_bytes(params, self.t_chunks.numel(),
                                 plan.num_points)

    def census(self):
        return census(self.params, self.t_start, self.t_chunks)


def layer_cell(name, device, grid):
    """A single-layer device plan's core (C, D): the headline layer."""
    work = layer_workload(headline_pack(), grid)
    plan = lc.make_device_plan(work["arrays"], work["kin"], work["n"],
                               work["npv"], CUT_OFF, device=device)
    return CoreCell(name, plan.core, plan.groups)


def build_cells(names, device):
    """The core cells ``names`` on ``device`` (one stacked pipeline per
    grid, shared by the cells on it)."""
    packs = wings_ab.column_packs() if set(names) - {"C", "D"} else None
    grid = {k: np.arange(*v) for k, v in wings_ab.GRIDS.items()}
    layers = {"A16": ("A", slice(0, 16)), "A": ("A", slice(0, 2)),
              "B": ("B", [0, 5]), "F": ("F", slice(0, 4))}
    cells = []
    for name in names:
        if name in layers:
            key, rows = layers[name]
            stage, _, core = wings_ab.stacked_stage(packs, grid[key], rows,
                                                    device)
            cells.append(CoreCell(name, stage.core_plan, core))
        elif name == "G":
            stage, _, core = wings_ab.shard_stage(packs, grid["A"], device)
            cells.append(CoreCell(name, stage.core_plan, core))
        elif name == "C":
            cells.append(layer_cell(name, device,
                                    np.arange(1.0, 5000.0, 0.1)))
        elif name == "D":
            cells.append(layer_cell(name, device,
                                    np.arange(1.0, 1000.0, 0.01)))
        else:
            raise ValueError(f"unknown cell {name!r}")
    return cells


def describe(name, counts, params, nbytes):
    """The census's lines for one cell (``nbytes``: the bytes its pass
    must move)."""
    need = counts["needed"]
    total = counts["needed_total"]
    by_class = "/".join(str(counts["chunks_by_class"][k])
                        for k in CLASS_NAMES)
    ops41 = core_ops(params)
    bound, bound_by = census_bound(counts, nbytes)
    return "\n".join([
        f"{name}: {counts['chunks']} chunks (skip/K1/2/3/4 class "
        f"{by_class}), {counts['lane_evals']} lane evaluations, "
        f"{counts['in_window']} in-window points",
        f"  needed {total} ({total / max(counts['in_window'], 1):.4f} of "
        f"in-window): K1 {need['k1']}, r1 {need['r1']}, r2 {need['r2']}, "
        f"r3 {need['r3']}, CPF12 {need['cpf12_i']} (region I) + "
        f"{need['cpf12_ii']} (region II)",
        f"  instances {counts['instances']} with an in-window point, "
        f"{counts['instances_needing_nothing']} of them needing nothing; "
        "with a point of K1/r1/r2/r3/CPF12 "
        + "/".join(str(counts["instances_by_list"][k]) for k in LISTS),
        f"  rounds of 32 pairs {counts['rounds']}, lane-per-offset warp "
        f"iterations {counts['parent_warp_iterations']}",
        f"  census operations {census_ops(counts):.6e}, bound {bound:.6f} "
        f"ms ({bound_by}, {nbytes} bytes); core_ops {ops41:.6e}, bound "
        f"{max(ops41 / PEAK_OPS, nbytes / PEAK_BYTES) * 1e3:.6f} ms"])


def run(cells=CELLS, device="cpu", out=None):
    report = {}
    for cell in build_cells(list(cells), torch.device(device)):
        counts = cell.census()
        counts["census_ops"] = census_ops(counts)
        counts["bound_ms"], counts["bound_by"] = census_bound(counts,
                                                              cell.nbytes)
        counts["core_ops"] = core_ops(cell.params)
        report[cell.name] = counts
        print(describe(cell.name, counts, cell.params, cell.nbytes),
              flush=True)
    if out:
        Path(out).write_text(json.dumps(report, indent=1))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    return run_main("core_census", run, args.cells.split(","), args.device,
                    args.json)


if __name__ == "__main__":
    raise SystemExit(main())
