"""Device time of every single-layer pass on the headline workload.

Counterpart of ``tools/kernel_microbench.py``: the 300k-line synthetic
H2O surface layer on 1-5000 cm-1 at 0.1 (50,000 points), each pass timed
with CUDA events over warm calls on one card:

- ``wings``: raw-Lorentz splat wings over the tile CSR (chunk 512);
- ``core-scalar``: the per-line correction over the core-window CSR;
- ``core-rows`` / ``core-rows-vmem``: the rows core, class from row 56 or
  from the separate min-y block;
- ``core-seg`` / ``core-segmix``: the per-stream and mixed-slot
  segment-32 cores;
- ``two-pass`` / ``two-pass-seg``: splat wings plus the rows or
  per-stream core;
- ``wings-strided-checked[stride]``: the ownership-checked strided wings
  on the straddle CSR of ``strided_line_ranges`` with assign =
  clip(s_idx, 0) // stride;
- ``wings-strided[stride]``: the prepacked strided wings of the device
  plan (private per-tile chunks);
- ``two-pass-strided``: the checked strided wings plus the per-stream
  core.

Each line gives ms per spectrum and masked line-point evaluations per
second (the JAX package's headline unit).  Run on a CUDA card::

    python -m pylbl_tpu_torch.tools.kernel_microbench [--lines N]
        [--reps R] [--only name,name]

Without CUDA it exits with code 2.
"""
import argparse

import numpy as np
import torch

from . import (CUT_OFF, card, device_ms, headline_workload, masked_evals,
               require_cuda, run_main)
from ..ops import lineshape_cuda as lc
from ..ops.lineshape import core_halfwidth


def build_stages(work, device, tile=lc.DEFAULT_TILE, chunk=lc.DEFAULT_CHUNK):
    """[(name, fn, visits)] for ``work`` (:func:`headline_workload` or any
    :func:`layer_workload`) on ``device``: ``fn()`` runs one pass (the
    kernels on a CUDA device, their plain versions on the CPU) and
    ``visits`` counts its line-tile visits or instance slots (None for the
    composite stages)."""
    arrays, kin = work["arrays"], work["kin"]
    n, npv = work["n"], work["npv"]

    def dev(a):
        return torch.as_tensor(a, device=device)

    soa_np, num = lc.pack_lines_soa(arrays, chunk)
    s_idx = arrays["s_idx"].astype(np.int64)
    e_idx = arrays["e_idx"].astype(np.int64)
    w_start, w_n = lc.tile_line_ranges(s_idx, e_idx, n, tile, chunk)
    core_w = core_halfwidth(kin, npv, CUT_OFF)
    center = np.rint(arrays["c_int"]).astype(np.int64)
    c_start, c_n = lc.tile_line_ranges(np.maximum(center - core_w, s_idx),
                                       np.minimum(center + core_w, e_idx), n,
                                       tile, chunk)
    cs, ce = lc.core_instance_windows(arrays, kin, n, npv, CUT_OFF)
    plans = {mode: lc.CorePlan(cs, ce, n, tile, sort_key=arrays["y"],
                               mode=mode)
             for mode in ("rows", "seg", "segmix")}
    params = {mode: dev(p.gather(arrays)) for mode, p in plans.items()}
    ymin = lc.group_min_y(params["rows"])
    rows = plans["rows"]
    soa = dev(soa_np)
    ws, wn, cst, cn = map(dev, (w_start, w_n, c_start, c_n))

    def wings():
        return lc.tile_pass(soa, ws, wn, n, tile, chunk, "wings")

    def core(mode):
        return lambda: plans[mode].core_pass(params[mode])

    stages = [
        ("wings", wings, int(w_n.sum()) * chunk),
        ("core-scalar",
         lambda: lc.tile_pass(soa, cst, cn, n, tile, chunk, "core"),
         int(c_n.sum()) * chunk),
        ("core-rows", core("rows"), rows.num_instances),
        ("core-rows-vmem",
         lambda: lc.rows_vmem_pass(params["rows"], ymin, rows.walk, n,
                                   tile),
         rows.num_instances),
        ("core-seg", core("seg"), plans["seg"].num_instances),
        ("core-segmix", core("segmix"), plans["segmix"].num_instances),
        ("two-pass", lambda: wings() + core("rows")(), None),
        ("two-pass-seg", lambda: wings() + core("seg")(), None)]

    stride = lc.pick_wings_stride(tile, int((e_idx - s_idx).max()) + 1)
    if stride is not None:
        checked = soa_np.copy()
        assign = np.clip(s_idx, 0, None) // stride
        checked[lc._PAD, :num] = assign.astype(np.float32)
        checked[lc._PAD, num:] = -1.0
        st, nc = lc.strided_line_ranges(assign, (n - 1) // stride + 1)
        checked, st, nc = map(dev, (checked, st, nc))
        plan = lc.make_device_plan(arrays, kin, n, npv, CUT_OFF, tile=tile,
                                   chunk=chunk, device=device)

        def wings_checked():
            return lc.wings_strided_checked_pass(checked, st, nc, n, tile,
                                                 stride)

        stages += [
            (f"wings-strided-checked[{stride}]", wings_checked,
             int(nc.sum()) * lc.STRIDED_CHUNK),
            (f"wings-strided[{stride}]", plan.wings_pass,
             int(plan.w_n.sum()) * lc.STRIDED_CHUNK),
            ("two-pass-strided",
             lambda: wings_checked() + core("seg")(), None)]
    return stages


def run(num_lines=300000, reps=10, only=None, work=None):
    """Times every stage (or those named in ``only``) on the CUDA card and
    prints one line each; returns [(name, ms, evaluations/s)]."""
    require_cuda("kernel_microbench")
    work = work or headline_workload(num_lines)
    evals = masked_evals(work)
    print(f"kernel_microbench on {card()}: {work['keep']} lines kept, "
          f"{work['n']} points, {evals} masked line-point evaluations per "
          f"spectrum, {reps} warm reps", flush=True)
    records = []
    for name, fn, visits in build_stages(work, "cuda"):
        if only and name.split("[")[0] not in only:
            continue
        ms = device_ms(fn, reps)
        rate = evals / (ms / 1e3)
        line = f"  {name:28s} {ms:10.4f} ms/spectrum  {rate:.4e} evals/s"
        if visits:
            line += f"  ({visits} line-tile visits / instance slots)"
        print(line, flush=True)
        records.append((name, ms, rate))
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lines", type=int, default=300000)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--only", default=None,
                        help="comma-separated stage names (no [stride])")
    args = parser.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    return run_main("kernel_microbench", run, args.lines, args.reps, only)


if __name__ == "__main__":
    raise SystemExit(main())
