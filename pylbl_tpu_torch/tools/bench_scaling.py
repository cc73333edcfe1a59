"""Scaling of the line-sharded step over spec ranks that share one card.

Counterpart of ``tools/bench_scaling.py``: runs
``parallel/sharded.py`` ``make_lines_sharded_step`` at spec = 1, 2, 4 (a
(1, spec) mesh of gloo ranks started by ``parallel/launch.py``, every
rank on this card) and reports per point:

- ``wall_s``: rank 0's host-clock time of one warm synchronized step call
  (mean over the reps).  The ranks share one card and one host, so it
  reflects the total work and the host transport, not per-device latency:
  nothing here measures scaling across cards;
- ``work_efficiency``: ideal per-rank lines (kept / spec) over the largest
  block (halo duplication, padding and load imbalance included), the
  per-device strong-scaling ceiling of the decomposition;
- ``max_abs_err`` / ``max_rel_err`` (of the maximum) of the float32
  result against the float64 plain path.

The workload is the JAX tool's: 20k-line synthetic H2O over 1-5000 cm-1
at 0.1, two layers.  Run on a CUDA card::

    python -m pylbl_tpu_torch.tools.bench_scaling [--mode all|balanced|
        halo|ring] [--reps R]

It prints one JSON line with the card; without CUDA it exits with code 2.
"""
import argparse
import json
import time

import numpy as np
import torch

from . import card, require_cuda, run_main
from ..database.fixtures import synthetic_line_pack

GRID = (1.0, 5000.0, 0.1)
CONDITIONS = (np.asarray([288.99, 227.74]), np.asarray([98388.0, 1032.0]),
              np.asarray([6.637074e-03, 4.763972e-06]))


def scaling_pack(num_lines=20000):
    return synthetic_line_pack(num_lines=num_lines, nu_min=0.5,
                               nu_max=5100.0, seed=1,
                               band_centers=(150.0, 1600.0, 3700.0, 500.0))


def _rank(num_lines, grid, spec, mode, reps, device):
    """One rank: the step built on a (1, spec) mesh, timed warm; rank 0
    returns the gathered result."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..parallel.shard_plans import shard_line_pack
    from ..parallel.sharded import make_lines_sharded_step

    mesh = make_mesh(batch=1, spec=spec, device=device)
    blocks, q_table, static, info = shard_line_pack(
        scaling_pack(num_lines), grid, spec, mode=mode)
    step = make_lines_sharded_step(static, info, mesh, blocks=blocks,
                                   q_table=q_table)
    slab = step(*CONDITIONS)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier()

    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        slab = step(*CONDITIONS)
    sync()
    wall = (time.perf_counter() - t0) / reps
    full = step.gather(slab)
    if mesh.rank:
        return None
    return {"wall_s": wall, "backend": step.backend, "info": info,
            "full": full[:, :static["num_points"]].cpu().numpy()}


def reference(num_lines, grid, device):
    """The float64 plain path's density-weighted spectra [2, points]."""
    from ..models.lines import Gas
    from ..spectroscopy import number_density

    gas = Gas(scaling_pack(num_lines), "H2O", device=device,
              dtype=torch.float64, backend="plain")
    return np.stack([
        number_density(t, p, x) * np.asarray(
            gas.absorption_coefficient(t, p, x, grid))
        for t, p, x in zip(*CONDITIONS)])


def measure(mode="balanced", specs=(1, 2, 4), reps=3, num_lines=20000,
            grid=GRID, device="cuda"):
    """One record per spec (a rank group each); runs on any device (the
    timings mean something on the card only)."""
    from ..models.lines import internal_grid
    from ..parallel import launch

    grid = np.arange(*grid)
    v0, vn, _, _ = internal_grid(grid)
    keep = scaling_pack(num_lines).compat_break_filter(v0, vn, 25)
    want = reference(num_lines, grid, device)
    results = []
    for spec in specs:
        out = launch.launch(_rank, spec, num_lines, grid, spec, mode, reps,
                            device, timeout=900, threads=0)
        err = float(np.abs(out["full"].astype(np.float64) - want).max())
        info = out["info"]
        results.append({
            "spec": spec, "backend": out["backend"],
            "wall_s": out["wall_s"],
            "points_per_s": want.size / out["wall_s"],
            "work_efficiency": keep / spec / max(info["block_len"], 1),
            "duplication": info["duplication"],
            "ring_steps": info["ring_steps"],
            "max_abs_err": err, "max_rel_err": err / float(want.max())})
    return results


def run(mode="all", reps=3):
    """Measures on the card and prints the report (one JSON line)."""
    require_cuda("bench_scaling")
    report = {"card": card(), "mode": mode}
    if mode == "all":
        report["scaling"] = results = measure("balanced", reps=reps)
        report["halo"] = measure("halo", specs=(2, 4), reps=reps)
        report["ring"] = measure("ring", specs=(2, 4), reps=reps)
    else:
        report["scaling"] = results = measure(mode, reps=reps)
    report["efficiency_at_4"] = results[-1]["work_efficiency"]
    report["note"] = ("ranks share one card and host over gloo: wall_s is "
                      "total work plus host transport, not scaling across "
                      "cards; work_efficiency = ideal lines per rank / "
                      "largest block")
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="all",
                        choices=["all", "balanced", "halo", "ring"])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    return run_main("bench_scaling", run, args.mode, args.reps)


if __name__ == "__main__":
    raise SystemExit(main())
