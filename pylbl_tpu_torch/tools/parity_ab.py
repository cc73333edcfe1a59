"""A/B parity of the single-layer formulations on the headline workload.

Counterpart of ``tools/parity_ab.py``: every (core_mode, wings_mode) pair
that tool runs, ("seg", None), ("seg", "tile"), ("seg", "seg") and
("rows", "tile"), plus the production ("segmix", None) and ("rows", None),
through ``make_device_plan`` in float32 on the card, each against the
port's float64 plain device plan on the same layer.  The JAX tool measures
against the reference C oracle (tests/oracle), which needs the reference
C sources; neither this repository nor the GPU host carries them, so the
float64 plain path is the reference here.  ``max_rel`` is max |err| over
the reference's maximum, as the JAX tool prints it.  Run on a CUDA card::

    python -m pylbl_tpu_torch.tools.parity_ab [--lines N]

Without CUDA it exits with code 2.
"""
import argparse
import time

import numpy as np
import torch

from . import (CUT_OFF, card, headline_workload, layer_workload,
               require_cuda, run_main)
from ..ops.lineshape_cuda import make_device_plan

PAIRS = (("seg", None), ("seg", "tile"), ("seg", "seg"), ("rows", "tile"),
         ("segmix", None), ("rows", None))


def compare(work, device, pairs=PAIRS):
    """Yields (core_mode, wings_mode, max_abs, max_rel, seconds) for each
    pair on ``device`` against the float64 plain device plan (on a CPU
    device the float32 plans run the plain versions too)."""
    ref_work = layer_workload(work["pack"], work["grid"], dtype=np.float64)
    ref = make_device_plan(ref_work["arrays"], ref_work["kin"], work["n"],
                           work["npv"], CUT_OFF, device=device,
                           plain=True)()
    scale = float(ref.abs().max())
    for core_mode, wings_mode in pairs:
        t0 = time.perf_counter()
        plan = make_device_plan(work["arrays"], work["kin"], work["n"],
                                work["npv"], CUT_OFF, core_mode=core_mode,
                                wings_mode=wings_mode, device=device)
        err = float((plan().double() - ref).abs().max())
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        yield (core_mode, wings_mode, err, err / scale,
               time.perf_counter() - t0)


def run(num_lines=300000, work=None):
    """Prints one line per pair on the CUDA card; returns the records of
    :func:`compare`."""
    require_cuda("parity_ab")
    work = work or headline_workload(num_lines)
    print(f"parity_ab on {card()}: {work['keep']} lines kept, {work['n']} "
          "points, float32 plans vs the float64 plain plan", flush=True)
    records = []
    for core_mode, wings_mode, err, rel, secs in compare(work, "cuda"):
        print(f"  core={core_mode!s:6s} wings={wings_mode!s:4s} "
              f"max_abs={err:.3e} max_rel={rel:.3e} ({secs:.2f} s with the "
              "plan build)", flush=True)
        records.append((core_mode, wings_mode, err, rel, secs))
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lines", type=int, default=300000)
    args = parser.parse_args(argv)
    return run_main("parity_ab", run, args.lines)


if __name__ == "__main__":
    raise SystemExit(main())
