"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

    python3 lblbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (``setup_s``) runs from the start of the process to the start of the
window: the imports, the line lists made from the seed and ingested into a
database under ``TMPDIR``, and ``WARM_CALLS`` requests (the first run in a
checkout also builds the program's kernels there, under ``build/``).  The
window is a closed loop of one client: requests back to back, each over
another atmosphere drawn from the seed and its index, from the first timed
call to the end of the call in flight when ``--seconds`` is up.  After
each call the harness reads the output at the request's checked points.
With ``--trace 1`` the window runs under ``torch.profiler`` for at most
``TRACE_SECONDS`` and the run reports the per-layer metrics; with
``--trace 0`` the end-to-end metrics.

After the window (and after the peak device memory is read and the
program's objects are freed) the plain reference computes the checked
points of ``inputs.CHECKED_CALLS`` calls drawn from the seed, each over its
own atmosphere, in float64 on the device, with the reference's pedestal
taken out where the configuration's ``remove_pedestal`` states it, and
the run compares them with what the calls returned (``judge``).  Standard
error ends with each compared number beside its limit; standard output
ends with the result line.
"""
import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import inputs as inputs_mod
from . import spec as spec_mod
from . import trace as trace_mod
from .system import System

ROOT = Path(__file__).resolve().parents[2]
TRACE_SECONDS = 5.0
# Requests made in set-up, before the window: the first builds the
# Database's shared lines pipeline and every kernel a request runs.
WARM_CALLS = 1
# Modules no process of the benchmark may hold: JAX and the JAX package,
# by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "pylbl_tpu")
# Build and kernel caches of the program and of torch, at fixed paths in
# the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/lblbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/lblbench/triton"}


def forbidden_modules():
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_caches(root):
    for key, rel in CACHES.items():
        os.environ[key] = str(Path(root) / rel)


def judge(got, ref, limits):
    """(checks, failed calls): ``rel_err``, the largest relative gap of a
    checked call's point from the reference, with its limit
    (``limits["rel_err"]``), and the number of checked calls with a point
    beyond it.  ``got`` holds one array a checked call, ``ref`` one
    (reference, reference before the pedestal) pair.  The gap is over the
    reference, which has to be finite and positive at every checked point.
    With ``limits["rel_err_floor"]`` (phi) it is over the larger of
    |reference| and phi x the reference before the pedestal, which then has
    to be finite and positive: the float32 error of the program's line
    field scales with the field before the pedestal is taken out, not with
    what is left after it."""
    floor = limits.get("rel_err_floor")
    worst, floored, points = [], 0, 0
    for g, (r, r0) in zip(got, ref):
        base = r if floor is None else r0
        if not (np.isfinite(base).all() and (base > 0).all()
                and np.isfinite(r).all()):
            raise RuntimeError("the reference is not finite and positive "
                               "at every checked point")
        scale = r
        if floor is not None:
            scale = np.maximum(np.abs(r), floor * r0)
            floored += int((floor * r0 > np.abs(r)).sum())
            points += r.size
        rel = np.abs(np.asarray(g, np.float64) - r) / scale
        worst.append(float(np.where(np.isfinite(rel), rel, np.inf).max()))
    if floor is not None:
        print(f"lblbench: {floor!r} x the reference before the pedestal is "
              f"the divisor at {floored} of {points} checked points "
              f"({100.0 * floored / points:.4f}%)", file=sys.stderr)
    limit = limits["rel_err"]
    checks = {"rel_err": {"value": max(worst), "limit": limit}}
    return checks, sum(w > limit for w in worst)


class Run:
    """What the metric readers read: ``states_per_call``, ``calls`` (host
    (start, end) seconds), ``requests`` (each call's), ``window_s``,
    ``setup_s``, ``trace`` (a :class:`trace.Trace`, or None),
    ``lineshape`` (accepts a line-shape kernel's name) and ``work`` (the
    line-shape work of a traced call, the mean over them, counted from
    their inputs when first read)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)
        self._work = None

    @property
    def work(self):
        if self._work is None:
            from . import counting
            each = [counting.work(self.config, self.inputs.lines,
                                  r.atmosphere, self.inputs.grid, self.device)
                    for r in self.requests[:self.trace.calls]]
            self._work = {k: sum(w[k] for w in each) / len(each)
                          for k in ("operations", "bytes", "seconds")}
        return self._work


def window(system, inputs, seconds, traced):
    """The measured window: (calls, requests, samples, trace or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    calls, requests, samples = [], [], []
    with (profile(activities=activities) if traced
          else contextlib.nullcontext()) as prof:
        start = time.perf_counter()
        while True:
            request = inputs.request(WARM_CALLS + len(calls))
            c0 = time.perf_counter()
            with record_function(trace_mod.CALL):
                out = system(request)
            c1 = time.perf_counter()
            with record_function(trace_mod.BETWEEN):
                samples.append(out[request.state, request.point])
            del out
            calls.append((c0, c1))
            requests.append(request)
            if c1 - start >= seconds:
                break
    return calls, requests, samples, (trace_mod.from_profile(prof, len(calls))
                                      if traced else None)


def run_cell(root, cell, seed, seconds, traced, device, t_start,
             system_factory=System, check=judge):
    """Runs the cell and returns the result dict (the result line's keys,
    ``checks`` last); ``check`` compares as :func:`judge` does."""
    import torch

    from ..reference import lbl

    config = cell.config
    marks = [("imports", time.perf_counter())]
    inputs = inputs_mod.make(config, seed)
    marks.append(("inputs", time.perf_counter()))
    if traced:
        seconds = min(seconds, TRACE_SECONDS)
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="lblbench-") as work:
        system = system_factory(config, cell.traffic, inputs, Path(work),
                                device)
        marks.append(("system", time.perf_counter()))
        for k in range(WARM_CALLS):
            system(inputs.request(k))
            marks.append((f"warm call {k + 1}", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        print(f"lblbench: set-up {setup_s:.3f} s: " + ", ".join(
            f"{name} {end - start:.3f} s" for (_, start), (name, end)
            in zip([("start", t_start)] + marks[:-1], marks)),
            file=sys.stderr)
        calls, requests, samples, trace = window(system, inputs, seconds,
                                                 traced)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        system.close()
        del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_start = time.perf_counter()
    checked = inputs.checked(len(calls))
    ref = lbl.totals(config, inputs.lines,
                     [(requests[i].atmosphere, requests[i].state,
                       requests[i].point) for i in checked],
                     inputs.grid, "float64", device,
                     spec_mod.remove_pedestal(config))
    window_s = calls[-1][1] - calls[0][0]
    print(f"lblbench: {len(calls)} calls in {window_s:.3f} s, reference "
          f"of {len(checked)} calls {time.perf_counter() - ref_start:.3f} s",
          file=sys.stderr)
    checks, failed = check([samples[i] for i in checked], ref, cell.limits)
    correct = failed == 0
    run = Run(states_per_call=requests[0].atmosphere.num_states, calls=calls,
              requests=requests, window_s=window_s, setup_s=setup_s,
              trace=trace, config=config, inputs=inputs, device=device,
              lineshape=spec_mod.kernel_matcher(
                  spec_mod.kernel_names(root, "line-shape kernels")))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec_mod.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    return result


def parse(argv):
    parser = argparse.ArgumentParser(prog="lblbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    set_caches(ROOT)
    try:
        cell = spec_mod.cell(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"lblbench: no cell {args.workload!r} ({exc})", file=sys.stderr)
        return 2
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"lblbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{cards} found", file=sys.stderr)
        return 3
    print(f"lblbench: {args.workload} seed {args.seed}, "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    result = run_cell(ROOT, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"lblbench: the process holds {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
