"""Benchmark of the port: Voigt line-summation throughput on one CUDA card.

The counterpart of the JAX package's ``bench.py``, run as::

    python -m pylbl_tpu_torch bench
    python -m pylbl_tpu_torch.bench

It takes the JAX bench's workloads, widths and denominators: the
300,000-line synthetic H2O list (seed 1) on the 1-5000 cm-1 grid at 0.1
cm-1 (50,000 points), surface layer, counted in masked line-point
evaluations (kept lines x ((2 x 25 + 1) x n_per_v + 1) per layer; each
line covers a (2 x cut_off + 1) cm-1 window), with the line constants on
the card.  Stages, one after another in this process so that nothing
shares the card with a timed section:

- ``headline``: the single-layer device plan (``make_device_plan``,
  strided wings + mixed-slot core), the headline rate;
- ``batched_4layer``: the single-gas batched pipeline over 4 layers (220-
  300 K, 5000-98388 Pa);
- ``multigas_7gas``: the stacked pipeline over 7 gases (420,000 lines),
  4 layers, vmr 1e-4;
- ``config5``: 7 gases x 499,900 points (0.01 cm-1) x 16 layers, the
  density-weighted lines (no pedestal, no continua) in blocks of 4
  streamed to a file (h5py's ``StreamingWriter`` where h5py imports, else
  a ``.npy`` file), block b + 1 dispatched before block b is fetched;
- ``sharded_1chip``: the line-sharded step on a (1, 1) mesh of a one-rank
  NCCL group made and destroyed here;
- ``scaling``: ``python -m pylbl_tpu_torch.tools.bench_scaling`` as a
  subprocess, after the others (its gloo ranks share the card).

Timing: CUDA events around ``reps`` warm calls after one warm-up call and
a synchronize (tools ``device_ms``), with the inputs already on the card.
A sample is valid when it is positive and its rate lies in the band
[``RATE_LO``, the stage's bound rate x ``BAND_MARGIN``]; an invalid sample
is measured again, at most ``TRIES`` samples in all, and the stage reports
the median of up to three valid ones.  With none valid it reports the
median of what it measured under ``"method": "invalid (implausible)"``:
no number is ever clamped.  Each stage records its launches of each
kernel (``lineshape_cuda.LAUNCHES``), its peak device memory and the
sites of the host syncs in one call (torch's sync debug mode).

Parity: against the reference-C oracle of the repository's tests where it
imports and reports itself available (else null), and
``max_rel_err_vs_float64``: the same stage through the plain path in
float64 on the card, on the same inputs (floor 1e-6 of each spectrum's
maximum).

Output: three JSON lines, the provisional headline line, the full record
(with the card's ``nvidia-smi`` name and power limit and the torch, CUDA
and nvcc versions) and the compact line last.  Exit code 0; 1 when a
stage failed (its entry in the record reads ``"error: ..."``); 2 without
a CUDA card (there is no CPU fallback).  The stage functions take the
device and the sizes, so the tests drive them on the CPU at a small size.
"""
import argparse
import collections
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from .database.fixtures import synthetic_line_pack
from .ops import lineshape_cuda as lc
from .ops.lineshape import prepare_kernel_arrays
from .tools import (CUT_OFF, OPS_LORENTZ, PEAK_OPS, SURFACE, NoCudaError,
                    card, core_ops,
                    device_ms, headline_pack, layer_workload, require_cuda,
                    tile_ops, window_evals)

PACKAGE = Path(__file__).resolve().parent
TEMPERATURE, PRESSURE, VMR = SURFACE
# The reference C single-core rate on the headline workload, pinned in the
# JAX package's BASELINE.md (a host CPU measurement): vs_baseline divides
# by it.
PINNED_C_EVALS_PER_S = 4.68e8
RATE_LO = PINNED_C_EVALS_PER_S * 0.1
# The band's top is taken from the card: a stage's masked evaluations over
# the time its operations (tools.tile_ops + tools.core_ops, as chip_smoke.py
# counts them for its bounds) take at 67 TFLOP/s, the FP32 peak of the
# NVIDIA H100 80GB HBM3 at 700 W (tools.PEAK_OPS), 5% above.  The JAX
# bench's top, 3000 x the pinned C rate (1.404e12/s, ~3x a TPU v5e's speed
# of light), lies below the H100 headline's own bound (~7.5e12/s).
BAND_MARGIN = 1.05
TRIES = 5
SAMPLES = 3
METHOD = "cuda-events"
INVALID = "invalid (implausible)"
GASES = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]


def build_workload(num_lines=300000):
    """The headline line list and grid (JAX bench ``build_workload``)."""
    return headline_pack(num_lines), np.arange(1.0, 5000.0, 0.1)


def multigas_packs(num_lines=300000, other_lines=20000):
    """The seven gases of JAX bench ``multigas_packs``: H2O with
    ``num_lines`` lines, the others with ``other_lines``."""
    return {name: synthetic_line_pack(
        name, num_lines=num_lines if name == "H2O" else other_lines,
        nu_min=0.5, nu_max=5100.0, seed=g + 1,
        band_centers=(150.0 + 400 * g, 1600.0, 3700.0))
        for g, name in enumerate(GASES)}


def layers(num_layers, num_gases=None):
    """The JAX bench's float32 layers: T 220-300 K, p 5000-98388 Pa, vmr
    the headline's (one gas) or 1e-4 per gas."""
    t = np.linspace(220.0, 300.0, num_layers).astype(np.float32)
    p = np.linspace(5000.0, 98388.0, num_layers).astype(np.float32)
    x = np.full(num_layers, VMR, np.float32) if num_gases is None \
        else np.full((num_layers, num_gases), 1e-4, np.float32)
    return t, p, x


def band_top(evals, ops):
    """The highest plausible rate: ``evals`` over the time ``ops``
    operations take at the card's FP32 peak, times ``BAND_MARGIN``."""
    return BAND_MARGIN * PEAK_OPS * evals / ops


def guarded_ms(fn, reps, evals, rate_hi, timer=device_ms):
    """(milliseconds per call, method) of ``fn``: ``timer(fn, reps)``
    samples until ``SAMPLES`` are valid (positive, rate in [RATE_LO,
    rate_hi]) or ``TRIES`` were taken; the median of the valid ones, or of
    all under ``INVALID`` when none is.  Never clamped."""
    taken, valid = [], []
    while len(taken) < TRIES and len(valid) < SAMPLES:
        ms = timer(fn, reps)
        taken.append(ms)
        if ms > 0 and RATE_LO <= evals / (ms / 1e3) <= rate_hi:
            valid.append(ms)
    if valid:
        return float(np.median(valid)), METHOD
    return float(np.median(taken)), INVALID


def lines_ops(soa, n_out, core):
    """(operations, the wings' operations) of one call of the prepacked
    wings (tools.tile_ops) and the segment core (tools.core_ops)."""
    wings = tile_ops(soa, n_out, "pre")
    return wings + core_ops(core), wings


def measure(fn, reps, evals, points, ops, timer=device_ms):
    """A stage's timed record: rates per second of ``evals`` and
    ``points`` per call, the guard's method, the operations' bound and
    the band's top; ``ops`` from :func:`lines_ops`, whose wings'
    operations give the record's Lorentzian terms (``wings_terms``)."""
    ops, wings = ops
    rate_hi = band_top(evals, ops)
    ms, method = guarded_ms(fn, reps, evals, rate_hi, timer)
    return {"evals_per_s": evals / (ms / 1e3),
            "points_per_s": points / (ms / 1e3), "ms_per_call": ms,
            "method": method, "evals_per_call": int(evals),
            "points_per_call": int(points), "operations": ops,
            "wings_terms": wings / OPS_LORENTZ,
            "bound_ms": ops / PEAK_OPS * 1e3, "rate_hi": rate_hi}


def max_rel_err(got, want, floor=1e-6):
    """max |got - want| / max(|want|, floor x the spectrum's max |want|)
    over every spectrum (last axis) of ``want``."""
    got = got.double().reshape(-1, got.shape[-1])
    want = want.double().reshape(-1, want.shape[-1])
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    den = torch.maximum(want.abs(), floor * scale)
    return float(((got - want).abs() / den).max())


def host_syncs(fn, device):
    """{site: count} of the calls in one ``fn()`` that make the host wait
    for the card (torch's sync debug mode); None off the card."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return dict(sites)


def on_device(arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


# --------------------------------------------------------------------------
# The reference-C oracle (tests/oracle; absent on the hosts here).
# --------------------------------------------------------------------------

def load_oracle():
    """The repository's ``tests/oracle`` module when it imports and reports
    itself available, else None."""
    path = PACKAGE.parent / "tests" / "oracle" / "__init__.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location("oracle", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except ImportError:
        return None
    return module if module.available() else None


def oracle_max_rel(oracle, grid, cases):
    """max over the (pack, t, p, x, spectrum) ``cases`` (an iterable, not
    read without an oracle) of |spectrum - oracle| / max(oracle), or None
    without an oracle."""
    if oracle is None:
        return None
    from .models.lines import internal_grid
    v0, vn, n_per_v, _ = internal_grid(grid)
    errs = []
    for pack, t, p, x, got in cases:
        want = oracle.absorption(pack, float(t), float(p), float(x), v0, vn,
                                 n_per_v, cut_off=CUT_OFF)
        errs.append(np.abs(np.asarray(got, np.float64) - want).max()
                    / max(want.max(), 1e-300))
    return float(np.max(errs))


def reference_rate(oracle, pack, grid):
    """(rate, spectrum) of the reference C on the headline workload, min of
    5, or (None, None) without an oracle."""
    if oracle is None:
        return None, None
    from .models.lines import internal_grid
    v0, vn, n_per_v, _ = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, CUT_OFF)
    best, expected = np.inf, None
    for _ in range(5):
        t0 = time.perf_counter()
        expected = oracle.absorption(pack, TEMPERATURE, PRESSURE, VMR, v0, vn,
                                     n_per_v, cut_off=CUT_OFF)
        best = min(best, time.perf_counter() - t0)
    return window_evals(keep, n_per_v) / best, expected


# --------------------------------------------------------------------------
# Stages: each returns (record, output tensor).
# --------------------------------------------------------------------------

def headline(pack, grid, device="cuda", timer=device_ms, reps=30):
    """The headline layer through the single-layer device plan."""
    device = torch.device(device)
    work = layer_workload(pack, grid)
    n, npv = work["n"], work["npv"]
    plan = lc.make_device_plan(work["arrays"], work["kin"], n, npv, CUT_OFF,
                               device=device)

    def run():
        return plan.run_with(plan.soa, plan.groups)

    result = measure(run, reps, window_evals(work["keep"], npv), n,
                     lines_ops(plan.soa, n, plan.groups), timer)
    out = run()
    plan64 = lc.make_device_plan(
        prepare_kernel_arrays(work["kin"], npv, np.float64), work["kin"], n,
        npv, CUT_OFF, device=device, plain=True)
    result.update(lines_kept=int(work["keep"]), host_syncs=host_syncs(
        run, device), max_rel_err_vs_float64=max_rel_err(out, plan64()))
    return result, out


def batched(pack, grid, num_layers=4, device="cuda", timer=device_ms,
            reps=12, oracle=None):
    """The single-gas batched pipeline over ``num_layers`` layers."""
    from .parallel.lines import derive_envelope, make_batched_fn
    device = torch.device(device)
    t, p, x = layers(num_layers)
    envelope = derive_envelope(t, p)
    fn = make_batched_fn(pack, grid, t_max=envelope[0],
                         p_max_atm=envelope[1], device=device)
    dev = on_device((t, p, x), device)
    static = fn.stage.static
    n = static["num_points"]

    def run():
        return fn.inner(*dev)

    soa, core = fn.stage.assemble(*dev)
    result = measure(run, reps, num_layers * window_evals(
        static["num_lines"], static["n_per_v"]), num_layers * n,
        lines_ops(soa, fn.stage.n_out, core), timer)
    out = run()
    fn64 = make_batched_fn(pack, grid, t_max=envelope[0],
                           p_max_atm=envelope[1], backend="plain",
                           dtype=torch.float64, device=device)
    result.update(host_syncs=host_syncs(run, device),
                  max_rel_err_vs_float64=max_rel_err(
                      out, fn64.inner(*(a.double() for a in dev))),
                  max_rel_err_vs_oracle=oracle_max_rel(
                      oracle, grid, ((pack, t[i], p[i], x[i], out[i].cpu())
                                     for i in range(num_layers))))
    return result, out


def multigas(packs, grid, num_layers=4, device="cuda", timer=device_ms,
             reps=12, oracle=None):
    """The stacked all-gases pipeline over ``num_layers`` layers in one
    launch per kernel."""
    from .parallel.lines import derive_envelope, make_multigas_batched_fn
    device = torch.device(device)
    t, p, x = layers(num_layers, len(packs))
    envelope = derive_envelope(t, p)
    fn = make_multigas_batched_fn(packs, grid, t_max=envelope[0],
                                  p_max_atm=envelope[1], device=device)
    fn.check_envelope(t, p)
    dev = on_device((t, p, x), device)
    static = fn.stage.static

    def run():
        return fn.inner(*dev)

    soa, core = fn.stage.assemble(*dev)
    result = measure(run, reps, num_layers * window_evals(
        static["num_lines"], static["n_per_v"]),
        num_layers * len(packs) * static["num_points"],
        lines_ops(soa, fn.stage.n_out, core), timer)
    out = run()
    fn64 = make_multigas_batched_fn(packs, grid, t_max=envelope[0],
                                    p_max_atm=envelope[1], backend="plain",
                                    dtype=torch.float64, device=device)
    result.update(gases=len(packs), total_lines=int(static["num_lines"]),
                  host_syncs=host_syncs(run, device),
                  max_rel_err_vs_float64=max_rel_err(
                      out, fn64.inner(*(a.double() for a in dev))),
                  max_rel_err_vs_oracle=oracle_max_rel(
                      oracle, grid, ((pk, t[i], p[i], x[i, g],
                                      out[i, g].cpu())
                                     for g, pk in enumerate(packs.values())
                                     for i in range(num_layers))))
    return result, out


class NpyWriter:
    """Streamed states as one [num_states, points] float64 ``.npy`` file
    (``np.lib.format.open_memmap``), for a host without h5py; takes
    ``write_state`` as :class:`~pylbl_tpu_torch.utils.streaming.
    StreamingWriter` does."""

    def __init__(self, path, num_states, grid, variables):
        (self.variable,) = variables
        self._data = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float64,
            shape=(num_states, len(grid)))

    def write_state(self, index, values):
        self._data[index] = values[self.variable]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        del self._data


def open_writer(stem, num_states, grid):
    """(writer, path, name): h5py's StreamingWriter at ``stem``.h5 where
    h5py imports, else an :class:`NpyWriter` at ``stem``.npy."""
    variables = ["absorption_total"]
    try:
        import h5py  # noqa: F401
    except ImportError:
        path = stem.with_suffix(".npy")
        return NpyWriter(path, num_states, grid, variables), path, "npy"
    from .utils.streaming import StreamingWriter
    path = stem.with_suffix(".h5")
    return StreamingWriter(path, num_states, grid, variables, mode="w"), \
        path, "StreamingWriter (h5py)"


def config5(packs, grid, directory, num_layers=16, block=4, device="cuda",
            timer=device_ms, reps=3):
    """Config 5: the stacked density-weighted lines over ``num_layers``
    layers in blocks of ``block``, streamed into ``directory`` twice (cold,
    then warm: the record is the warm pass's, with the cold wall), and the
    CUDA-event rate of one block's ``fn.inner``.  Returns (record, the
    warm pass's file)."""
    from .parallel.lines import derive_envelope, make_multigas_batched_fn
    device = torch.device(device)
    t, p, x = layers(num_layers, len(packs))
    envelope = derive_envelope(t, p)
    fn = make_multigas_batched_fn(packs, grid, t_max=envelope[0],
                                  p_max_atm=envelope[1], device=device)
    fn.check_envelope(t, p)
    dev = on_device((t, p, x), device)
    static = fn.stage.static
    nblocks = num_layers // block
    copies = torch.cuda.Stream(device) if device.type == "cuda" else None

    def dispatch(b):
        """Block b's totals on their way to the host: on the card a pinned
        copy on a side stream after the block's kernels, so block b + 1
        computes while block b is copied and written.  Returns a fetch()
        giving the host array."""
        out = fn.inner_total(*(a[b * block:(b + 1) * block] for a in dev))
        if copies is None:
            return out.numpy
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        copies.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(copies):
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        out.record_stream(copies)
        return lambda: (done.synchronize(), host.numpy())[1]

    def stream(label):
        writer, path, kind = open_writer(Path(directory) / f"config5_{label}",
                                         num_layers, grid)
        compute_s = write_s = 0.0
        t0 = time.perf_counter()
        with writer:
            fetch = dispatch(0)
            for b in range(nblocks):
                tc = time.perf_counter()
                nxt = dispatch(b + 1) if b + 1 < nblocks else None
                beta = fetch().astype(np.float64)
                compute_s += time.perf_counter() - tc
                fetch = nxt
                tw = time.perf_counter()
                for i in range(block):
                    # The internal grid cut to the user grid (the
                    # reference's k[:grid.size]).
                    writer.write_state(b * block + i, {
                        "absorption_total": beta[i, :grid.size]})
                write_s += time.perf_counter() - tw
        wall = time.perf_counter() - t0
        evals = num_layers * window_evals(static["num_lines"],
                                          static["n_per_v"])
        return {"grid_points": int(grid.size), "layers": num_layers,
                "gases": len(packs), "total_lines": int(static["num_lines"]),
                "wall_s": wall, "compute_fetch_s": compute_s,
                "write_s": write_s,
                "points_per_s": num_layers * grid.size / wall,
                "evals_per_s": evals / wall, "evals_per_pass": int(evals),
                "bytes_written": path.stat().st_size, "writer": kind}, path

    first = [a[:block] for a in dev]
    fn.inner_total(*first)               # warm, outside the timed passes
    cold, _ = stream("cold")
    result, path = stream("warm")
    result["cold_wall_s"] = cold["wall_s"]
    soa, core = fn.stage.assemble(*first)
    device_rate = measure(
        lambda: fn.inner(*first), reps,
        block * window_evals(static["num_lines"], static["n_per_v"]),
        block * len(packs) * static["num_points"],
        lines_ops(soa, fn.stage.n_out, core), timer)
    result.update(device_evals_per_s=device_rate["evals_per_s"],
                  device_method=device_rate["method"],
                  device_ms_per_block=device_rate["ms_per_call"],
                  evals_per_block=device_rate["evals_per_call"],
                  device_bound_ms_per_block=device_rate["bound_ms"],
                  device_wings_terms_per_block=device_rate["wings_terms"],
                  host_syncs=host_syncs(lambda: dispatch(0), device))
    return result, path


def sharded(pack, grid, num_layers=4, device="cuda", timer=device_ms,
            reps=5):
    """The line-sharded step (balanced, the kernel branch) on a (1, 1) mesh
    of a one-rank group that this stage makes and destroys (NCCL on the
    card, gloo on the CPU)."""
    import torch.distributed as dist

    from .parallel import distributed, launch
    from .parallel.mesh import make_mesh
    from .parallel.shard_plans import shard_line_pack
    from .parallel.sharded import make_lines_sharded_step
    device = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("sharded_1chip makes its own one-rank process "
                           "group, and one is already initialized")
    distributed.initialize(
        init_method=f"tcp://localhost:{launch.free_port()}", world_size=1,
        rank=0, backend="nccl" if device.type == "cuda" else "gloo")
    try:
        mesh = make_mesh(batch=1, spec=1, device=device)
        blocks, q_table, static, info = shard_line_pack(pack, grid, 1,
                                                        mode="balanced")
        step = make_lines_sharded_step(static, info, mesh, blocks=blocks,
                                       q_table=q_table,
                                       weight_density=False,
                                       backend="kernel")
        if step.backend != "kernel":
            raise RuntimeError(f"the sharded step took the {step.backend} "
                               "branch (no stride fits)")
        t, p, x = layers(num_layers)

        def run():
            return step(t, p, x)

        stage, soa, core = step.kernel_inputs(t, p, x)
        n = static["num_points"]
        result = measure(run, reps, num_layers * window_evals(
            static["num_lines"], static["n_per_v"]), num_layers * n,
            lines_ops(soa, stage.n_out, core), timer)
        out = step.gather(run())[:, :n]
        result.update(backend=step.backend, transport=mesh.transport,
                      host_syncs=host_syncs(run, device))
        return result, out
    finally:
        dist.destroy_process_group()


def scaling(timeout=900):
    """The port's bench_scaling tool in a subprocess: its report."""
    done = subprocess.run(
        [sys.executable, "-m", "pylbl_tpu_torch.tools.bench_scaling"],
        capture_output=True, text=True, timeout=timeout,
        cwd=PACKAGE.parent)
    if done.returncode:
        raise RuntimeError(f"bench_scaling exited {done.returncode}: "
                           f"{done.stderr[-500:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# The run and its output.
# --------------------------------------------------------------------------

def tracked(stage, device):
    """``stage()``'s record with its wall, its launches of each kernel and
    its peak device memory."""
    before = dict(lc.LAUNCHES)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    result = stage()
    result["stage_wall_s"] = time.perf_counter() - t0
    result["launches"] = {k: v - before[k] for k, v in lc.LAUNCHES.items()
                          if v != before[k]}
    if device.type == "cuda":
        result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return result


def _stage_rate(value):
    """evals/s of a stage record, or its error string, or None."""
    if isinstance(value, dict):
        return value.get("evals_per_s")
    if isinstance(value, str):
        return value[:60]
    return None


def compact_summary(rate, vs_baseline, extra):
    """The short headline record, printed last."""
    par = extra.get("parity")
    scal = extra.get("scaling")
    return {
        "metric": "voigt_line_point_evals_per_s",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": vs_baseline,
        "parity_max_rel": par.get("max_rel_err") if isinstance(par, dict)
        else None,
        "stages": {k: _stage_rate(extra.get(full)) for k, full in
                   (("batched", "batched_4layer"),
                    ("multigas", "multigas_7gas"),
                    ("config5", "config5"),
                    ("sharded_1chip", "sharded_1chip"))},
        "scaling_eff_at_4": scal.get("efficiency_at_4")
        if isinstance(scal, dict) else None,
    }


def report(headline_stage, stages, extra, device):
    """Runs ``headline_stage`` and then each of ``stages`` (name ->
    callable) in order, prints the provisional headline line, the full
    record and the compact line last, and returns the exit code: 1 when a
    stage raised (its entry reads "error: ..."), else 0."""
    result = tracked(headline_stage, device)
    rate = result["evals_per_s"]
    vs_baseline = rate / PINNED_C_EVALS_PER_S
    extra.update(headline=result,
                 single_layer_points_per_s=result["points_per_s"],
                 pinned_c_evals_per_s=PINNED_C_EVALS_PER_S)
    if not isinstance(extra.get("parity"), dict):
        extra["parity"] = {"max_rel_err": result["max_rel_err_vs_float64"],
                           "reference": "float64 plain path on the card"}
    provisional = compact_summary(rate, vs_baseline, extra)
    provisional["stages"] = "pending"
    print(json.dumps(provisional), flush=True)
    failed = False
    for key, stage in stages.items():
        try:
            extra[key] = tracked(stage, device)
        except Exception as exc:  # the headline and the record still print
            extra[key] = f"error: {type(exc).__name__}: {exc}"
            failed = True
    print(json.dumps({"metric": "voigt_line_point_evals_per_s",
                      "value": rate, "unit": "evals/s",
                      "vs_baseline": vs_baseline, "extra": extra}))
    print(json.dumps(compact_summary(rate, vs_baseline, extra)), flush=True)
    return 1 if failed else 0


def environment(device):
    """The card, the versions and the build time of the CUDA kernels."""
    nvcc = subprocess.run([lc.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lc.cuda_library()
    return {"card": card(), "device": torch.cuda.get_device_name(device),
            "versions": {"python": sys.version.split()[0],
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda,
                         "nvcc": nvcc.splitlines()[-1]},
            "build_s": time.perf_counter() - t0}


def main(argv=None):
    argparse.ArgumentParser(prog="pylbl_tpu_torch bench",
                            description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    try:
        require_cuda("bench")
    except NoCudaError as exc:
        print(f"bench: {exc}", flush=True)
        return 2
    from .runtime.device import resolve_device
    device = resolve_device("cuda")
    extra = environment(device)
    pack, grid = build_workload()
    packs = multigas_packs()
    oracle = load_oracle()
    ref_rate, expected = reference_rate(oracle, pack, grid)
    extra["reference_c_evals_per_s_live"] = ref_rate

    def headline_stage():
        result, out = headline(pack, grid, device=device)
        if expected is not None:
            err = np.abs(out.cpu().numpy().astype(np.float64) - expected)
            extra["parity"] = {"max_abs_err": float(err.max()),
                               "max_rel_err": float(err.max()
                                                    / expected.max()),
                               "workload_lines": int(pack.num_lines),
                               "reference": "reference C oracle"}
        return result

    with tempfile.TemporaryDirectory(prefix="pylbl_bench_") as directory:
        stages = {
            "batched_4layer": lambda: batched(pack, grid, device=device,
                                              oracle=oracle)[0],
            "multigas_7gas": lambda: multigas(packs, grid, device=device,
                                              oracle=oracle)[0],
            "config5": lambda: config5(packs, np.arange(1.0, 5000.0, 0.01),
                                       directory, device=device)[0],
            "sharded_1chip": lambda: sharded(pack, grid, device=device)[0],
            "scaling": scaling,
        }
        return report(headline_stage, stages, extra, device)


if __name__ == "__main__":
    sys.exit(main())
