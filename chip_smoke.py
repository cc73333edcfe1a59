#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU and checks it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card, nvcc (``/usr/local/cuda``) and g++; it builds the hand-written
kernels and the native pedestal scan from this checkout into ``build/``
and imports nothing of JAX or ``pylbl_tpu``.  Phases:

1. device and toolchain (card name and power limit from nvidia-smi);
2. build of the CUDA kernels and the native library;
3. main path at 0.1 cm-1: seven gases' synthetic line lists (H2O 300k
   lines, six gases x 20k, 0.5-5100 cm-1) in a port Database, a 16-layer
   column spanning the canonical test column, grid 1-5000 cm-1,
   ``Spectroscopy(..., device="cuda").compute_absorption("total")`` with
   MT-CKD continua and the pedestal removed;
4. main path at 0.01 cm-1 (splat wings): the same gases, 4 layers, grid
   1-1000 cm-1 (100k points per gas);
5. each kernel against its plain PyTorch version on inputs taken from
   phases 3 and 4 (2 layers), max rel diff below 5e-6, with both times;
6. the float32 main path against the plain path in float64 on the card,
   2 layers of phase 3, rel below 5e-4;
7. phase 3's call run twice gives bit-identical results.

Every check that fails exits non-zero.  The line before the last is the
kernel record (JSON), the last line is the device record (JSON).
"""
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
GASES = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]
STANDARD = {"H2O": "water_vapor", "CO2": "carbon_dioxide", "O3": "ozone",
            "N2O": "nitrous_oxide", "CO": "carbon_monoxide",
            "CH4": "methane", "O2": "oxygen", "N2": "nitrogen"}
# The canonical 4-layer test column (tests/conftest.py).
CANON_P = np.asarray([117.0, 1032.0, 11419.0, 98388.0])
CANON_T = np.asarray([269.01, 227.74, 203.37, 288.99])
CANON_VMR = {
    "H2O": [5.244536e-06, 4.763972e-06, 3.039952e-06, 6.637074e-03],
    "CO2": [0.00036, 0.00036, 0.00036, 0.00035999],
    "O3": [2.936688e-06, 7.415223e-06, 2.609510e-07, 6.859128e-08],
    "N2O": [1.050928e-08, 1.319584e-07, 2.895416e-07, 3.199949e-07],
    "CH4": [2.947482e-07, 8.817705e-07, 1.588336e-06, 1.700002e-06],
    "CO": [3.621464e-08, 1.761450e-08, 3.315927e-08, 1.482969e-07],
    "O2": [0.209, 0.209, 0.2090003, 0.208996],
    "N2": [0.78, 0.78, 0.78, 0.78],
}
# Kernel -> the TPU kernel it replaces.
KERNELS = {
    "wings_strided": "pylbl_tpu/ops/lineshape_pallas.py:2228",
    "core_segmix": "pylbl_tpu/ops/lineshape_pallas.py:1148",
    "wings_splat": "pylbl_tpu/ops/lineshape_pallas.py:1662",
}
KERNEL_TOL = 5e-6
PARITY_TOL = 5e-4


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def line_packs(fixtures):
    """The seven-gas synthetic line lists (bench.py multigas_packs)."""
    packs = {}
    for g, name in enumerate(GASES):
        packs[name] = fixtures.synthetic_line_pack(
            name, num_lines=300000 if name == "H2O" else 20000,
            nu_min=0.5, nu_max=5100.0, seed=g + 1,
            band_centers=(150.0 + 400 * g, 1600.0, 3700.0))
    return packs


def column(num_layers, Dataset):
    """A column of ``num_layers`` spanning the canonical one: pressure
    log-spaced 117-98388 Pa, temperature and mole fractions interpolated
    in log pressure."""
    p = np.geomspace(CANON_P[0], CANON_P[-1], num_layers)
    order = np.argsort(CANON_P)
    logp = np.log(CANON_P[order])
    t = np.interp(np.log(p), logp, CANON_T[order])
    data = {"p": (["layer"], p, {"standard_name": "air_pressure",
                                 "units": "Pa"}),
            "t": (["layer"], t, {"standard_name": "air_temperature",
                                 "units": "K"})}
    for name, values in CANON_VMR.items():
        x = np.interp(np.log(p), logp, np.asarray(values)[order])
        data[name.lower()] = (["layer"], x, {
            "standard_name": f"mole_fraction_of_{STANDARD[name]}_in_air",
            "units": "mol mol-1"})
    return Dataset(data_vars=data)


def sub_column(dataset, layers, Dataset):
    return Dataset(data_vars={
        name: (var.dims, var.data[layers], var.attrs)
        for name, var in dataset.data_vars.items()})


def timed_call(torch, fn):
    """(result, wall seconds, CUDA-event seconds) of one synchronized
    call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(stop) / 1e3


def kernel_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` launches after one
    warm-up, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_diff(got, want, floor):
    """max |got - want| / max(|want|, floor * max|want|), and max abs."""
    diff = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max())
    den = want.double().abs().clamp_min(max(scale * floor, 1e-300))
    return float((diff / den).max()), float(diff.max())


def total_of(result):
    return np.asarray(result["absorption"].data)


def phase_main(torch, P, db, dataset, grid, label):
    """One main-path call: returns (spectroscopy, total, seconds)."""
    spec = P.Spectroscopy(dataset, grid, db, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    result, wall, dev = timed_call(
        torch, lambda: spec.compute_absorption(output_format="total"))
    total = total_of(result)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: total {total.shape}, wall {wall:.3f} s "
          f"(CUDA events {dev:.3f} s), peak device memory {peak:.3f} GiB")
    return spec, total, wall, dev, peak


def stacked_fn(spec):
    (fn, _, _), = [v for v in spec._multigas_fns.values()
                   if v != "unstackable"]
    return fn


def breakdown(torch, spec, dataset):
    """Warm times of the stages of one main-path call, in call order."""
    (fn, remover, names), = [v for v in spec._multigas_fns.values()
                             if v != "unstackable"]
    t = np.asarray(dataset["t"].data)
    p = np.asarray(dataset["p"].data)
    vmr = {n: np.asarray(spec.atmosphere.gases[n].data, np.float64)
           for n in spec.atmosphere.gases}
    x = np.stack([vmr[n] for n in names], axis=1)
    (soa, core), assemble_s, _ = timed_call(
        torch, lambda: fn.assemble(t, p, x))
    _, wings_s, _ = timed_call(torch, lambda: fn.wings_pass(soa))
    _, core_s, _ = timed_call(torch, lambda: fn.core_pass(core))
    k = fn(t, p, x)
    profile = cProfile.Profile()
    _, ped_s, _ = timed_call(torch, lambda: profile.runcall(
        remover, k, t, p, x))

    def mechanisms():
        for name in spec.atmosphere.gases:
            cont_fns, xsec_fn = spec._device_mechanism_fns(name)
            for cont in cont_fns or ():
                cont(t, p, vmr)
            if xsec_fn is not None:
                xsec_fn(t, p)

    _, mech_s, _ = timed_call(torch, mechanisms)
    print(f"  stages (warm, s): assemble {assemble_s:.4f}, wings "
          f"{wings_s:.4f}, core {core_s:.4f}, pedestal {ped_s:.4f}, "
          f"continua {mech_s:.4f}")
    stats = pstats.Stats(profile, stream=sys.stdout)
    print("  pedestal stage, cumulative seconds by function:")
    stats.sort_stats("cumulative").print_stats(12)


def phase_kernels(torch, lc, fn, dataset, kernels, records):
    """Kernel vs plain on the pipeline's own inputs (first 2 layers)."""
    t = np.asarray(dataset["t"].data)[:2]
    p = np.asarray(dataset["p"].data)[:2]
    x = np.stack([np.asarray(dataset[n.lower()].data)[:2] for n in fn.names],
                 axis=1)
    soa, core = fn.assemble(t, p, x)
    for name in kernels:
        if name == "core_segmix":
            run, run_plain = (lambda: fn.core_pass(core),
                              lambda: fn.core_pass(core, plain=True))
        else:
            run, run_plain = (lambda: fn.wings_pass(soa),
                              lambda: fn.wings_pass(soa, plain=True))
        got = run()
        want = run_plain()
        torch.cuda.synchronize()
        rel, err = rel_diff(got, want, 1e-7)
        ms = kernel_ms(torch, run, 20)
        plain_ms = kernel_ms(torch, run_plain, 2)
        print(f"{name}: shape {tuple(got.shape)}, max rel {rel:.3e}, max "
              f"abs {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(rel < KERNEL_TOL, f"{name} within {KERNEL_TOL} of its plain "
              "version")
        records[name].update(max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=plain_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import pylbl_tpu_torch as P
        from pylbl_tpu_torch.database import fixtures
        from pylbl_tpu_torch.ops import lineshape_cuda as lc
        from pylbl_tpu_torch.runtime import build, native
    except ImportError as exc:
        print(f"chip_smoke: the pylbl_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or "pylbl_tpu" in sys.modules:
        print("chip_smoke: jax or pylbl_tpu was imported", file=sys.stderr)
        return 1

    # Phase 1: device and toolchain.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([lc.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc[-1]}")
    print(f"devices: {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(0)}")

    # Phase 2: build.
    t0 = time.perf_counter()
    lc.cuda_library()
    t1 = time.perf_counter()
    native.load()
    t2 = time.perf_counter()
    print(f"build: CUDA kernels {t1 - t0:.2f} s, native scan {t2 - t1:.2f} s")
    for line in build.BUILD_LOGS.get("liblineshape_cuda.so", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    records = {name: {"name": name, "route": "cuda",
                      "source": "pylbl_tpu_torch/csrc/lineshape.cu",
                      "replaces": replaces}
               for name, replaces in KERNELS.items()}
    WORK.mkdir(parents=True, exist_ok=True)
    db_path = WORK / "smoke.db"
    if db_path.exists():
        db_path.unlink()
    t0 = time.perf_counter()
    db = P.Database(db_path)
    for pack in line_packs(fixtures).values():
        db.ingest_line_pack(pack)
    print(f"database: {len(GASES)} gases ingested in "
          f"{time.perf_counter() - t0:.2f} s")

    # Phase 3: main path at 0.1 cm-1 (this call and phase 4's are the
    # main-path run whose kernel launches are counted).
    grid_a = np.arange(1.0, 5000.0, 0.1)
    col_a = column(16, P.Dataset)
    lc.reset_launches()
    spec_a, total_a, wall_a, dev_a, peak_a = phase_main(
        torch, P, db, col_a, grid_a, "phase 3 (0.1 cm-1, 16 layers, cold)")
    after_a = dict(lc.LAUNCHES)
    check(np.isfinite(total_a).all() and total_a.shape == (16, grid_a.size),
          "phase 3 total finite, [16 layers, grid]")
    lo, hi = float(total_a.min()), float(total_a.max())
    print(f"  total range [{lo:.6e}, {hi:.6e}] m-1, "
          f"{float((total_a > 0).mean()):.6f} of points > 0 (the reference "
          "pedestal removal leaves small negatives in dense bands)")
    check(hi > 0 and bool((total_a.sum(axis=1) > 0).all()),
          "phase 3 total positive: every layer's spectral integral > 0")
    check(after_a["wings_strided"] > 0 and after_a["core_segmix"] > 0,
          f"phase 3 launched the strided wings and core kernels {after_a}")

    # Phase 4: main path at 0.01 cm-1 (splat wings).
    grid_b = np.arange(1.0, 1000.0, 0.01)
    col_b = sub_column(col_a, slice(0, 16, 5), P.Dataset)
    spec_b, total_b, wall_b, dev_b, peak_b = phase_main(
        torch, P, db, col_b, grid_b, "phase 4 (0.01 cm-1, 4 layers)")
    launches = dict(lc.LAUNCHES)
    check(np.isfinite(total_b).all() and float(total_b.max()) > 0,
          "phase 4 total finite with positive maximum")
    check(launches["wings_splat"] > after_a["wings_splat"],
          f"phase 4 launched the splat wings kernel {launches}")
    for name in records:
        check(launches[name] > 0, f"main path launched {name}")
        records[name]["launches"] = launches[name]

    # Phase 5: kernels against their plain versions at main-path shapes.
    fn_a = stacked_fn(spec_a)
    fn_b = stacked_fn(spec_b)
    check(fn_a.wings_stride is not None and fn_b.wings_stride is None,
          "0.1 cm-1 takes the strided wings, 0.01 cm-1 the splat wings")
    phase_kernels(torch, lc, fn_a, col_a, ["wings_strided", "core_segmix"],
                  records)
    splat = {"wings_splat": records["wings_splat"],
             "core_segmix": dict(records["core_segmix"])}
    phase_kernels(torch, lc, fn_b, col_b, ["wings_splat", "core_segmix"],
                  splat)
    print(f"core_segmix at 0.01 cm-1 shapes: max rel "
          f"{splat['core_segmix']['max_rel_err']:.3e}, kernel "
          f"{splat['core_segmix']['ms']:.4f} ms, plain "
          f"{splat['core_segmix']['plain_ms']:.4f} ms")

    # Phase 6: float32 kernels vs the float64 plain path, 2 layers.
    two = sub_column(col_a, [0, 15], P.Dataset)
    s32 = P.Spectroscopy(two, grid_a, db, device="cuda")
    s64 = P.Spectroscopy(two, grid_a, db, device="cuda",
                         dtype=torch.float64, backend="plain")
    got = total_of(s32.compute_absorption(output_format="total"))
    want = total_of(s64.compute_absorption(output_format="total"))
    rel, err = rel_diff(torch.as_tensor(got), torch.as_tensor(want), 1e-6)
    print(f"phase 6: float32 kernels vs float64 plain, max rel {rel:.3e}, "
          f"max abs {err:.3e} m-1")
    check(rel < PARITY_TOL, f"main path within {PARITY_TOL} of float64")
    raw = total_of(s32.compute_absorption(output_format="total",
                                          remove_pedestal=False))
    print(f"phase 6 without pedestal removal: range [{raw.min():.6e}, "
          f"{raw.max():.6e}] m-1")
    check(np.isfinite(raw).all() and raw.min() >= -1e-6 * raw.max(),
          "without pedestal removal the total is non-negative (to float32 "
          "round-off)")

    # Phase 7: determinism.
    again, wall_w, dev_w = timed_call(
        torch, lambda: spec_a.compute_absorption(output_format="total"))
    print(f"phase 3 again (warm): wall {wall_w:.3f} s (CUDA events "
          f"{dev_w:.3f} s)")
    check(np.array_equal(total_of(again), total_a),
          "repeated phase 3 call is bit-identical")
    breakdown(torch, spec_a, col_a)

    print(json.dumps({"kernels": [records[k] for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    try:
        code = main()
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
