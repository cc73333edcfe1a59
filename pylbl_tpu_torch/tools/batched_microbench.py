"""Stage split of the batched pipelines on one card.

Counterpart of ``tools/batched_microbench.py``: times, with CUDA events
over warm calls, the stages of the single-gas pipeline
(``make_batched_fn``, the 300k-line headline pack) or, with
``--multigas``, of the stacked seven-gas pipeline
(``make_multigas_batched_fn``): the device line physics, the assembly
(physics plus the wings SoA and core blocks), the wings pass, the core
pass and the full pipeline.  The layers span the canonical column
(203-289 K, 117-98388 Pa).  The splat wings run with the pass kind the
pipeline reports in its ``wings_prepacked`` handle (raw rows under a "seg"
or "rows" core): the JAX tool hard-codes the prepacked kind there.  Run on
a CUDA card::

    python -m pylbl_tpu_torch.tools.batched_microbench [--multigas]
        [--lines N] [--layers B] [--reps R] [--core-mode MODE]
        [--step STEP] [--tile T] [--wings-tail W] [--wings-chunk C]

``--wings-chunk`` (the stacked pipeline's, as the JAX tool's multigas
form takes it) sets the wings pass's line chunk: the strided plan's
(default 256) or the splat CSR's (default 512), at most 512.

Without CUDA it exits with code 2.
"""
import argparse

import numpy as np
import torch

from . import card, device_ms, headline_pack, require_cuda, run_main
from ..database.fixtures import synthetic_line_pack
from ..ops import lineshape_cuda as lc
from ..parallel.lines import (line_kernel_arrays, make_batched_fn,
                              make_multigas_batched_fn)

GASES = ("H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2")


def multigas_packs(h2o_lines=300000, other_lines=20000, nu_max=5100.0):
    """The seven-gas synthetic line lists (bench.py ``multigas_packs``)."""
    return {name: synthetic_line_pack(
        name, num_lines=h2o_lines if name == "H2O" else other_lines,
        nu_min=0.5, nu_max=nu_max, seed=g + 1,
        band_centers=(150.0 + 400 * g, 1600.0, 3700.0))
        for g, name in enumerate(GASES)}


def column(num_layers, num_gases=None):
    """[B] temperature and pressure spanning the canonical column and the
    mole fractions ([B], or [B, G] for ``num_gases``)."""
    t = np.linspace(203.37, 288.99, num_layers)
    p = np.geomspace(117.0, 98388.0, num_layers)
    if num_gases is None:
        return t, p, np.full(num_layers, 6.637074e-03)
    return t, p, np.full((num_layers, num_gases), 1e-4)


def build(packs, grid, num_layers, core_mode=None, device="cuda", tile=None,
          wings_tail=None, wings_chunk=None):
    """(pipeline, (t, p, x) tensors): the single-gas pipeline for one pack,
    the stacked one for a dict of packs (which alone takes
    ``wings_chunk``); ``wings_tail=None`` keeps each builder's default."""
    kwargs = {} if wings_tail is None else {"wings_tail": wings_tail}
    if isinstance(packs, dict):
        fn = make_multigas_batched_fn(packs, grid, tile=tile,
                                      core_mode=core_mode,
                                      wings_chunk=wings_chunk, device=device,
                                      **kwargs)
        cond = column(num_layers, len(packs))
    else:
        if wings_chunk is not None:
            raise ValueError("wings_chunk is the stacked pipeline's")
        fn = make_batched_fn(packs, grid, tile=tile, core_mode=core_mode,
                             device=device, **kwargs)
        cond = column(num_layers)
    return fn, tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in cond)


def wings_stage(fn, soa):
    """The pipeline's wings pass on ``soa`` as the tool times it: the
    strided pass, or the splat with the pass kind that ``wings_prepacked``
    reports."""
    if fn.wings_stride is not None:
        return lambda: fn.wings_pass(soa)
    plan = fn.core_plan
    start, nchunks = (torch.as_tensor(a, device=soa.device)
                      for a in fn.wings_csr)
    kind = "wings_pre" if fn.wings_prepacked else "wings"
    return lambda: lc.tile_pass(soa, start, nchunks, plan.num_points,
                                plan.tile, fn.wings_chunk, kind)


def build_stages(fn, t, p, x):
    """[(name, fn)] of the pipeline's stages on the inputs' device."""
    stage = fn.stage
    soa, core = stage.assemble(t, p, x)
    plan = fn.core_plan
    return [
        ("physics",
         lambda: line_kernel_arrays(stage.arrays, stage.static, t, p, x)),
        ("assemble(phys+blocks)", lambda: stage.assemble(t, p, x)),
        (f"wings[{fn.wings_stride or 'tile'}]", wings_stage(fn, soa)),
        (f"core-{plan.mode}[{plan.num_instances}]",
         lambda: fn.core_pass(core)),
        ("full", lambda: stage.run(t, p, x))]


def run(multigas=False, num_lines=300000, num_layers=16, reps=5,
        core_mode=None, step=0.1, tile=None, wings_tail=None,
        wings_chunk=None):
    """Times each stage on the CUDA card and prints one line each; returns
    [(name, ms)]."""
    require_cuda("batched_microbench")
    grid = np.arange(1.0, 5000.0, step)
    packs = multigas_packs() if multigas else headline_pack(num_lines)
    fn, (t, p, x) = build(packs, grid, num_layers, core_mode, "cuda", tile,
                          wings_tail, wings_chunk)
    plan = fn.core_plan
    print(f"batched_microbench on {card()}: "
          f"{'7-gas stacked' if multigas else 'single-gas'}, {num_layers} "
          f"layers, {plan.num_points} points, step {step}, core_mode "
          f"{plan.mode}, wings_stride {fn.wings_stride}, wings_chunk "
          f"{fn.wings_chunk}, prepacked {fn.wings_prepacked}", flush=True)
    records = []
    for name, stage in build_stages(fn, t, p, x):
        ms = device_ms(stage, reps)
        print(f"  {name:28s} {ms:10.4f} ms total {ms / num_layers:9.4f} "
              "ms/layer", flush=True)
        records.append((name, ms))
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multigas", action="store_true")
    parser.add_argument("--lines", type=int, default=300000)
    parser.add_argument("--layers", type=int, default=16)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--core-mode", default=None)
    parser.add_argument("--step", type=float, default=0.1)
    parser.add_argument("--tile", type=int, default=None)
    parser.add_argument("--wings-tail", type=int, default=None)
    parser.add_argument("--wings-chunk", type=int, default=None)
    args = parser.parse_args(argv)
    if args.wings_chunk is not None and not args.multigas:
        parser.error("--wings-chunk needs --multigas")
    return run_main("batched_microbench", run, args.multigas, args.lines,
                    args.layers, args.reps, args.core_mode, args.step,
                    args.tile, args.wings_tail, args.wings_chunk)


if __name__ == "__main__":
    raise SystemExit(main())
