"""The batched pipeline under the wide default kernel envelope (350 K,
5 atm) against the atmosphere-derived tight envelope, on one card.

Counterpart of ``tools/envelope_compare.py``: builds ``make_batched_fn``
twice on the headline pack (1-5000 cm-1 at 0.1) for a column spanning
the canonical one, once with the default envelope and once with
``derive_envelope``'s, and times each pipeline call (without its envelope
guard) with CUDA events.  The tight envelope shrinks the
layer-independent core-instance windows.  Run on a CUDA card::

    python -m pylbl_tpu_torch.tools.envelope_compare [--lines N]
        [--layers B] [--reps R]

It prints one JSON line: the core instance count and the per-call ms of
each variant, the speedup and the card.  Without CUDA it exits with
code 2.
"""
import argparse
import json

import numpy as np
import torch

from . import card, device_ms, headline_pack, require_cuda, run_main
from .batched_microbench import column
from ..parallel.lines import derive_envelope, make_batched_fn


def build(pack, grid, num_layers, device="cuda"):
    """(variants, (t, p, x), envelope): {name: pipeline} under the default
    envelope and under the derived one, the layer conditions as float32
    tensors on ``device`` and the derived (t_max, p_max_atm)."""
    cond = tuple(np.asarray(a, np.float32) for a in column(num_layers))
    t_max, p_max_atm = derive_envelope(cond[0], cond[1])
    variants = {
        "default_350K_5atm": make_batched_fn(pack, grid, device=device),
        "derived": make_batched_fn(pack, grid, t_max=t_max,
                                   p_max_atm=p_max_atm, device=device)}
    return variants, tuple(torch.as_tensor(a, device=device)
                           for a in cond), (t_max, p_max_atm)


def run(num_lines=300000, num_layers=4, reps=5, pack=None):
    """Times both variants on the CUDA card and prints the report (one
    JSON line); returns it."""
    require_cuda("envelope_compare")
    pack = headline_pack(num_lines) if pack is None else pack
    variants, (t, p, x), envelope = build(
        pack, np.arange(1.0, 5000.0, 0.1), num_layers)
    report = {"card": card(), "num_lines": pack.num_lines,
              "num_layers": num_layers, "derived_envelope": list(envelope)}
    for name, fn in variants.items():
        report[name] = {"core_instances": fn.core_plan.num_instances,
                        "ms_per_call": device_ms(lambda: fn.inner(t, p, x),
                                                 reps)}
    report["speedup"] = report["default_350K_5atm"]["ms_per_call"] \
        / report["derived"]["ms_per_call"]
    print(json.dumps(report), flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lines", type=int, default=300000)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    return run_main("envelope_compare", run, args.lines, args.layers,
                    args.reps)


if __name__ == "__main__":
    raise SystemExit(main())
