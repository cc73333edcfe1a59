"""Measurement tools of the port, each run as
``python -m pylbl_tpu_torch.tools.<name>``:

- ``kernel_microbench``: device time of every single-layer pass and
  formulation on the headline workload;
- ``parity_ab``: every (core_mode, wings_mode) formulation of the
  single-layer device plan against the float64 plain plan;
- ``batched_microbench``: the stage split (physics, assembly, wings, core,
  full) of the single-gas or stacked batched pipeline;
- ``envelope_compare``: the single-gas batched pipeline under the default
  kernel envelope against the atmosphere-derived one;
- ``bench_scaling``: the line-sharded step at spec 1, 2 and 4 on gloo
  ranks that share the card (work-model efficiency, float64 error).

The benchmark entry point, ``python -m pylbl_tpu_torch bench``
(``pylbl_tpu_torch/bench.py``), runs on the helpers here, and so does
``chip_smoke.py``: the operation counts below set both the kernel records'
bounds and the top of the bench's plausibility band.

They time CUDA kernels with CUDA events, so their entry points need a CUDA
card and exit non-zero without one; there is no CPU fallback.  The
workload and plan builders run on any device (the tests build them on the
CPU at a small size).  Every time is printed beside the card's name and
power limit.
"""
import subprocess

import numpy as np
import torch

from ..database.fixtures import synthetic_line_pack
from ..ops import lineshape_cuda as lc

CUT_OFF = 25
# The JAX package's headline layer (bench.py TEMPERATURE/PRESSURE/VMR).
SURFACE = (288.99, 98388.0, 6.637074e-03)
# H100 SXM peaks (NVIDIA's data sheet, at its 700 W limit): FP32 outside
# the tensor cores and HBM3 bytes per second.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# Operations per in-window evaluation, counted from csrc/lineshape.cu (each
# add, multiply, divide, sqrt and exp one): the Lorentzian of the tile
# kernel, a Humlicek k1 correction and a k12/k123/full correction (region
# 1's path, the one beyond xlim1; points nearer the center cost more, so a
# bound from these counts stays below the work).
OPS_LORENTZ = 7
OPS_K1 = 28
OPS_REGIONS = 41


class NoCudaError(RuntimeError):
    """A timing entry point was called without a CUDA card."""


def require_cuda(tool):
    if not torch.cuda.is_available():
        raise NoCudaError(f"{tool} measures the CUDA kernels and needs a "
                          "CUDA card (there is no CPU fallback)")


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` warm calls (one
    warm-up call first), timed with CUDA events."""
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


def run_main(tool, run, *args):
    """A tool's command-line entry: ``run(*args)``, or exit code 2 with a
    message when there is no CUDA card."""
    try:
        run(*args)
    except NoCudaError as exc:
        print(f"{tool}: {exc}", flush=True)
        return 2
    return 0


def headline_pack(num_lines=300000, nu_max=5100.0):
    """The headline line list (bench.py ``build_workload``): synthetic
    H2O, seed 1, bands at 150/1600/3700/500 cm-1."""
    return synthetic_line_pack(num_lines=num_lines, nu_min=0.5,
                               nu_max=nu_max, seed=1,
                               band_centers=(150.0, 1600.0, 3700.0, 500.0))


def layer_workload(pack, grid, cond=SURFACE, dtype=np.float32):
    """One layer's single-layer inputs on ``grid``: a dict with the float64
    physics ``kin``, the kernel ``arrays`` in ``dtype``, ``npv``, the
    internal grid size ``n`` and the kept line count ``keep``."""
    from ..models.lines import internal_grid
    from ..models.lines.physics import kernel_inputs, line_profile_params
    from ..ops.lineshape import prepare_kernel_arrays

    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, CUT_OFF)
    kin = kernel_inputs(line_profile_params(pack, *cond, keep=keep), v0, npv,
                        CUT_OFF)
    return {"pack": pack, "grid": grid, "kin": kin, "npv": npv, "n": n,
            "keep": keep, "arrays": prepare_kernel_arrays(kin, npv, dtype)}


def headline_workload(num_lines=300000, step=0.1):
    """The headline layer: 1-5000 cm-1 at ``step``, the surface layer."""
    return layer_workload(headline_pack(num_lines),
                          np.arange(1.0, 5000.0, step))


def window_evals(keep, n_per_v):
    """The JAX package's headline unit (bench.py ``window_evals``): ``keep``
    lines x ((2 * cut_off + 1) * n_per_v + 1) masked line-point
    evaluations."""
    return keep * ((2 * CUT_OFF + 1) * n_per_v + 1)


def masked_evals(work):
    """:func:`window_evals` of one layer's workload."""
    return window_evals(work["keep"], work["npv"])


def class_ops(y):
    """Operations per evaluated point of the correction class picked from
    ``y`` (0 where y >= 70.55: skipped)."""
    ops = torch.where(y >= 8.425, float(OPS_K1), float(OPS_REGIONS))
    return torch.where(y >= 70.55, 0.0, ops.double())


def tile_ops(soa, num_points, line):
    """Operations a tile kernel's SoA [..., 8, N] needs: each line's in-grid
    window points (dead lines have empty windows), at the Lorentzian's cost
    or, for the correction line function ``line="corr"``, at its own y's
    class."""
    s = soa[..., lc.S_IDX, :].double().clamp_min(0)
    e = soa[..., lc.E_IDX, :].double().clamp_max(num_points - 1)
    points = (e - s + 1).clamp_min(0)
    if line == "corr":
        return float((points * class_ops(soa[..., lc.Y, :])).sum())
    return OPS_LORENTZ * float(points.sum())


def core_ops(params):
    """Operations of a segment core's parameter block [..., 8, I]: each
    instance's in-window offsets of its 32-point segment, at its chunk's
    class."""
    blocks = params.reshape(-1, lc.SEGP_ROWS, params.shape[-1] // 128, 128)
    s = blocks[:, lc.SR_SREL].double().clamp_min(0)
    e = blocks[:, lc.SR_EREL].double().clamp_max(31)
    points = (e - s + 1).clamp_min(0).sum(dim=-1)
    return float((points * class_ops(blocks[:, lc.SR_Y].amin(-1))).sum())
