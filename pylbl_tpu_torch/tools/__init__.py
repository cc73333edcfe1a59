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
  ranks that share the card (work-model efficiency, float64 error);
- ``wings_ab``: the wings kernels of this checkout (the Lorentzian walk,
  the segment wings) against libraries built from other versions of
  ``csrc/lineshape.cu``, in turns on the smoke's inputs (the turns:
  ``ab``);
- ``core_census``: the Humlicek cores' work on the smoke's inputs (the
  mixed-slot core, the segment core, CORR and the rows core), by class
  and Humlicek region, in the kernels' float32 arithmetic (runs on the
  CPU too);
- ``core_ab``: the Humlicek core kernels of this checkout (the mixed-slot
  core, the segment core, CORR, the rows core) against libraries built
  from other versions of ``csrc/lineshape.cu``, in turns.

``nonfinite`` has no entry point: it makes each kernel family's input
with non-finite lines, which ``chip_smoke.py`` and the tests run.

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
import re
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
# A Humlicek core's work as its census counts it (tools/core_census.py; the
# mixed-slot core's and the unit walk's):
# operations per point that needs a correction, by list, counted from
# csrc/lineshape.cu as above: x (3), the list's body with the xq and yq it
# computes (K1: k1_value 18; region 1: 2 + region1 11; region 2: 2 +
# region2 44; region 3: 1 + region3 128; CPF12: 1 + cpf12 234, the
# reciprocals of its 24 divides and its exp among them), for the regions
# the Lorentzian (5) and the difference (1), then pref * value (1) and the
# add into the sum (1); and per instance with such a point its y-only
# limits once (region_limits 17, class 1's k1_limit 5).  A point that
# needs none costs nothing here.  Divides among them: K1 1, regions 1-3
# 2 each, CPF12 25 (and its exp); the bound counts each as one operation.
CENSUS_OPS = {"k1": 23, "r1": 24, "r2": 57, "r3": 140, "cpf12": 246}
OPS_LIMITS = 17
OPS_K1_LIMIT = 5
# The floor of a term that needs one reciprocal: Hopper's MUFU gives 16
# reciprocals a clock on each of the H100 SXM's 132 SMs.
RCP_PER_CLOCK = 16
SMS = 132
# The canonical 4-layer test column (tests/conftest.py): pressure [Pa],
# temperature [K] and mole fractions, by gas.
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


def kernel_device_ms(fn, reps, name):
    """Mean device milliseconds per call of ``fn()`` spent in the CUDA
    kernels whose name holds ``name`` (a string, or a tuple of strings of
    which one must be in it), over ``reps`` warm calls, from a
    ``torch.profiler`` trace of the card (the kernels alone: no host
    time, no idle gap between launches); None when the trace holds no
    such kernel."""
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names)]
    return sum(spans) / reps / 1e3 if spans else None


def canonical_layers(num_layers):
    """``num_layers`` layers spanning the canonical column: pressure
    log-spaced 117-98388 Pa, temperature and mole fractions interpolated in
    log pressure.  Returns (t, p, {gas: mole fractions}), float64."""
    p = np.geomspace(CANON_P[0], CANON_P[-1], num_layers)
    order = np.argsort(CANON_P)
    logp = np.log(CANON_P[order])
    t = np.interp(np.log(p), logp, CANON_T[order])
    vmr = {name: np.interp(np.log(p), logp, np.asarray(values)[order])
           for name, values in CANON_VMR.items()}
    return t, p, vmr


def sm_clock_mhz(fn, seconds=0.3):
    """The SM clock [MHz] that nvidia-smi reads while launches of ``fn``
    keep the card busy for about ``seconds`` (an idle card reads its idle
    clock)."""
    reps = max(1, int(seconds * 1e3 / device_ms(fn, 3)))
    for _ in range(reps):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return float(out.stdout.split()[0])


def rcp_floor_ms(evals, mhz):
    """The least time ``evals`` Lorentzian terms take when each needs one
    MUFU reciprocal: ``RCP_PER_CLOCK`` x ``SMS`` a clock at ``mhz``."""
    return evals / (RCP_PER_CLOCK * SMS * mhz * 1e6) * 1e3


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_usage(log):
    """{kernel's mangled name: {"registers", "spill_stores",
    "spill_loads", "smem"}} from nvcc's ``-Xptxas -v`` output (bytes, static
    shared memory only)."""
    usage = {}
    name = None
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            name = entry.group(1)
            usage[name] = {"registers": None, "spill_stores": 0,
                           "spill_loads": 0, "smem": 0}
        elif name is not None and _SPILLS.search(line):
            stores, loads = _SPILLS.search(line).groups()
            usage[name].update(spill_stores=int(stores),
                               spill_loads=int(loads))
        elif name is not None and _USED.search(line):
            smem = _SMEM.search(line)
            usage[name].update(registers=int(_USED.search(line).group(1)),
                               smem=int(smem.group(1)) if smem else 0)
            name = None
    return usage


# The Lorentzian walk's line kinds by their template argument
# (csrc/lineshape.cu kLinePre, kLineRaw, kLineOwn).
WALK_KINDS = {0: "pre", 1: "raw", 3: "own"}
_WALK = re.compile(r"lorentz_walk_kernelILi(\d+)E(?:Li(\d+)E)?")


def walk_usage(log):
    """{line kind: ``ptxas_usage``} of every instantiation of the
    Lorentzian walk, each with its points per lane as ``points``, by
    :data:`WALK_KINDS` ("pre", "raw", "own"; a walk of one template
    argument, as builds before the line kinds compiled it, is "pre");
    None when the log has none."""
    kinds = {}
    for name, use in ptxas_usage(log).items():
        found = _WALK.search(name)
        if found:
            kind = WALK_KINDS.get(int(found.group(2) or 0), found.group(2))
            kinds[kind] = dict(use, points=int(found.group(1)))
    return kinds or None


def core_usage(log, kernel="core_segmix_kernel"):
    """The ``ptxas_usage`` of the mixed-slot core kernel (or of the first
    kernel whose mangled name holds ``kernel``); None when the log has
    none."""
    for name, use in ptxas_usage(log).items():
        if kernel in name:
            return use
    return None


# The unit walk's kernels by the name their records take: CORR and the
# rows core at tile 1024 (G = 4 point groups a row), with and without the
# separate min-y block.  CORR's second name, the tile kernel's correction
# line function, only reads an ``--other`` build from before the unit walk
# and goes with the last such build.
PAIR_KERNELS = {"corr": ("corr_walk_kernelILi4E", "wings_kernelILi4E"),
                "rows": ("rows_kernelILi4ELb0E",),
                "rows_vmem": ("rows_kernelILi4ELb1E",)}


def pair_usage(log):
    """{"corr", "rows", "rows_vmem": ``ptxas_usage``} of the unit walk's
    kernels at tile 1024 in the compiler's log (the earlier CORR's where
    the log has no unit walk; None where it has neither)."""
    out = {}
    for key, names in PAIR_KERNELS.items():
        found = [core_usage(log, name) for name in names]
        out[key] = next((use for use in found if use is not None), None)
    return out


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


def rows_ops(groups, g_n, tile):
    """Operations of the rows core's group block [..., 64, G] walked
    through ``g_n`` chunks of 128 groups a tile: each group's instance r
    over the in-window points of row r of its tile, at the group's class
    (from its min y, row 56)."""
    g = groups.reshape(-1, lc.GROUP_ROWS, groups.shape[-1])
    dev = groups.device
    row_w = tile // 8
    tiles = torch.repeat_interleave(
        torch.arange(len(g_n), device=dev),
        torch.as_tensor(g_n, device=dev).long() * lc.ROWS_CHUNK)
    lo = (tiles[None, :] * tile + row_w * torch.arange(8, device=dev)[:, None]
          ).double()                                       # [8, G]
    s = torch.maximum(g[:, 5 * 8:6 * 8, :tiles.numel()].double(), lo)
    e = torch.minimum(g[:, 6 * 8:7 * 8, :tiles.numel()].double(),
                      lo + row_w - 1)
    points = (e - s + 1).clamp_min(0).sum(dim=1)           # [B, G]
    return float((points * class_ops(g[:, lc.YMIN_ROW, :tiles.numel()]))
                 .sum())


def core_ops(params):
    """Operations of a segment core's parameter block [..., 8, I]: each
    instance's in-window offsets of its 32-point segment, at its chunk's
    class."""
    blocks = params.reshape(-1, lc.SEGP_ROWS, params.shape[-1] // 128, 128)
    s = blocks[:, lc.SR_SREL].double().clamp_min(0)
    e = blocks[:, lc.SR_EREL].double().clamp_max(31)
    points = (e - s + 1).clamp_min(0).sum(dim=-1)
    return float((points * class_ops(blocks[:, lc.SR_Y].amin(-1))).sum())


def census_ops(census):
    """Operations of a Humlicek core's work from its census
    (:func:`pylbl_tpu_torch.tools.core_census.census`, ``corr_census``,
    ``rows_census``): each needed point at its list's :data:`CENSUS_OPS`,
    each instance (or line visit) with one at its limits' cost."""
    points = census["needed"]
    ops = sum(CENSUS_OPS[k] * points[k] for k in ("k1", "r1", "r2", "r3"))
    ops += CENSUS_OPS["cpf12"] * (points["cpf12_i"] + points["cpf12_ii"])
    return float(ops + OPS_K1_LIMIT * census["needing_k1_chunks"]
                 + OPS_LIMITS * census["needing_region_chunks"])


def core_bytes(params, num_tiles, num_points):
    """Bytes the mixed-slot core pass must move: its float32 parameters
    [B, 8, I] (or [8, I]) and the int32 chunk CSR (starts and counts of
    ``num_tiles`` tiles) read once, its [B, num_points] output written
    once."""
    layers = params.numel() // (lc.SEGP_ROWS * params.shape[-1])
    return 4 * (params.numel() + 2 * num_tiles + layers * num_points)


def pair_bytes(kind, data, index, num_points):
    """Bytes the unit walk's pass must move: the parameter rows its kernel
    reads, the int32 tensors ``index`` (CORR's tile CSR, the rows core's
    walk) read once, and its float32 output of ``num_points`` a layer
    written once.  CORR (``kind`` "corr", ``data`` a raw SoA [B, 8, N] or
    [8, N]) reads the seven fields, not the _PAD row; the rows core
    ("rows", "rows_vmem": a group block [B, 64, G] or [64, G]) reads the 56
    parameter rows and one min-y row (row 56, or the [B, 1, G] block of
    "rows_vmem"), not the seven zero rows."""
    layers = data.numel() // (data.shape[-2] * data.shape[-1])
    rows = lc.N_FIELDS if kind == "corr" else lc.YMIN_ROW + 1
    return (4 * (rows * layers * data.shape[-1] + layers * num_points)
            + sum(t.numel() * t.element_size() for t in index))


def seg_bytes(kind, params, streams, num_points):
    """Bytes the segment pass must move (``kind`` "core" or "wings",
    ``params`` [B, 8, I] or [8, I], ``streams`` its plan's
    :class:`SegStreams`): the 7 parameter rows its chunk kernel reads of
    each walked chunk (not the eighth: the core's zero slot row, the
    wings' unread row), the int32 stream walk read once (the entries'
    chunks, the wings' also their streams, the fold's stream pointers),
    and its float32 output of ``num_points`` a layer written once."""
    layers = params.numel() // (params.shape[-2] * params.shape[-1])
    walk = streams.num_entries * (2 if kind == "wings" else 1) \
        + streams.ptr.size
    return 4 * (lc.N_FIELDS * lc.ROWS_CHUNK * streams.num_entries * layers
                + walk + layers * num_points)


def seg_wings_evals(params, streams):
    """The segment wings' terms: each walked instance's window points
    within its chunk's 32-point segment (absolute points 32 * stream ..
    32 * stream + 31), over the layers of ``params`` [B, 8, I] or [8,
    I]."""
    dev = params.device
    p = params.reshape(-1, lc.SEGP_ROWS, params.shape[-1] // lc.ROWS_CHUNK,
                       lc.ROWS_CHUNK)
    chunk = torch.as_tensor(streams.chunk, device=dev).long()
    lo = (lc.SEG * torch.as_tensor(streams.stream, device=dev)).double()
    lo = lo[None, :, None]
    s = torch.maximum(p[:, lc.S_IDX].index_select(1, chunk).double(), lo)
    e = torch.minimum(p[:, lc.E_IDX].index_select(1, chunk).double(),
                      lo + (lc.SEG - 1))
    return float((e - s + 1).clamp_min(0).sum())


def census_bound(census, nbytes):
    """A Humlicek core's bound from its census: (ms, "operations" or
    "bytes"), the larger of :func:`census_ops` over the FP32 peak and
    ``nbytes`` (:func:`core_bytes`, :func:`pair_bytes`, :func:`seg_bytes`)
    over the memory rate."""
    t_ops, t_bytes = census_ops(census) / PEAK_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
