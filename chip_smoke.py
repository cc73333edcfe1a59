#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU and checks it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card, nvcc (``/usr/local/cuda``) and g++; it builds the hand-written
kernels and the native pedestal scan from this checkout into ``build/``
(the two builds run concurrently) and imports nothing of JAX or
``pylbl_tpu``.  Phases:

1. device and toolchain (card name and power limit from nvidia-smi), and
   whether h5py, netCDF4 and pyarts import on this host (a fact, not a
   check);
2. build of the CUDA kernels and the native library;
3. main path at 0.1 cm-1: seven gases' synthetic line lists (H2O 300k
   lines, six gases x 20k, 0.5-5100 cm-1) in a port Database, a 16-layer
   column spanning the canonical test column, grid 1-5000 cm-1,
   ``Spectroscopy(..., device="cuda").compute_absorption("total")`` with
   MT-CKD continua and the pedestal removed;
4. main path at 0.01 cm-1 (splat wings): the same gases, 4 layers, grid
   1-1000 cm-1 (100k points per gas);
5. each kernel against its plain PyTorch version on inputs taken from
   phases 3 and 4 (2 layers), bit for bit, with both times; the wings and
   the core of phase 3 also at all 16 layers;
6. the float32 main path against the plain path in float64 on the card,
   2 layers of phase 3, rel below 5e-4;
7. phase 3's call run twice gives bit-identical results;
8. the single-gas engine on the headline workload (300k-line synthetic
   H2O, one surface layer, grid 1-5000 cm-1 @ 0.1, 50,000 points):
   ``Gas(..., device="cuda").absorption_coefficient`` cold and warm, with
   and without the pedestal, against the float64 plain path (rel below
   5e-4); the single-layer strided wings and mixed-slot core kernels
   against their plain versions, and the masked line-point rate of the
   device plan;
9. the same layer at 0.01 cm-1 (grid 1-1000, 100,000 points; no stride
   fits): the raw-Lorentz tile kernel, against float64;
10. ``Gas.absorption_coefficient_batch`` over phase 3's 16-layer column
    with the pedestal removed: wall time, peak memory, float64 parity on 2
    layers, bit-identical repeat;
11. the A/B formulations of one headline layer: per-stream segment core,
    segment wings (with their chunk and stream counts and the chunk
    kernels' grids), raw-Lorentz splat wings and the scalar per-line core,
    plus the strided wings on a tail-chunk layout; each kernel against its
    plain version (the segment core and wings also repeated bit for bit)
    and each spectrum against phase 8's float64 result;
12. the rows core and the ownership-checked strided wings: the headline
    layer's ``make_device_plan(core_mode="rows")`` with the strided and
    the tile wings (float64 parity), the rows core with its separate
    min-y block (both with their piece counts, and the size of the rows
    core's deviation from one running sum per point), the checked
    strided wings on the layer's straddle CSR (against the prepacked
    strided pass), phase 10's 16-layer column through
    ``make_batched_fn(core_mode="rows")`` and ``core_mode="seg"`` (float64
    parity on layers 0 and 15; the rows and segment cores timed at 16
    layers), the checked wings on two of its layers with one CSR, and the
    port's ``kernel_microbench`` and ``parity_ab`` tools at the headline
    size; each new kernel equals its plain version bit for bit;
13. the portable two-pass backend, which runs no hand kernel: the
    headline layer through ``Gas(..., backend="xla")`` cold and warm
    (float64 parity, a bit-identical repeat, its gap to phase 8's kernel
    spectrum), ``Gas(dtype=np.float32)`` bit-identical to
    ``torch.float32``, phase 3's 16 layers through
    ``make_multigas_batched_fn(backend="xla")`` (wall times beside the
    kernel pipeline's, peak memory, float64 parity on layers 0 and 15, a
    bit-identical repeat), the ``metrics`` snapshot of the phase's ``Gas``
    calls, a ``profiler_trace`` of one warm call, and the npz pack cache
    (sqlite, then npz, the packs equal);
14. the streamed path at BASELINE config-5 width: phase 3's gases and
    16-layer column on grid 1-5000 cm-1 at 0.01 (499,900 points per gas),
    the block loop of ``compute_absorption_streamed`` (blocks of 4) into
    an in-memory writer (it needs no h5py), cold and warm (walls,
    each block's stage timers, peak memory, the splat wings and core
    launched, a bit-identical repeat), layers 0 and 15 against
    ``compute_absorption("all")`` on a 2-layer sub-column (rtol 1e-12), a
    resume of 4 pending states around 12 sentinels, the splat wings and
    the core against their plain versions on a block's inputs, float64
    parity of the two layers' totals without the pedestal (and, with it,
    no float32 error beyond that), ``python -m pylbl_tpu_torch info``
    naming the card, and the ``envelope_compare`` tool at the headline
    size;
15. the sharded path at A's width (G): four ranks started by
    ``pylbl_tpu_torch.parallel.launch`` (spawn) on this one card over
    gloo, a 2x2 (batch, spec) mesh; they load phase 2's build (the build
    directory must not change) and the npz line packs.  For each
    ``sharding_mode`` (balanced, halo, ring)
    ``Spectroscopy(..., mesh=mesh).compute_absorption("total")`` cold and
    warm: ``step.backend == "kernel"``, every rank's launches of
    ``wings_strided`` and ``core_segmix``, all ranks' totals
    bit-identical, the warm repeat too, layers 0 and 15 within 5e-4 of
    phase 6's float64 totals, each rank's first stop's two kernels equal
    to their plain versions (timed on rank 0's balanced shard); readings
    of the walls, the gap to phase 3, peak memory, bytes sent per
    collective and the partition's stats.  Then the streamed loop under
    the mesh (blocks of 4, rank 0 writing into memory; layers 0 and 15
    equal to the sharded ``"all"`` output), the portable branch on 2
    layers (float64 parity), the refusal of NCCL for two ranks on one
    card, and a single-rank NCCL mesh (cold, warm, the gap to phase 3).
    It measures no scaling across cards.
16. the ingest path at A's width (H): stand-in HITRAN and TIPS clients
    serve phase 3's seven packs (420k transition rows as CSV text in the
    ingestion parameter order, every float in its shortest round-trip
    form); ``Database.create`` parses them with the native parser into a
    new sqlite file; each ingested ``line_pack`` equals phase 3's pack
    array for array, and the main path on the ingested database (A's
    column and grid, cold and warm) launches the strided wings and core
    and gives phase 3's total bit for bit.  Readings: the CSV bytes (and
    the stand-in's time to render them, outside ``create``), the wall of
    ``create`` with a cProfile of it, the native parse rate on H2O's
    text, the cold ``line_pack`` wall of the seven gases and the main
    path's cold and warm walls.
17. the benchmark entry point, ``python -m pylbl_tpu_torch bench``, as a
    subprocess at the JAX bench's widths (the 300k-line headline, 4
    layers, 7 gases and 420k lines, 499,900 points x 16 layers x 7 gases,
    a 1x1 mesh, the scaling tool): its compact line is last; every stage
    is a record with no error and no invalid timing; each stage launched
    its kernels; the float64 parities are below 5e-4; the sharded stage
    ran the kernel branch, the scaling tool's every point too; the
    headline rate lies within 0.5-2x of phase 8's.  It prints each
    stage's rate, host syncs and peak memory beside the card.
18. the JAX package's API on the card: A and B through
    ``make_multigas_batched_fn(..., wings_chunk=128)`` on layers 0 and 15
    (the strided wings with the tail class, then the splat CSR at chunk
    128 where it takes 512): each path's launches, each kernel against
    its plain version bit for bit, timed beside phase 5's chunk-256/512
    times with bounds from the same operation count, the lines total
    within 5e-4 of the float64 plain pipeline (phase 6's for A); the
    installed layout: ``pylbl_tpu_torch/`` copied alone, run by
    ``python -I -B`` with ``runtime/build.py`` ``can_write`` reporting the
    copy's parent unwritable and ``XDG_CACHE_HOME`` in a second temporary
    directory, builds both libraries (nvcc and g++) into the cache, runs
    the headline layer through ``Gas(..., device="cuda")`` with phase 8's
    spectrum bit for bit, and writes nothing beside the copy; then
    ``Gas(pack, "H2O", np.float32)`` by position (phase 8's spectrum bit
    for bit) and ``make_batched_tpu_fn`` by position against
    ``make_batched_fn`` on two of phase 10's layers, bit for bit.
19. non-finite lines: every kernel (all fifteen counters) on a small
    poisoned input (``pylbl_tpu_torch/tools/nonfinite.py``: prefactors of
    +inf, -inf and NaN, a NaN y, a NaN y with an infinite prefactor, y =
    0 at x = 0, a NaN srw, NaN window edges; the segment passes and the
    mixed-slot core on ``synthetic_segment``'s poisoned input), then CORR
    (one layer, two) and the rows core (one layer, two, the separate
    min-y block) on the NaN-y inputs, where a NaN y takes the whole
    correction as JAX's conds: each kernel equals its plain version bit
    for bit, NaN where its NaN is, and a repeat equals it too.
20. the stacked pedestal remover at col60-0p1-default's width (60 layers
    of the canonical column, phase 3's seven gases): the remover's call
    (CUDA events, the memory it takes above the field) launches each of
    its five kernels once a gas and repeats bit for bit; then, on H2O's
    300k lines, the line physics and the endpoint contributions within
    1e-14 of their largest value of the plain version (the same float64
    operations; torch's exp and the kernel's may differ in the last
    ulp), the scan (against the native scan), the bucket totals and the
    field bit for bit, each timed beside its plain version and its bound
    at the float64 peak (34 TFLOP/s): the endpoint terms at 9
    operations, the totals' and the field's additions, the bytes.

Every kernel of the line shape equals its plain version bit for bit.
Each kernel record carries its launches on its path, its time and its
plain version's, and
its bound: the larger of the operations its inputs need over 67 TFLOP/s
(FP32 outside the tensor cores) and its input and output bytes over 3.35
TB/s (H100 SXM).  Operations are counted per in-window evaluation from
``pylbl_tpu_torch/csrc/lineshape.cu`` (each add, multiply, divide, sqrt
and exp one): the Lorentzian 7 (the segment wings too, which form y^2 and
pref*y/sqrt(pi) once an instance), a Humlicek k1 correction 28 and a
k12/k123/full
correction 41 (region 1's path, the one beyond xlim1, about nine tenths
of a core window; the points nearer the center cost more, so the bound
stays below the work).  No single PyTorch call computes a windowed line
sum, so ``library_ms`` is null.  The split kernels' records also carry
their piece counts (the segment pass its chunk and stream counts).  The
records of the Lorentzian walk (the prepacked wings ``wings_strided``,
``wings_splat`` and their single-layer launches; the raw splat
``tile_lorentz``; the ownership-checked ``wings_strided_checked`` and
``_single``) carry beside each time its reciprocal floor,
``rcp_floor_ms``: the Lorentzian terms over 16 MUFU reciprocals a clock
on each of 132 SMs at the SM clock nvidia-smi reads while the kernel runs
(phase 17: at phase 5's clock, beside each bench stage's time), and the
registers and spills of the walk's instantiation for its line kind
(``line``: PRE, RAW or OWN) from this build's ``-Xptxas -v`` report
(phase 2 removes an earlier build first).
The mixed-slot core's records (``core_segmix``, ``core_segmix_single``)
carry its registers and spills the same way, and the census of their
phase's inputs (``pylbl_tpu_torch/tools/core_census.py``: the in-window
points and those that need a correction, by Humlicek list).  Their bound
is the census bound (``pylbl_tpu_torch/tools`` ``census_bound``): the
larger of the operations of the needed points over 67 TFLOP/s and the
bytes; ``ops41_bound_ms`` keeps the bound of 41 operations an in-window
point (``core_ops``).  The segment core's record (``seg_core``, phase 11
on the headline layer, its ``*_16_layers`` keys phase 12's column)
carries the same census (its instances all lie in slot 0) and census
bound, its bytes the 7 parameter rows its chunk kernel reads, the stream
walk and the output (``seg_bytes``); the segment wings' (``seg_wings``)
its bound over the same 7 rows with 7 operations a term, and its
reciprocal floor; both the registers and spills of their chunk
kernel.  The unit walk's records, CORR's
``tile_correction`` and the rows core's ``core_rows``,
``core_rows_single`` and ``core_rows_vmem``, carry the same: the
registers and spills of their kernel at tile 1024, the census of their
phase's inputs (``corr_census``, ``rows_census``: the in-window points,
those that need a correction by list, the point groups classified), and
the census bound as their bound beside the 41-operation one; phases 11
and 12 check that they repeat bit for bit and that no needed point lies
outside its item's need window.

Every check that fails exits non-zero.  The line before the last is the
kernel record (JSON), the last line is the device record (JSON).
"""
import cProfile
import concurrent.futures
import hashlib
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

try:
    from pylbl_tpu_torch.tools import (OPS_LORENTZ, PEAK_BYTES, PEAK_OPS,
                                       canonical_layers, census_bound,
                                       census_ops, core_bytes, core_ops,
                                       core_usage, pair_bytes, pair_usage,
                                       ptxas_usage, rcp_floor_ms, rows_ops,
                                       seg_bytes, seg_wings_evals,
                                       sm_clock_mhz, tile_ops, walk_usage)
except ImportError:         # alone: main() reports the missing package
    pass

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
GASES = ["H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2"]
STANDARD = {"H2O": "water_vapor", "CO2": "carbon_dioxide", "O3": "ozone",
            "N2O": "nitrous_oxide", "CO": "carbon_monoxide",
            "CH4": "methane", "O2": "oxygen", "N2": "nitrogen"}
# Kernel (its launch counter) -> the TPU kernel it replaces.
PALLAS = "pylbl_tpu/ops/lineshape_pallas.py"
KERNELS = {
    "wings_strided": f"{PALLAS}:2228",
    "core_segmix": f"{PALLAS}:1148",
    "wings_splat": f"{PALLAS}:1662",
    "wings_strided_single": f"{PALLAS}:2148",
    "wings_strided_tail_single": f"{PALLAS}:2195",
    "core_segmix_single": f"{PALLAS}:1113",
    "tile_lorentz": f"{PALLAS}:1528 (:1662) with _lorentz_line :110",
    "tile_correction": f"{PALLAS}:1528 (:1662) with _correction_line :119",
    "seg_core": f"{PALLAS}:842 (:880) with _seg_chunk_accumulate :762",
    "seg_wings": f"{PALLAS}:842 (:880) with _seg_chunk_accumulate_lorentz "
                 ":806",
    "core_rows_single": f"{PALLAS}:456 (_pallas_rows_pass :595)",
    "core_rows": f"{PALLAS}:505 (_pallas_rows_pass :595)",
    "core_rows_vmem": f"{PALLAS}:363 (_pallas_rows_pass_vmem :443)",
    "wings_strided_checked_single": f"{PALLAS}:2260 (_pallas_pass_strided "
                                    ":2469)",
    "wings_strided_checked": f"{PALLAS}:2321 (_pallas_pass_strided :2469)",
}
# The kernels of the stacked main path (phases 3-5).
STACKED = ("wings_strided", "core_segmix", "wings_splat")
# Phase 20: the stacked pedestal remover's kernels (their launch counters
# in pylbl_tpu_torch/ops/pedestal_cuda.py), which replace no TPU kernel:
# the JAX package runs these steps on the host.
PEDESTAL = {
    "pedestal_lines": "none (host: pylbl_tpu/models/lines/physics.py "
                      "line_profile_params and kernel_inputs)",
    "pedestal_contrib": "none (host: pylbl_tpu/models/lines/pedestal.py "
                        "compute_pedestals_batch's contribution sums)",
    "pedestal_scan": "none (host: csrc/pylbl_native.cpp pedestal_scan)",
    "pedestal_totals": "none (pylbl_tpu/parallel/lines.py "
                       "_apply_pedestal_device's scatter)",
    "pedestal_field": "none (pylbl_tpu/parallel/lines.py "
                      "_apply_pedestal_device's cumsum)",
}
# Phase 20's layers (col60-0p1-default's 60) and the float64 peak of the
# H100 SXM outside the tensor cores (NVIDIA's data sheet).
PEDESTAL_LAYERS = 60
PEAK_FP64 = 34e12
# Float64 operations of an endpoint term (csrc/pedestal.cu line_term: the
# Lorentzian's subtract, multiply, two squares, add, multiply and divide,
# the strength's multiply, and the sum's add; the divide counted as one),
# and of a bucket total added to a point's field.
PEDESTAL_TERM_OPS = 9
PEDESTAL_FIELD_OPS = 1
# The launches of the Lorentzian walk, by line kind (the prepacked wings,
# the raw splat, the ownership-checked wings): each record carries its
# reciprocal floor and the registers and spills of its kind's walk.
WALK = {"wings_strided": "pre", "wings_splat": "pre",
        "wings_strided_single": "pre", "wings_strided_tail_single": "pre",
        "tile_lorentz": "raw", "wings_strided_checked_single": "own",
        "wings_strided_checked": "own"}
# Phase 17: the kernels each stage of the bench launches.
BENCH_KERNELS = {
    "headline": ("wings_strided_single", "core_segmix_single"),
    "batched_4layer": ("wings_strided", "core_segmix"),
    "multigas_7gas": ("wings_strided", "core_segmix"),
    "config5": ("wings_splat", "core_segmix"),
    "sharded_1chip": ("wings_strided", "core_segmix"),
}
BENCH_PARITY = ("headline", "batched_4layer", "multigas_7gas")
PARITY_TOL = 5e-4
# Phase 14's grid (lo, hi, step), column and block size: BASELINE config
# 5 (bench.py prep_config5), 499,900 points per gas.
STREAM_GRID = (1.0, 5000.0, 0.01)
STREAM_LAYERS = 16
STREAM_BLOCK = 4
# Phase 15: the (batch, spec) mesh of ranks sharing the card, the modes.
SHARD_MESH = (2, 2)
SHARD_MODES = ("balanced", "halo", "ring")
CUT_OFF = 25
# The JAX package's headline layer (bench.py TEMPERATURE/PRESSURE/VMR).
SURFACE = (288.99, 98388.0, 6.637074e-03)
# Phase 18: the wings chunk the JAX callers pass (the TPU's tail chunk).
WINGS_CHUNK = 128
# Phase 18: the port run from a lone copy, its build in the user cache.
INSTALLED = r"""
import concurrent.futures, json, sys
args = json.loads(sys.argv[1])
sys.path.insert(0, args["root"])
from pylbl_tpu_torch.runtime import build
build.can_write = lambda path: False
import numpy as np
import pylbl_tpu_torch as P
from pylbl_tpu_torch.database import fixtures
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.runtime import native
with concurrent.futures.ThreadPoolExecutor(2) as pool:
    for done in [pool.submit(lc.cuda_library), pool.submit(native.load)]:
        done.result()
pack = fixtures.synthetic_line_pack(
    num_lines=300000, nu_min=0.5, nu_max=5100.0, seed=1,
    band_centers=(150.0, 1600.0, 3700.0, 500.0))
lc.reset_launches()
k = P.Gas(pack, "H2O", device="cuda").absorption_coefficient(
    *args["surface"], np.arange(1.0, 5000.0, 0.1))
np.save(args["out"], k)
print(json.dumps({
    "build_dir": str(build.BUILD_DIR), "package": P.__file__,
    "libs": sorted(p.name for p in build.BUILD_DIR.glob("*.so")),
    "launches": dict(lc.LAUNCHES),
    "refused": [m for m in ("jax", "pylbl_tpu") if m in sys.modules]}))
"""


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


# The CSV columns of the ingest path, in the ingestion parameter order
# (pylbl_tpu_torch/database/db.py TRANSITION_PARAMETERS), after the three
# integer columns.
CSV_FLOATS = ("nu", "sw", "gamma_air", "gamma_self", "n_air", "delta_air",
              "elower")
# The arrays of a LinePack that phase 16 holds equal.
PACK_ARRAYS = ("nu", "sw", "gamma_air", "gamma_self", "n_air", "elower",
               "delta_air", "iso", "mass_slots", "q_table", "q_temperature")


def pack_csv(pack, molecule_id):
    """A pack's transitions as a HITRAN CSV results file: global
    isotopologue id, molecule id, local isotopologue id (10 written as 0,
    as HITRAN does) and the seven floats, each in its shortest round-trip
    form so the parser reads back the same doubles."""
    iso = np.asarray(pack.iso, np.int64)
    columns = [(100 * molecule_id + iso).tolist(),
               [molecule_id] * iso.size, np.where(iso == 10, 0, iso).tolist()]
    columns += [np.asarray(getattr(pack, name), np.float64).tolist()
                for name in CSV_FLOATS]
    return "".join(",".join(map(repr, row)) + "\n" for row in zip(*columns))


class HitranStandIn:
    """Serves line packs the way the HITRAN client serves a molecule:
    records with the client's attributes, one isotopologue per filled
    mass slot (unique ids, isoid 10 written as 0) and the transitions as
    CSV text, rendered once here (``texts``), as a download would hand
    over bytes already made."""

    def __init__(self, packs):
        self.packs = packs
        self.texts = {name: pack_csv(pack, m + 1)
                      for m, (name, pack) in enumerate(packs.items())}

    def download_molecules(self):
        return [SimpleNamespace(
            id=m + 1, stoichiometric_formula=name, ordinary_formula=name,
            common_name=name, aliases=[{"alias": name}])
            for m, name in enumerate(self.packs)]

    def download_isotopologues(self, molecule):
        name = molecule.ordinary_formula
        slots = np.flatnonzero(self.packs[name].mass_slots) + 1
        return [SimpleNamespace(
            id=100 * molecule.id + int(isoid), molecule_id=molecule.id,
            isoid=0 if isoid == 10 else int(isoid),
            iso_name=f"{name}-{isoid}", abundance=1.0,
            mass=float(self.packs[name].mass_slots[isoid - 1]),
            molecule_alias=name) for isoid in slots]

    def download_transitions_csv(self, isotopologues, numin, numax,
                                 parameters):
        return self.texts[isotopologues[0].molecule_alias], parameters


class TipsStandIn:
    """Serves each pack's TIPS table as the TIPS client does."""

    def __init__(self, packs):
        self.packs = packs

    def download(self, molecule):
        pack = self.packs[molecule]
        return pack.q_temperature, pack.q_table


def column(num_layers, Dataset):
    """A column of ``num_layers`` spanning the canonical one
    (``tools.canonical_layers``: pressure log-spaced 117-98388 Pa,
    temperature and mole fractions interpolated in log pressure)."""
    t, p, vmr = canonical_layers(num_layers)
    data = {"p": (["layer"], p, {"standard_name": "air_pressure",
                                 "units": "Pa"}),
            "t": (["layer"], t, {"standard_name": "air_temperature",
                                 "units": "K"})}
    for name, x in vmr.items():
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


def kernel_ms(torch, fn, reps, warm=True):
    """Mean device milliseconds of ``fn`` over ``reps`` launches (after one
    warm-up call when ``warm``), timed with CUDA events."""
    if warm:
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


def core_csr(plan, params):
    """A segment plan's chunk CSR (and per-stream chunk slots) on the
    parameters' device."""
    consts = plan._device_consts(params.device)
    return consts["t_start"], consts["t_chunks"], consts["c_slot"]


def set_bound(record, ops, inputs, out, nbytes=None):
    """The record's bound: the larger of its operations over the FP32 peak
    and its input and output bytes over the memory rate (``nbytes``: the
    bytes it must move where these are not its whole input tensors, as
    the segment pass's 7 rows of 8, ``seg_bytes``)."""
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in inputs
                     if t is not None) + out.numel() * out.element_size()
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    record.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  operations=ops, bytes=nbytes)


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


def phase_kernels(torch, lc, fn, dataset, kernels, records, layers=2):
    """Kernel vs plain on the pipeline's own inputs (the first ``layers``
    layers), with each kernel's bound and piece counts."""
    t = np.asarray(dataset["t"].data)[:layers]
    p = np.asarray(dataset["p"].data)[:layers]
    x = np.stack([np.asarray(dataset[n.lower()].data)[:layers]
                  for n in fn.names], axis=1)
    soa, core = fn.assemble(t, p, x)
    stage = fn.stage
    for name in kernels:
        if name.startswith("core_segmix"):
            got = compare_kernel(torch, name, lambda: fn.core_pass(core),
                                 lambda: fn.core_pass(core, plain=True),
                                 records[name], reps=20,
                                 ops=core_ops(core),
                                 inputs=[core, *core_csr(stage.core_plan,
                                                         core)],
                                 pieces=stage.core_plan.pieces)
            core_census_record(name, records[name], core,
                               stage.core_plan.t_start,
                               stage.core_plan.t_chunks, got)
        else:
            compare_kernel(torch, name, lambda: fn.wings_pass(soa),
                           lambda: fn.wings_pass(soa, plain=True),
                           records[name], reps=20,
                           ops=tile_ops(soa, stage.n_out, "pre"),
                           inputs=[soa, *stage.csr_dev],
                           pieces=stage.wings_pieces, rcp=True)


def core_census_record(name, record, params, t_start, t_chunks, out,
                       nbytes=None):
    """The mixed-slot core's census of ``params`` walked through the chunk
    CSR (tools/core_census.py: its walked chunks' pairs by list) and its
    census bound over ``params``, the CSR and the output ``out`` (or
    ``nbytes``: the segment core's, ``seg_bytes``), into ``record`` (None:
    printed only), whose bound it becomes; the 41-operation bound
    ``compare_kernel`` set moves to ``ops41_*``."""
    from pylbl_tpu_torch.tools.core_census import census

    counts = census(params, t_start, t_chunks)
    if nbytes is None:
        nbytes = core_bytes(params, len(t_chunks), out.shape[-1])
    ms, bound_by = census_bound(counts, nbytes)
    print(f"{name} census: {counts['in_window']} in-window points, "
          f"{counts['needed_total']} needed {counts['needed']}, "
          f"{counts['rounds']} rounds of 32; census bound {ms:.6f} ms "
          f"({bound_by})")
    if record is None:
        return
    record.update(ops41_bound_ms=record["bound_ms"],
                  ops41_bound_by=record["bound_by"],
                  ops41_operations=record["operations"])
    record.update(census={key: counts[key] for key in (
        "chunks", "chunks_by_class", "lane_evals", "in_window", "needed",
        "needed_total", "instances", "instances_needing_nothing",
        "rounds")}, operations=census_ops(counts), bytes=nbytes,
        bound_ms=ms, bound_by=bound_by)


def pair_census_record(name, record, counts, nbytes):
    """The unit walk's census (tools/core_census.py ``corr_census`` or
    ``rows_census``: its (item, point) pairs by list) and its census bound
    over ``nbytes``, the bytes its kernel must move (tools ``pair_bytes``),
    into ``record``, whose bound it becomes; the 41-operation bound over
    the same bytes moves to ``ops41_*``.  No needed point may lie outside
    its item's need window."""
    ms, bound_by = census_bound(counts, nbytes)
    t_ops, t_bytes = record["operations"] / PEAK_OPS, nbytes / PEAK_BYTES
    print(f"{name} census: {counts['in_window']} in-window points, "
          f"{counts['needed_total']} needed {counts['needed']}, "
          f"{counts['visits']} point groups classified (lane-per-point: "
          f"{counts['parent_lane_evals']} lanes); census bound {ms:.6f} ms "
          f"({bound_by})")
    check(counts["needed_outside"] == 0, f"{name}: every needed point "
          "lies in its item's need window")
    record.update(ops41_bound_ms=max(t_ops, t_bytes) * 1e3,
                  ops41_bound_by="operations" if t_ops >= t_bytes
                  else "bytes",
                  ops41_operations=record["operations"])
    record.update(census={key: counts[key] for key in (
        "items", "items_by_class", "in_window", "needed", "needed_total",
        "instances", "instances_needing_nothing", "visits", "rows",
        "parent_lane_evals")}, operations=census_ops(counts),
        bytes=nbytes, bound_ms=ms, bound_by=bound_by)


def compare_kernel(torch, name, run, run_plain, record, reps=10, ops=None,
                   inputs=(), pieces=None, rcp=False, nbytes=None):
    """One kernel against its plain version on the same inputs: bit for
    bit, kernel ms (``reps`` after a warm-up) and plain ms (one rep after
    the call that gives the reference); with ``ops`` the record's bound
    over ``inputs`` and the output (or ``nbytes``), with ``pieces`` (a
    TilePieces or GroupWalk, or the dict of SegStreams.stats) its piece
    or stream counts; with ``rcp`` (a
    Lorentzian walk, ``ops`` its operations) its reciprocal floor at the
    SM clock nvidia-smi reads while it runs."""
    got = run()
    want = run_plain()
    torch.cuda.synchronize()
    rel, err = rel_diff(got, want, 1e-7)
    ms = kernel_ms(torch, run, reps)
    plain_ms = kernel_ms(torch, run_plain, 1, warm=False)
    record = {} if record is None else record
    record.update(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                  library_ms=None)
    if ops is not None:
        set_bound(record, ops, inputs, got, nbytes)
    split = ""
    if pieces is not None:
        stats = pieces if isinstance(pieces, dict) else pieces.stats()
        record.update(stats)
        split = ", " + ", ".join(f"{key} {value}"
                                 for key, value in stats.items())
    bound = (f", bound {record['bound_ms']:.6f} ms ({record['bound_by']}: "
             f"{record['operations']:.6e} operations, {record['bytes']} "
             "bytes)") if ops is not None else ""
    if rcp:
        mhz = sm_clock_mhz(run)
        record.update(sm_mhz=mhz, rcp_floor_ms=rcp_floor_ms(
            ops / OPS_LORENTZ, mhz))
        bound += (f", reciprocal floor {record['rcp_floor_ms']:.6f} ms at "
                  f"{mhz:.0f} MHz")
    print(f"{name}: shape {tuple(got.shape)}, max rel {rel:.3e}, max abs "
          f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{bound}"
          f"{split}")
    check(err == 0, f"{name} equals its plain version bit for bit")
    return got


def rows_deviation(torch, name, got, run_whole, records):
    """The rows core's recorded deviation from the JAX order: the
    kernel's piece-folded sums against the plain version with one running
    sum per point through the whole walk (``run_whole``), as a share of
    the maximum; held to 1e-6, the JAX rows test's tolerance."""
    whole = run_whole()
    scale = float(whole.double().abs().max())
    err = float((got.double() - whole.double()).abs().max())
    print(f"{name} deviation: piece-folded vs one running sum, max abs "
          f"{err:.3e} = {err / scale:.3e} of the maximum {scale:.3e}")
    records[name]["deviation_of_max"] = err / scale
    check(err <= 1e-6 * scale, f"{name} within 1e-6 of the maximum of the "
          "one-running-sum order")


def spectrum_parity(torch, label, got, want):
    """Float32 spectrum against the float64 plain one (floor 1e-6 of the
    maximum, as phase 6)."""
    rel, err = rel_diff(torch.as_tensor(np.asarray(got)),
                        torch.as_tensor(np.asarray(want)), 1e-6)
    print(f"{label}: vs float64 plain, max rel {rel:.3e}, max abs "
          f"{err:.3e}")
    check(rel < PARITY_TOL, f"{label} within {PARITY_TOL} of float64")


def headline_layer(fixtures, grid):
    """The headline pack (bench.py build_workload) and its surface layer's
    kernel inputs on ``grid``: (pack, kin, kernel arrays, n_per_v,
    num_points, kept lines)."""
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays

    pack = fixtures.synthetic_line_pack(
        num_lines=300000, nu_min=0.5, nu_max=5100.0, seed=1,
        band_centers=(150.0, 1600.0, 3700.0, 500.0))
    v0, vn, npv, n = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, CUT_OFF)
    params = line_profile_params(pack, *SURFACE, keep=keep)
    kin = kernel_inputs(params, v0, npv, CUT_OFF)
    return pack, kin, prepare_kernel_arrays(kin, npv, np.float32), npv, n, \
        keep


def check_spectrum(k, shape, label, pedestal):
    check(np.isfinite(k).all() and k.shape == shape,
          f"{label} finite, shape {shape}")
    if pedestal:
        check(k.max() > 0 and bool((k.reshape(-1, shape[-1]).sum(axis=1)
                                    > 0).all()),
              f"{label} positive: positive maximum and spectral integral")
    else:
        check(k.max() > 0 and k.min() >= -1e-6 * k.max(),
              f"{label} positive (non-negative to float32 round-off)")


def phase_gas(torch, P, lc, fixtures, records, card):
    """Phases 8 and 9: the single-layer Gas engine (``card``: the
    nvidia-smi name and power limit, printed with the headline rate)."""
    grid = np.arange(1.0, 5000.0, 0.1)
    pack, kin, arrays, npv, n, keep = headline_layer(fixtures, grid)
    check(n == 50000, "headline grid has 50,000 internal points")
    gas = P.Gas(pack, "H2O", device="cuda")
    gas64 = P.Gas(pack, "H2O", device="cuda", dtype=torch.float64,
                  backend="plain")
    lc.reset_launches()
    k, cold, _ = timed_call(
        torch, lambda: gas.absorption_coefficient(*SURFACE, grid))
    counts = dict(lc.LAUNCHES)
    again, warm, _ = timed_call(
        torch, lambda: gas.absorption_coefficient(*SURFACE, grid))
    k_ped, ped_wall, _ = timed_call(torch, lambda: gas.absorption_coefficient(
        *SURFACE, grid, remove_pedestal=True))
    print(f"phase 8 (300k-line H2O, 1 layer, 0.1 cm-1, {keep} lines kept): "
          f"wall cold {cold:.3f} s, warm {warm:.3f} s, warm with the "
          f"pedestal {ped_wall:.3f} s; launches {counts}")
    check(counts["wings_strided_single"] > 0
          and counts["core_segmix_single"] > 0,
          "phase 8 launched the single-layer strided wings and core")
    check(np.array_equal(k, again), "phase 8 repeat is bit-identical")
    check_spectrum(k, (n,), "phase 8 spectrum", False)
    check_spectrum(k_ped, (n,), "phase 8 spectrum with the pedestal", True)
    k64 = gas64.absorption_coefficient(*SURFACE, grid)
    spectrum_parity(torch, "phase 8", k, k64)
    spectrum_parity(torch, "phase 8 with the pedestal", k_ped,
                    gas64.absorption_coefficient(*SURFACE, grid,
                                                 remove_pedestal=True))

    plan = lc.make_device_plan(arrays, kin, n, npv, CUT_OFF, device="cuda")
    check(plan.wings_stride is not None and np.array_equal(
        plan().cpu().numpy().astype(np.float64), k),
        "the device plan gives the Gas spectrum (strided wings)")
    compare_kernel(torch, "wings_strided_single", plan.wings_pass,
                   lambda: plan.wings_pass(plain=True),
                   records["wings_strided_single"], reps=20,
                   ops=tile_ops(plan.soa, n, "pre"),
                   inputs=[plan.soa, plan.w_start, plan.w_n],
                   pieces=plan.wings_pieces, rcp=True)
    got = compare_kernel(torch, "core_segmix_single", plan.core_pass,
                         lambda: plan.core_pass(plain=True),
                         records["core_segmix_single"], reps=20,
                         ops=core_ops(plan.groups),
                         inputs=[plan.groups, *core_csr(plan.core,
                                                        plan.groups)],
                         pieces=plan.core.pieces)
    core_census_record("core_segmix_single", records["core_segmix_single"],
                       plan.groups, plan.core.t_start, plan.core.t_chunks,
                       got)
    for name in ("wings_strided_single", "core_segmix_single"):
        records[name]["launches"] = counts[name]
    lines_ms = kernel_ms(torch, plan, 20)
    evals = keep * ((2 * CUT_OFF + 1) * npv + 1)
    print(f"phase 8 headline rate: {evals} masked line-point evaluations "
          f"in {lines_ms:.4f} ms (device plan, CUDA events, warm) = "
          f"{evals / (lines_ms / 1e3):.6e} evaluations/s on {card}; over "
          f"the warm Gas wall {evals / warm:.6e}/s")

    # Phase 9: fine grid, no stride fits: raw-Lorentz splat wings.
    grid_f = np.arange(1.0, 1000.0, 0.01)
    _, kin_f, arrays_f, npv_f, n_f, keep_f = headline_layer(fixtures,
                                                           grid_f)
    lc.reset_launches()
    k9, wall9, _ = timed_call(
        torch, lambda: gas.absorption_coefficient(*SURFACE, grid_f))
    counts9 = dict(lc.LAUNCHES)
    print(f"phase 9 (0.01 cm-1, {n_f} points, {keep_f} lines kept): wall "
          f"{wall9:.3f} s; launches {counts9}")
    check(counts9["tile_lorentz"] > 0 and counts9["core_segmix_single"] > 0,
          "phase 9 launched the raw-Lorentz tile kernel and the core")
    check_spectrum(k9, (n_f,), "phase 9 spectrum", False)
    spectrum_parity(torch, "phase 9", k9,
                    gas64.absorption_coefficient(*SURFACE, grid_f))
    plan_f = lc.make_device_plan(arrays_f, kin_f, n_f, npv_f, CUT_OFF,
                                 device="cuda")
    check(plan_f.wings_stride is None, "0.01 cm-1 takes the splat wings")
    compare_kernel(torch, "tile_lorentz", plan_f.wings_pass,
                   lambda: plan_f.wings_pass(plain=True),
                   records["tile_lorentz"],
                   ops=tile_ops(plan_f.soa, n_f, "raw"),
                   inputs=[plan_f.soa, plan_f.w_start, plan_f.w_n],
                   pieces=plan_f.wings_pieces, rcp=True)
    records["tile_lorentz"]["launches"] = counts9["tile_lorentz"]
    got = compare_kernel(torch, "core_segmix_single at 0.01 cm-1",
                         plan_f.core_pass,
                         lambda: plan_f.core_pass(plain=True), None,
                         ops=core_ops(plan_f.groups),
                         inputs=[plan_f.groups,
                                 *core_csr(plan_f.core, plan_f.groups)],
                         pieces=plan_f.core.pieces)
    core_census_record("core_segmix_single at 0.01 cm-1", None,
                       plan_f.groups, plan_f.core.t_start,
                       plan_f.core.t_chunks, got)
    return gas, gas64, grid, kin, arrays, npv, n, plan, k64, k, \
        evals / (lines_ms / 1e3)


def phase_gas_batch(torch, lc, gas, gas64, grid, col):
    """Phase 10: the layer-batched Gas engine over a 16-layer column."""
    t = np.asarray(col["t"].data)
    p = np.asarray(col["p"].data)
    x = np.asarray(col["h2o"].data)
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launches()
    kb, cold, _ = timed_call(torch, lambda: gas.absorption_coefficient_batch(
        t, p, x, grid, remove_pedestal=True))
    counts = dict(lc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    again, warm, _ = timed_call(
        torch, lambda: gas.absorption_coefficient_batch(
            t, p, x, grid, remove_pedestal=True))
    (fn,) = gas._batched_fns.values()
    _, lines_s, lines_dev = timed_call(torch, lambda: fn(t, p, x))
    print(f"phase 10 (16 layers, 0.1 cm-1, pedestal removed): wall cold "
          f"{cold:.3f} s, warm {warm:.3f} s, peak device memory "
          f"{peak:.3f} GiB; launches {counts}")
    print(f"  stages (warm, s): batched pipeline {lines_s:.4f} (CUDA events "
          f"{lines_dev:.4f}), host transfer, pedestal and the rest "
          f"{warm - lines_s:.4f}")
    check(counts["wings_strided"] > 0 and counts["core_segmix"] > 0,
          "phase 10 launched the batched strided wings and core")
    check_spectrum(kb, (t.size, 50000), "phase 10 spectra", True)
    check(np.array_equal(kb, again), "phase 10 repeat is bit-identical")
    two = [0, t.size - 1]
    spectrum_parity(torch, "phase 10 (layers 0 and 15)", kb[two],
                    gas64.absorption_coefficient_batch(
                        t[two], p[two], x[two], grid, remove_pedestal=True))


def phase_formulations(torch, lc, kin, arrays, npv, n, plan, k64, records):
    """Phase 11: the A/B formulations of one headline layer."""
    from pylbl_tpu_torch.ops.lineshape import core_halfwidth
    from pylbl_tpu_torch.tools.core_census import corr_census

    def counted(fn):
        lc.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(lc.LAUNCHES)

    for label, kwargs, name, stage in (
            ("core_mode='seg'", {"core_mode": "seg"}, "seg_core", "core"),
            ("wings_mode='seg'", {"wings_mode": "seg"}, "seg_wings",
             "wings"),
            ("wings_mode='tile'", {"wings_mode": "tile"}, "tile_lorentz",
             "wings")):
        alt = lc.make_device_plan(arrays, kin, n, npv, CUT_OFF,
                                  device="cuda", **kwargs)
        out, counts = counted(alt)
        print(f"phase 11 {label}: launches {counts}")
        check(counts[name] > 0, f"{label} launched {name}")
        spectrum_parity(torch, f"phase 11 {label}",
                        out.cpu().numpy().astype(np.float64), k64)
        run = alt.core_pass if stage == "core" else alt.wings_pass
        own = name != "tile_lorentz"    # tile_lorentz's record is phase 9's
        nbytes = None
        if stage == "core":
            ops = core_ops(alt.groups)
            inputs = [alt.groups]
            nbytes = seg_bytes("core", alt.groups, alt.core.streams, n)
            pieces = alt.core.streams.stats("core")
        elif own:
            ops = OPS_LORENTZ * seg_wings_evals(alt.soa, alt.wings.streams)
            inputs = [alt.soa]
            nbytes = seg_bytes("wings", alt.soa, alt.wings.streams, n)
            pieces = alt.wings.streams.stats("wings")
        else:
            ops = tile_ops(alt.soa, n, "raw")
            inputs = [alt.soa, alt.w_start, alt.w_n]
            pieces = alt.wings_pieces
        got = compare_kernel(torch, name if own else f"{name} at 0.1 cm-1",
                             run, lambda: run(plain=True),
                             records[name] if own else None, ops=ops,
                             inputs=inputs, pieces=pieces,
                             rcp=stage == "wings", nbytes=nbytes)
        if own:
            check(torch.equal(run(), got), f"{name} repeat is "
                  "bit-identical")
            records[name]["launches"] = counts[name]
        if stage == "core":
            core_census_record(name, records[name], alt.groups,
                               alt.core.t_start, alt.core.t_chunks, got,
                               nbytes)

    # The scalar per-line core pass over the core-window CSR (the reference
    # the JAX tests hold the segment cores against), with the strided wings.
    soa = lc.pack_lines_soa(arrays, 512)[0]
    s = arrays["s_idx"].astype(np.int64)
    e = arrays["e_idx"].astype(np.int64)
    core_w = core_halfwidth(kin, npv, CUT_OFF)
    center = np.rint(arrays["c_int"]).astype(np.int64)
    c_start, c_n = (torch.as_tensor(a, device="cuda") for a in
                    lc.tile_line_ranges(np.maximum(center - core_w, s),
                                        np.minimum(center + core_w, e), n,
                                        1024, 512))
    soa = torch.as_tensor(soa, device="cuda")
    # The walk's pieces, built once as a plan builds them (without them
    # every call reads the CSR counts back to the host).
    c_pieces = lc.TilePieces.of_csr(c_n)

    def scalar_core(plain=False):
        if plain:
            return lc.tile_plain(soa, c_start, c_n, n, 1024, 512, "core")
        return lc.tile_pass(soa, c_start, c_n, n, 1024, 512, "core",
                            c_pieces)

    core, counts = counted(scalar_core)
    print(f"phase 11 scalar core (pass_kind='core'): launches {counts}")
    check(counts["tile_correction"] > 0, "scalar core launched "
          "tile_correction")
    spectrum_parity(torch, "phase 11 strided wings + scalar core",
                    (plan.wings_pass() + core).cpu().numpy()
                    .astype(np.float64), k64)
    compare_kernel(torch, "tile_correction", scalar_core,
                   lambda: scalar_core(plain=True),
                   records["tile_correction"],
                   ops=tile_ops(soa, n, "corr"),
                   inputs=[soa, c_start, c_n], pieces=c_pieces)
    check(torch.equal(scalar_core(), core), "tile_correction repeat is "
          "bit-identical")
    pair_census_record("tile_correction", records["tile_correction"],
                       corr_census(soa, c_start, c_n, 1024, 512),
                       pair_bytes("corr", soa, [c_start, c_n],
                                  core.shape[-1]))
    records["tile_correction"]["launches"] = counts["tile_correction"]

    # The single-layer strided wings on a two-class (tail) layout.
    lay = lc.build_strided_layout(s, plan.wings_stride, n, tail=128)
    ka = {k: lay.gather(v) for k, v in arrays.items()}
    for key, fill in (("prefactor", 0.0), ("s_idx", -1), ("e_idx", -2)):
        ka[key] = np.where(lay.dead, fill, ka[key]).astype(ka[key].dtype)
    soa_t = lc.pack_lines_soa(ka, 512)[0]
    soa_t[lc.PREF] = soa_t[lc.PREF] * soa_t[lc.Y] \
        * np.float32(1.0 / np.sqrt(np.pi))
    soa_t[lc.Y] = soa_t[lc.Y] * soa_t[lc.Y]
    soa_t = torch.as_tensor(soa_t, device="cuda")
    csr = [torch.as_tensor(a, device="cuda")
           for a in (lay.w_start, lay.w_n, lay.t_start, lay.t_n)]

    def tail_wings(plain=False):
        fn = lc.wings_strided_plain if plain else lc.wings_strided_pass
        return fn(soa_t, csr[0], csr[1], n, 1024, plan.wings_stride,
                  t_start=csr[2], t_n=csr[3], tail=128)

    wings, counts = counted(tail_wings)
    print(f"phase 11 tail layout ({int(lay.t_n.sum())} tail chunks): "
          f"launches {counts}")
    check(counts["wings_strided_tail_single"] == 1,
          "tail layout launched wings_strided_tail_single once")
    spectrum_parity(torch, "phase 11 tail wings + core",
                    (wings + plan.core_pass()).cpu().numpy()
                    .astype(np.float64), k64)
    compare_kernel(torch, "wings_strided_tail_single", tail_wings,
                   lambda: tail_wings(plain=True),
                   records["wings_strided_tail_single"],
                   ops=tile_ops(soa_t, n, "pre"),
                   inputs=[soa_t, *csr],
                   pieces=lc.TilePieces.of_csr(lay.w_n, lay.t_n), rcp=True)
    records["wings_strided_tail_single"]["launches"] = \
        counts["wings_strided_tail_single"]


def phase_rows(torch, lc, gas, gas64, grid, kin, arrays, npv, n, plan, k64,
               col, records):
    """Phase 12: the rows core (K9) and the ownership-checked strided wings
    (K6) on the headline layer and phase 10's column."""
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                      line_profile_params)
    from pylbl_tpu_torch.ops.lineshape import prepare_kernel_arrays
    from pylbl_tpu_torch.parallel.lines import make_batched_fn
    from pylbl_tpu_torch.tools import kernel_microbench, parity_ab
    from pylbl_tpu_torch.tools.core_census import rows_census
    from pylbl_tpu_torch.tools.wings_ab import straddle_inputs

    def exact(name, run, run_plain, **work):
        return compare_kernel(torch, name, run, run_plain, records[name],
                              **work)

    # The headline layer's rows device plans (strided and tile wings).
    rows_plans = {}
    for label, kwargs, wings in (("strided wings", {}, "wings_strided_single"),
                                 ("wings_mode='tile'", {"wings_mode": "tile"},
                                  "tile_lorentz")):
        alt = lc.make_device_plan(arrays, kin, n, npv, CUT_OFF, device="cuda",
                                  core_mode="rows", **kwargs)
        lc.reset_launches()
        out = alt()
        torch.cuda.synchronize()
        counts = dict(lc.LAUNCHES)
        print(f"phase 12 core_mode='rows', {label}: {alt.core.num_instances} "
              f"instance slots, launches {counts}")
        check(counts["core_rows_single"] > 0 and counts[wings] > 0,
              f"rows plan ({label}) launched core_rows_single and {wings}")
        check(torch.equal(alt(), out), f"rows plan ({label}) repeat is "
              "bit-identical")
        spectrum_parity(torch, f"phase 12 rows, {label}",
                        out.cpu().numpy().astype(np.float64), k64)
        if not rows_plans:
            exact("core_rows_single", alt.core_pass,
                  lambda: alt.core_pass(plain=True),
                  ops=rows_ops(alt.groups, alt.core.g_n, 1024),
                  inputs=[alt.groups, *alt.core.walk.tensors("cuda")],
                  pieces=alt.core.walk)
            walk = alt.core.walk.tensors("cuda")
            pair_census_record("core_rows_single",
                               records["core_rows_single"],
                               rows_census(alt.groups, *walk, 1024),
                               pair_bytes("rows", alt.groups, walk,
                                          out.shape[-1]))
            records["core_rows_single"]["launches"] = \
                counts["core_rows_single"]
        rows_plans[label] = alt
    alt = rows_plans["strided wings"]

    # The rows core with the separate min-y block: its plain version and
    # the rows kernel itself.
    groups = alt.groups
    ymin = lc.group_min_y(groups)
    g_start, g_n = alt.core.walk.tensors("cuda")

    def vmem(plain=False):
        if plain:
            return lc.rows_plain(groups, g_start, g_n, n, 1024, ymin=ymin)
        return lc.rows_vmem_pass(groups, ymin, alt.core.walk, n, 1024)

    got = exact("core_rows_vmem", vmem, lambda: vmem(True),
                ops=rows_ops(groups, alt.core.g_n, 1024),
                inputs=[groups, ymin, g_start, g_n],
                pieces=alt.core.walk)
    check(torch.equal(got, alt.core_pass()) and torch.equal(got, vmem()),
          "core_rows_vmem equals the rows kernel bit for bit and repeats "
          "bit for bit")
    pair_census_record("core_rows_vmem", records["core_rows_vmem"],
                       rows_census(groups, g_start, g_n, 1024, ymin[None]),
                       pair_bytes("rows_vmem", groups, [g_start, g_n],
                                  got.shape[-1]))
    rows_deviation(torch, "core_rows_single", got,
                   lambda: lc.rows_plain(groups, g_start, g_n, n, 1024,
                                         piece=1 << 30), records)

    # The checked strided wings on the headline layer's straddle CSR.
    stride = plan.wings_stride
    soa, (st, nc) = straddle_inputs(arrays, n, stride, "cuda")

    def checked(plain=False):
        fn = lc.wings_strided_checked_plain if plain \
            else lc.wings_strided_checked_pass
        return fn(soa, st, nc, n, 1024, stride)

    got = exact("wings_strided_checked_single", checked,
                lambda: checked(True), ops=tile_ops(soa, n, "own"),
                inputs=[soa, st, nc], pieces=lc.TilePieces.of_csr(nc),
                rcp=True)
    ref = plan.wings_pass()
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"phase 12 checked strided wings ({int(nc.sum())} chunk visits "
          f"on the straddle CSR, {int(plan.w_n.sum())} on the private "
          f"layout) vs the prepacked strided pass: max |diff| / max "
          f"{rel:.3e}")
    check(rel <= 1e-6, "checked strided wings within 1e-6 of the prepacked "
          "strided pass")

    # Phase 10's column through the batched pipeline with the rows core.
    t = np.asarray(col["t"].data)
    p = np.asarray(col["p"].data)
    x = np.asarray(col["h2o"].data)
    fn = make_batched_fn(gas.pack, grid, core_mode="rows", device="cuda")
    lc.reset_launches()
    kb, wall, dev = timed_call(torch, lambda: fn(t, p, x))
    counts = dict(lc.LAUNCHES)
    print(f"phase 12 make_batched_fn(core_mode='rows'), {t.size} layers: "
          f"wall {wall:.3f} s (CUDA events {dev:.4f} s), "
          f"{fn.core_plan.num_instances} instance slots; launches {counts}")
    check(counts["core_rows"] > 0 and counts["wings_strided"] > 0,
          "rows batch launched core_rows and the strided wings")
    check(torch.equal(fn(t, p, x), kb), "rows batch repeat is bit-identical")
    two = [0, t.size - 1]
    ref64 = gas64.absorption_coefficient_batch(t[two], p[two], x[two], grid)
    spectrum_parity(torch, "phase 12 rows batch (layers 0 and 15)",
                    kb[two].cpu().numpy().astype(np.float64), ref64)
    tt, pp, xx = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                  for a in (t, p, x))
    _, core = fn.stage.assemble(tt, pp, xx)
    got = exact("core_rows", lambda: fn.core_pass(core),
                lambda: fn.core_pass(core, plain=True),
                ops=rows_ops(core, fn.core_plan.g_n, 1024),
                inputs=[core, *fn.core_plan.walk.tensors("cuda")],
                pieces=fn.core_plan.walk)
    check(torch.equal(fn.core_pass(core), got), "core_rows at 16 layers "
          "repeats bit for bit")
    walk = fn.core_plan.walk.tensors("cuda")
    pair_census_record("core_rows", records["core_rows"],
                       rows_census(core, *walk, 1024),
                       pair_bytes("rows", core, walk, got.shape[-1]))
    records["core_rows"]["launches"] = counts["core_rows"]
    rows_deviation(torch, "core_rows", got,
                   lambda: lc.rows_plain(
                       core, *fn.core_plan.walk.tensors("cuda"), n, 1024,
                       piece=1 << 30), records)

    # The same column through the batched pipeline with the per-stream
    # segment core (the _seg_kernel_batched use).
    fn_seg = make_batched_fn(gas.pack, grid, core_mode="seg", device="cuda")
    lc.reset_launches()
    kb_seg, wall, dev = timed_call(torch, lambda: fn_seg(t, p, x))
    counts = dict(lc.LAUNCHES)
    print(f"phase 12 make_batched_fn(core_mode='seg'), {t.size} layers: "
          f"wall {wall:.3f} s (CUDA events {dev:.4f} s), "
          f"{fn_seg.core_plan.num_instances} instance slots; launches "
          f"{counts}")
    check(counts["seg_core"] > 0, "seg batch launched seg_core")
    check(torch.equal(fn_seg(t, p, x), kb_seg),
          "seg batch repeat is bit-identical")
    spectrum_parity(torch, "phase 12 seg batch (layers 0 and 15)",
                    kb_seg[two].cpu().numpy().astype(np.float64), ref64)
    _, core_seg = fn_seg.stage.assemble(tt, pp, xx)
    sixteen = {}
    seg_plan = fn_seg.core_plan
    nbytes = seg_bytes("core", core_seg, seg_plan.streams, n)
    got = compare_kernel(torch, "seg_core at 16 layers",
                         lambda: fn_seg.core_pass(core_seg),
                         lambda: fn_seg.core_pass(core_seg, plain=True),
                         sixteen, ops=core_ops(core_seg), inputs=[core_seg],
                         nbytes=nbytes)
    check(torch.equal(fn_seg.core_pass(core_seg), got),
          "seg_core at 16 layers repeats bit for bit")
    core_census_record("seg_core at 16 layers", sixteen, core_seg,
                       seg_plan.t_start, seg_plan.t_chunks, got, nbytes)
    sixteen.update(seg_plan.streams.stats("core", t.size))
    print(f"seg_core at 16 layers: {sixteen['chunks']} chunks a layer, the "
          f"grid {sixteen['core_blocks']} blocks a layer of "
          f"{sixteen['core_piece']} entries")
    records["seg_core"].update(launches_16_layers=counts["seg_core"], **{
        f"{key}_16_layers": sixteen[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "bytes", "operations",
            "census", "ops41_bound_ms", "ops41_operations", "core_piece",
            "core_blocks")})

    # The checked wings on two of the column's layers with one CSR, at the
    # batched pipeline's stride (its windows, widened by a wavenumber of
    # pressure shift, fit the tiles).
    keep = kin["s_idx"].shape[-1]
    stride = fn.wings_stride
    check(stride is not None, "the rows batch takes the strided wings")
    kin2 = kernel_inputs(line_profile_params(gas.pack, t[two], p[two],
                                             x[two], keep=keep),
                         internal_grid(grid)[0], npv, CUT_OFF)
    arrays2 = prepare_kernel_arrays(kin2, npv, np.float32)
    soa2, (st2, nc2) = straddle_inputs(arrays2, n, stride, "cuda")

    def checked2(plain=False):
        fn2 = lc.wings_strided_checked_plain if plain \
            else lc.wings_strided_checked_pass
        return fn2(soa2, st2, nc2, n, 1024, stride)

    lc.reset_launches()
    wings2 = checked2()
    torch.cuda.synchronize()
    records["wings_strided_checked"]["launches"] = \
        lc.LAUNCHES["wings_strided_checked"]
    exact("wings_strided_checked", checked2, lambda: checked2(True),
          ops=tile_ops(soa2, n, "own"), inputs=[soa2, st2, nc2],
          pieces=lc.TilePieces.of_csr(nc2), rcp=True)
    for b in range(2):
        one = lc.wings_strided_checked_pass(soa2[b], st2, nc2, n, 1024,
                                            stride)
        check(torch.equal(one, wings2[b]), f"batched checked wings layer {b} "
              "equals its single-layer launch")
    spectrum_parity(torch, "phase 12 batched checked wings + rows core "
                    "(layers 0 and 15)",
                    (wings2 + fn.core_pass(core)[two]).cpu().numpy()
                    .astype(np.float64), ref64)

    # The port's tools at the headline size.
    work = {"pack": gas.pack, "grid": grid, "kin": kin, "arrays": arrays,
            "npv": npv, "n": n, "keep": keep}
    lc.reset_launches()
    kernel_microbench.run(reps=5, work=work)
    counts = dict(lc.LAUNCHES)
    print(f"kernel_microbench launches {counts}")
    for name in ("core_rows_vmem", "wings_strided_checked_single"):
        check(counts[name] > 0, f"kernel_microbench launched {name}")
        records[name]["launches"] = counts[name]
    for core_mode, wings_mode, _, rel, _ in parity_ab.run(work=work):
        check(rel < PARITY_TOL, f"parity_ab core={core_mode} "
              f"wings={wings_mode} within {PARITY_TOL} of float64")


def optional_modules(names):
    """Whether each module imports on this host, with its version (a fact
    for the streaming layer, which writes through h5py, and for the ARTS
    bridge, which needs pyarts; not a check)."""
    import importlib

    found = []
    for name in names:
        try:
            module = importlib.import_module(name)
        except ImportError as exc:
            found.append(f"{name} does not import ({exc})")
        else:
            found.append(f"{name} {getattr(module, '__version__', '?')}")
    return "optional modules: " + ", ".join(found)


def device_busy_seconds(torch, prof):
    """Seconds in which a profiled region kept the card busy: the union of
    its device events' spans, or None when the profile holds none."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, spans[0][0]
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def phase_portable(torch, P, lc, db_path, gas, grid, k64, k_kernel, spec_a,
                   col, grid_a, card):
    """Phase 13: the portable two-pass backend (``backend="xla"``), the
    dtype spellings, the metrics and profiler hooks and the pack cache."""
    from pylbl_tpu_torch.models.lines import internal_grid
    from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn
    from pylbl_tpu_torch.utils.observability import metrics, profiler_trace

    v0, vn, npv, num_points = internal_grid(grid)
    keep = gas.pack.compat_break_filter(v0, vn, CUT_OFF)
    window = (2 * CUT_OFF + 1) * npv + 1
    metrics.reset()
    calls = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xla = P.Gas(gas.pack, "H2O", device="cuda", backend="xla")
    lc.reset_launches()
    k, cold, _ = timed_call(
        torch, lambda: xla.absorption_coefficient(*SURFACE, grid))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    again, warm, _ = timed_call(
        torch, lambda: xla.absorption_coefficient(*SURFACE, grid))
    calls += 2
    launches = sum(lc.LAUNCHES.values())
    gap, gap_abs = rel_diff(torch.as_tensor(k), torch.as_tensor(k_kernel),
                            1e-6)
    chunk_c = int(np.clip(2 ** int(np.log2(4.0e6 / window)), 128, 2048))
    steps_c = -(-keep // chunk_c)
    print(f"phase 13 C through Gas(backend='xla'), float32: wall cold "
          f"{cold:.4f} s, warm {warm:.4f} s ({steps_c} steps of {chunk_c} "
          f"lines, {warm / steps_c * 1e3:.4f} ms per step), peak device "
          f"memory above the resident {peak:.4f} GiB, hand-kernel launches "
          f"{launches}; gap to the kernel path's phase 8 spectrum: max rel "
          f"{gap:.3e}, max abs {gap_abs:.3e}")
    check(np.array_equal(k, again), "phase 13 C (xla) repeat is "
          "bit-identical")
    check_spectrum(k, k64.shape, "phase 13 C (xla) spectrum", False)
    spectrum_parity(torch, "phase 13 C (xla)", k, k64)

    spelled = P.Gas(gas.pack, "H2O", device="cuda", dtype=np.float32)
    check(spelled.backend == "kernel" and spelled.torch_dtype == torch.float32
          and spelled.dtype == np.float32,
          "Gas(dtype=np.float32) is the float32 kernel path")
    check(np.array_equal(spelled.absorption_coefficient(*SURFACE, grid),
                         k_kernel),
          "Gas(dtype=np.float32) equals torch.float32 bit for bit")
    calls += 1

    # A's 16 layers through the portable stacked pipeline.
    t = np.asarray(col["t"].data)
    p = np.asarray(col["p"].data)
    fn_kernel = stacked_fn(spec_a)
    x = np.stack([np.asarray(col[n.lower()].data) for n in fn_kernel.names],
                 axis=1)
    packs = {name: spec_a.cache[name].gas.pack for name in fn_kernel.names}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn = make_multigas_batched_fn(packs, grid_a, backend="xla",
                                  device="cuda")
    ka, cold_a, dev_a = timed_call(torch, lambda: fn(t, p, x))
    peak_a = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    again_a, warm_a, warm_dev_a = timed_call(torch, lambda: fn(t, p, x))
    _, kernel_a, kernel_dev_a = timed_call(torch, lambda: fn_kernel(t, p, x))
    core_w = min(128, (CUT_OFF + 1) * npv)
    points = t.size * lc.DEFAULT_CHUNK * (window + 2 * core_w + 1)
    v0a, vna, _, _ = internal_grid(grid_a)
    steps_a = -(-sum(pack.compat_break_filter(v0a, vna, CUT_OFF)
                     for pack in packs.values()) // lc.DEFAULT_CHUNK)
    print(f"phase 13 A through make_multigas_batched_fn(backend='xla'), "
          f"{t.size} layers: wall cold {cold_a:.4f} s (CUDA events "
          f"{dev_a:.4f}), warm {warm_a:.4f} s ({warm_dev_a:.4f}; {steps_a} "
          f"steps, {warm_a / steps_a * 1e3:.4f} ms per step); the kernel "
          f"pipeline warm {kernel_a:.4f} s ({kernel_dev_a:.4f}); peak device "
          f"memory above the resident {peak_a:.4f} GiB, "
          f"{peak_a * 2 ** 30 / points:.2f} bytes per candidate point of a "
          f"{lc.DEFAULT_CHUNK}-line step ({points} points) on {card}")
    check(torch.equal(ka, again_a), "phase 13 A (xla) repeat is "
          "bit-identical")
    check(tuple(ka.shape) == (t.size, len(packs), num_points)
          and bool(torch.isfinite(ka).all()),
          "phase 13 A (xla) finite, [16 layers, 7 gases, points]")
    two = [0, t.size - 1]
    fn64 = make_multigas_batched_fn(packs, grid_a, backend="plain",
                                    dtype=torch.float64, device="cuda")
    k64a = fn64(t[two], p[two], x[two])
    worst = max(rel_diff(ka[two, g], k64a[:, g], 1e-6)[0]
                for g in range(len(packs)))
    print(f"phase 13 A (xla) layers 0 and 15 vs the float64 plain path: "
          f"worst gas max rel {worst:.3e}")
    check(worst < PARITY_TOL, f"phase 13 A (xla) within {PARITY_TOL} of "
          "float64 on every gas")

    with profiler_trace(WORK / "trace") as prof:
        _, traced, _ = timed_call(
            torch, lambda: xla.absorption_coefficient(*SURFACE, grid))
    calls += 1
    traces = [f for f in (WORK / "trace").glob("*.pt.trace.json*")
              if f.stat().st_size > 0]
    busy = device_busy_seconds(torch, prof)
    share = "not measured (no device events)" if busy is None else \
        f"{busy:.4f} s busy, idle share {1 - busy / traced:.4f}"
    print(f"phase 13 profiler trace of one warm C call: {len(traces)} "
          f"file(s), {sum(f.stat().st_size for f in traces)} bytes; traced "
          f"wall {traced:.4f} s, device {share}")
    check(len(traces) >= 1, "profiler_trace wrote a trace file")

    snap = metrics.snapshot()
    print(f"phase 13 metrics: {json.dumps(snap, sort_keys=True)}; "
          f"lines.point_evals / lines.absorption seconds "
          f"{metrics.rate('lines.point_evals', 'lines.absorption'):.6e}/s")
    check(snap["timers"]["lines.absorption"]["calls"] == calls
          and snap["counters"] == {
              "lines.processed": calls * keep,
              "lines.point_evals": calls * keep * window,
              "lines.grid_points": calls * num_points},
          f"metrics count the phase's {calls} Gas calls")

    # The pack cache: sqlite once, then the npz.
    cache = WORK / "packs"
    for old in cache.glob("*.lpk.npz"):
        old.unlink()
    first, from_sqlite, _ = timed_call(torch, lambda: P.Database(
        db_path, pack_cache_dir=cache).line_pack("H2O"))
    second, from_npz, _ = timed_call(torch, lambda: P.Database(
        db_path, pack_cache_dir=cache).line_pack("H2O"))
    print(f"phase 13 pack cache, H2O ({first.num_lines} lines): sqlite "
          f"(and the npz written) {from_sqlite:.4f} s, npz {from_npz:.4f} s")
    check(second.meta["source"].endswith("H2O.lpk.npz") and all(
        np.array_equal(getattr(first, f), getattr(second, f))
        for f in first._ARRAY_FIELDS),
        "the npz pack equals the sqlite pack")


class MemoryWriter:
    """The streamed loop's writer in host memory (``pending_states`` and
    ``write_state`` of utils/streaming.py's StreamingWriter, no h5py):
    one float64 [state, mechanism, grid] array per variable, a completion
    vector and the order of the writes."""

    def __init__(self, names, num_states, shape, fill=np.nan):
        self.out = {name: np.full((num_states,) + shape, fill)
                    for name in names}
        self.complete = np.zeros(num_states, np.int8)
        self.writes = []

    def pending_states(self):
        return np.where(self.complete == 0)[0]

    def write_state(self, index, values):
        for name, out in self.out.items():
            out[index] = values[name]
        self.complete[index] = 1
        self.writes.append(index)


def phase_streamed(torch, P, lc, db, pack, records, card):
    """Phase 14: the streamed path at config-5 width through the block
    loop of ``compute_absorption_streamed`` into a MemoryWriter (no
    h5py), the CLI's ``info`` and the envelope tool."""
    from pylbl_tpu_torch.tools import envelope_compare
    from pylbl_tpu_torch.utils.observability import metrics

    start = time.perf_counter()
    grid = np.arange(*STREAM_GRID)
    col = column(STREAM_LAYERS, P.Dataset)
    spec = P.Spectroscopy(col, grid, db, device="cuda")
    names = [f"{n}_absorption" for n in spec.atmosphere.gases]
    shape = (len(spec.output.mechanisms), grid.size)

    def stream(writer, label):
        """One streamed pass, its launches counted from 0 and its stage
        timers from empty."""
        metrics.reset()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launches()
        _, wall, _ = timed_call(torch, lambda: spec._stream_blocks(
            writer, block_layers=STREAM_BLOCK))
        counts = dict(lc.LAUNCHES)
        timers = metrics.snapshot()["timers"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        blocks = timers["stream.write"]["calls"]
        split = ", ".join(
            f"{stage} {timers['stream.' + stage]['seconds']:.4f} s "
            f"({timers['stream.' + stage]['seconds'] / blocks:.4f} per "
            "block)" for stage in ("lines", "fetch", "mechanisms", "write"))
        print(f"phase 14 {label}: {len(writer.writes)} states of "
              f"{len(names)} gases x {grid.size} points in {blocks} "
              f"blocks of {STREAM_BLOCK}, wall {wall:.4f} s, peak device "
              f"memory {peak:.4f} GiB on {card}; stages (host clock): "
              f"{split}; launches {counts}")
        return counts

    cold = MemoryWriter(names, STREAM_LAYERS, shape)
    counts = stream(cold, f"cold pass ({STREAM_LAYERS} layers, "
                          f"{STREAM_GRID[2]} cm-1)")
    for name in ("wings_splat", "core_segmix"):
        check(counts[name] > 0, f"phase 14 launched {name}")
        records[name]["launches_streamed"] = counts[name]
    check(sorted(cold.writes) == list(range(STREAM_LAYERS))
          and cold.complete.all(), "phase 14 wrote every state once")
    warm = MemoryWriter(names, STREAM_LAYERS, shape)
    stream(warm, "warm pass")
    check(all(np.array_equal(warm.out[n], cold.out[n]) for n in names),
          "phase 14 warm pass equals the cold pass bit for bit")
    for name in GASES:
        check_spectrum(cold.out[f"{name}_absorption"][:, 0],
                       (STREAM_LAYERS, grid.size), f"phase 14 {name} lines",
                       True)
    total = sum(cold.out[n].sum(axis=1) for n in names)
    check(np.isfinite(total).all() and bool((total.sum(axis=1) > 0).all()),
          "phase 14 total finite, every layer's spectral integral > 0")

    # Layers 0 and the last through the in-memory path on a sub-column.
    ends = [0, STREAM_LAYERS - 1]
    two = sub_column(col, ends, P.Dataset)
    full, mem_s, _ = timed_call(torch, lambda: P.Spectroscopy(
        two, grid, db, device="cuda").compute_absorption(output_format="all"))
    gap = max(float(np.max(np.abs(cold.out[n][ends] - full[n].data)
                           / np.maximum(np.abs(full[n].data), 1e-300)))
              for n in names)
    print(f"phase 14 in-memory 'all' on layers {ends} ({mem_s:.4f} s, "
          f"cold): max rel gap to the streamed layers {gap:.3e}")
    check(gap <= 1e-12, f"phase 14 layers {ends} equal "
          "compute_absorption('all') on the 2-layer sub-column (rtol 1e-12)")

    # Resume: 12 states done and holding a sentinel, 4 pending.
    pending = [1, 6, 11, STREAM_LAYERS - 2]
    resumed = MemoryWriter(names, STREAM_LAYERS, shape, fill=-7.0)
    resumed.complete[:] = 1
    resumed.complete[pending] = 0
    stream(resumed, f"resume of states {pending}")
    done = np.setdiff1d(np.arange(STREAM_LAYERS), pending)
    check(resumed.writes == pending, "phase 14 resume computed only the "
          "pending states, in order")
    check(all(np.all(resumed.out[n][done] == -7.0) for n in names),
          "phase 14 resume left the sentinels untouched")
    check(all(np.array_equal(resumed.out[n][pending], cold.out[n][pending])
              for n in names),
          "phase 14 resumed states equal the full pass bit for bit")

    # The path's two kernels against their plain versions on the first
    # block's inputs.
    block = {"wings_splat": {}, "core_segmix": {}}
    phase_kernels(torch, lc, stacked_fn(spec), col, list(block), block,
                  layers=STREAM_BLOCK)
    for name, record in block.items():
        records[name].update({
            f"{key}_streamed_block": record[key] for key in (
                "ms", "plain_ms", "bound_ms", "rcp_floor_ms",
                "ops41_bound_ms") if key in record})

    # Float64 parity of the two end layers' totals (as phase 6), streamed
    # without the pedestal (one block of 2) and with it (the cold pass).
    raw = MemoryWriter(names, STREAM_LAYERS, shape)
    raw.complete[:] = 1
    raw.complete[ends] = 0
    spec._stream_blocks(raw, remove_pedestal=False, block_layers=STREAM_BLOCK)
    s64 = P.Spectroscopy(two, grid, db, device="cuda", dtype=torch.float64,
                         backend="plain")
    errors = {}
    for label, got, ped in (
            ("without the pedestal",
             sum(raw.out[n][ends].sum(axis=1) for n in names), False),
            ("with the pedestal", total[ends], True)):
        want = total_of(s64.compute_absorption(output_format="total",
                                               remove_pedestal=ped))
        rel, err = rel_diff(torch.as_tensor(got), torch.as_tensor(want),
                            1e-6)
        scale = np.abs(want).max()
        worst = np.unravel_index(np.argmax(
            np.abs(got - want) / np.maximum(np.abs(want), scale * 1e-6)),
            want.shape)
        print(f"phase 14 total, layers {ends}, {label}: vs float64 plain, "
              f"max rel {rel:.3e}, max abs {err:.3e} m-1 ({err / scale:.3e} "
              f"of the maximum {scale:.6e}); worst at layer "
              f"{ends[worst[0]]}, {grid[worst[1]]:.2f} cm-1: {got[worst]:.6e}"
              f" against {want[worst]:.6e}")
        errors[ped] = rel, err
    check(errors[False][0] < PARITY_TOL, f"phase 14 totals without the "
          f"pedestal within {PARITY_TOL} of float64")
    check(errors[True][1] <= 1.1 * errors[False][1], "phase 14: the host "
          "float64 pedestal adds no float32 error of its own (max abs "
          "error with it within 1.1x of that without)")

    # The command line's info, as a user runs it.
    info = subprocess.run([sys.executable, "-m", "pylbl_tpu_torch", "info"],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    print("phase 14 `python -m pylbl_tpu_torch info`:\n  "
          + "\n  ".join(info.stdout.strip().splitlines()))
    check(info.returncode == 0
          and torch.cuda.get_device_name(0) in info.stdout,
          "`python -m pylbl_tpu_torch info` exits 0 and names the card")

    # The envelope tool at the headline size (300k lines, 4 layers).
    report = envelope_compare.run(pack=pack)
    default, derived = (report[k] for k in ("default_350K_5atm", "derived"))
    check(0 < derived["core_instances"] <= default["core_instances"]
          and np.isfinite(report["speedup"]),
          "envelope_compare: the derived envelope plans no more core "
          "instances")
    print(f"phase 14 took {time.perf_counter() - start:.1f} s")


def digest(array):
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def shard_kernels(torch, lc, step, t, p, x, timed):
    """This rank's first stop (its own block, its rows): the strided wings
    and the mixed-slot core against their plain versions, bit for bit;
    with ``timed`` the kernel records (ms, plain ms, bound)."""
    stage, soa, core = step.kernel_inputs(t, p, x)
    if not timed:
        return [bool(torch.equal(stage.wings_pass(soa),
                                 stage.wings_pass(soa, plain=True))),
                bool(torch.equal(stage.core_pass(core),
                                 stage.core_pass(core, plain=True)))], None
    records = {"wings_strided": {}, "core_segmix": {}}
    n_out = stage.n_out
    compare_kernel(torch, "phase 15 shard wings_strided",
                   lambda: stage.wings_pass(soa),
                   lambda: stage.wings_pass(soa, plain=True),
                   records["wings_strided"], reps=10,
                   ops=tile_ops(soa, n_out, "pre"), inputs=[soa], rcp=True)
    got = compare_kernel(torch, "phase 15 shard core_segmix",
                         lambda: stage.core_pass(core),
                         lambda: stage.core_pass(core, plain=True),
                         records["core_segmix"], reps=10,
                         ops=core_ops(core),
                         inputs=[core, *core_csr(stage.core_plan, core)])
    core_census_record("phase 15 shard core_segmix", records["core_segmix"],
                       core, stage.core_plan.t_start,
                       stage.core_plan.t_chunks, got)
    return [True, True], records


def phase15_rank(db_path, cache_dir):
    """One rank of phase 15 (a spawned process; four of them share the
    card over gloo): per mode the sharded column cold and warm, its
    launches, moved bytes and peak memory, its first stop's kernels
    against their plain versions; then the streamed loop and the portable
    branch.  Rank 0 returns the arrays the parent gates, every rank their
    digests."""
    import torch
    import torch.distributed as dist

    import pylbl_tpu_torch as P
    from pylbl_tpu_torch.ops import lineshape_cuda as lc
    from pylbl_tpu_torch.parallel import collectives
    from pylbl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(batch=SHARD_MESH[0], spec=SHARD_MESH[1])
    db = P.Database(db_path, pack_cache_dir=cache_dir)
    grid = np.arange(1.0, 5000.0, 0.1)
    col = column(16, P.Dataset)
    t = np.asarray(col["t"].data)
    p = np.asarray(col["p"].data)
    lead = mesh.rank == 0
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "transport": mesh.transport, "backend": mesh.backend,
           "modes": {}}
    for mode in SHARD_MODES:
        spec = P.Spectroscopy(col, grid, db, mesh=mesh, sharding_mode=mode)
        lc.reset_launches()
        collectives.reset_bytes()
        torch.cuda.reset_peak_memory_stats()
        cold, cold_s, _ = timed_call(torch, lambda: total_of(
            spec.compute_absorption(output_format="total")))
        launches = dict(lc.LAUNCHES)
        moved = dict(collectives.BYTES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        warm, warm_s, _ = timed_call(torch, lambda: total_of(
            spec.compute_absorption(output_format="total")))
        fn = stacked_fn(spec)
        x = np.stack([np.asarray(spec.atmosphere.gases[n].data, np.float64)
                      for n in fn.names], axis=1)
        equal, _ = shard_kernels(torch, lc, fn.step, t, p, x, False)
        dist.barrier()
        timing = shard_kernels(torch, lc, fn.step, t, p, x, True)[1] \
            if lead and mode == "balanced" else None
        dist.barrier()
        info = {k: fn.info[k] for k in ("duplication", "block_len",
                                        "ring_steps", "local_points")}
        out["modes"][mode] = {
            "backend": fn.step.backend, "stride": fn.step.stride,
            "info": info, "launches": {k: v for k, v in launches.items()
                                       if v},
            "bytes": moved, "peak_gib": peak, "cold_s": cold_s,
            "warm_s": warm_s, "digest": digest(cold),
            "warm_equal": bool(np.array_equal(cold, warm)), "equal": equal,
            "total": cold if lead else None, "kernels": timing}

    # The streamed loop in blocks of 4, rank 0 writing into memory.
    spec = P.Spectroscopy(col, grid, db, mesh=mesh)
    names = [f"{n}_absorption" for n in spec.atmosphere.gases]
    shape = (len(spec.output.mechanisms), grid.size)
    writer = MemoryWriter(names, 16, shape) if lead else None
    lc.reset_launches()
    _, stream_s, _ = timed_call(torch, lambda: spec._stream_blocks(
        writer, block_layers=STREAM_BLOCK))
    stream = {"wall_s": stream_s, "launches": {
        k: v for k, v in lc.LAUNCHES.items() if v}}
    ends = [0, 15]
    full = P.Spectroscopy(sub_column(col, ends, P.Dataset), grid, db,
                          mesh=mesh).compute_absorption(output_format="all")
    if lead:
        stream["writes"] = sorted(writer.writes)
        stream["gap"] = max(float(np.max(
            np.abs(writer.out[n][ends] - full[n].data)
            / np.maximum(np.abs(full[n].data), 1e-300))) for n in names)
    out["stream"] = stream

    # The portable branch on 2 layers.
    two = P.Spectroscopy(sub_column(col, ends, P.Dataset), grid, db,
                         mesh=mesh, backend="xla")
    lc.reset_launches()
    xla, xla_s, _ = timed_call(torch, lambda: total_of(
        two.compute_absorption(output_format="total")))
    out["xla"] = {"wall_s": xla_s, "backend": stacked_fn(two).step.backend,
                  "launches": sum(lc.LAUNCHES.values()),
                  "digest": digest(xla), "total": xla if lead else None}
    return out


def phase_sharded(torch, P, lc, db, db_path, col_a, grid_a, total_a, want64,
                  records):
    """Phase 15: the sharded path at A's width on ranks that share the
    card (2x2 over gloo), then a single-rank NCCL mesh."""
    import torch.distributed as dist

    from pylbl_tpu_torch.parallel import distributed, launch
    from pylbl_tpu_torch.parallel.mesh import make_mesh
    from pylbl_tpu_torch.runtime import build

    start = time.perf_counter()
    cache = WORK / "packs"
    loaded = P.Database(db_path, pack_cache_dir=cache)
    for name in GASES:
        loaded.line_pack(name)       # the npz cache every rank reads
    libs = sorted(build.BUILD_DIR.glob("*.so"))
    before = {lib.name: (lib.stat().st_ino, lib.stat().st_mtime_ns)
              for lib in libs}
    ranks = SHARD_MESH[0] * SHARD_MESH[1]
    t0 = time.perf_counter()
    with launch.RankGroup(ranks, backend="gloo", timeout=600,
                          threads=2) as group:
        spawn_s = time.perf_counter() - t0
        outs = group.run_all(phase15_rank, str(db_path), str(cache))
    after = {lib.name: (lib.stat().st_ino, lib.stat().st_mtime_ns)
             for lib in libs}
    print(f"phase 15: {ranks} gloo ranks on {outs[0]['device']} "
          f"(transport {outs[0]['transport']}), started in {spawn_s:.2f} s")
    check(before == after and len(before) == 2, "phase 15 ranks loaded the "
          "parent's build (the build directory was not rewritten)")
    check(all(o["device"] == "cuda:0" and o["backend"] == "gloo"
              for o in outs), "phase 15 every rank on cuda:0 over gloo")
    two = [0, 15]
    for mode in SHARD_MODES:
        per = [o["modes"][mode] for o in outs]
        lead = per[0]
        total = lead["total"]
        print(f"phase 15 {mode}: step {lead['backend']} (stride "
              f"{lead['stride']}), info {lead['info']}; rank 0 wall cold "
              f"{lead['cold_s']:.4f} s, warm {lead['warm_s']:.4f} s")
        for rank, r in enumerate(per):
            print(f"  rank {rank}: launches {r['launches']}, peak "
                  f"{r['peak_gib']:.4f} GiB, bytes sent {r['bytes']}")
        check(all(r["backend"] == "kernel" for r in per),
              f"phase 15 {mode}: step.backend == 'kernel'")
        check(all(r["launches"].get("wings_strided", 0) > 0
                  and r["launches"].get("core_segmix", 0) > 0 for r in per),
              f"phase 15 {mode}: every rank launched wings_strided and "
              "core_segmix")
        check(len({r["digest"] for r in per}) == 1,
              f"phase 15 {mode}: all ranks' totals bit-identical")
        check(all(r["warm_equal"] for r in per),
              f"phase 15 {mode}: warm repeat bit-identical")
        check(all(r["equal"] == [True, True] for r in per),
              f"phase 15 {mode}: each shard's wings and core equal their "
              "plain versions bit for bit")
        check(np.isfinite(total).all() and total.shape == total_a.shape,
              f"phase 15 {mode}: total finite, [16 layers, grid]")
        rel, err = rel_diff(torch.as_tensor(total[two]),
                            torch.as_tensor(want64), 1e-6)
        gap, gap_abs = rel_diff(torch.as_tensor(total),
                                torch.as_tensor(total_a), 1e-6)
        print(f"  layers {two} vs float64 plain: max rel {rel:.3e}, max abs "
              f"{err:.3e}; gap to phase 3's unsharded total: max rel "
              f"{gap:.3e}, max abs {gap_abs:.3e}")
        check(rel < PARITY_TOL, f"phase 15 {mode}: layers {two} within "
              f"{PARITY_TOL} of float64")
        for name in ("wings_strided", "core_segmix"):
            records[name].setdefault("launches_sharded", {})[mode] = [
                r["launches"].get(name, 0) for r in per]
        if lead["kernels"]:
            for name, rec in lead["kernels"].items():
                records[name].update({
                    f"{key}_shard": rec[key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "rcp_floor_ms", "ops41_bound_ms") if key in rec})
    stream = outs[0]["stream"]
    print(f"phase 15 streamed under the mesh (blocks of {STREAM_BLOCK}): "
          f"rank 0 wall {stream['wall_s']:.4f} s, launches "
          f"{stream['launches']}; layers {two} against the sharded 'all' "
          f"output: max rel gap {stream['gap']:.3e}")
    check(stream["writes"] == list(range(16)), "phase 15 rank 0 wrote every "
          "state once")
    check(stream["gap"] <= 1e-12, f"phase 15 streamed layers {two} equal "
          "the sharded compute_absorption('all') (rtol 1e-12)")
    xla = outs[0]["xla"]
    rel, err = rel_diff(torch.as_tensor(xla["total"]),
                        torch.as_tensor(want64), 1e-6)
    print(f"phase 15 portable branch (backend='xla'), layers {two}: rank 0 "
          f"wall {xla['wall_s']:.4f} s, step {xla['backend']}, launches "
          f"{xla['launches']}; vs float64 plain max rel {rel:.3e}")
    check(xla["backend"] == "xla" and len({o["xla"]["digest"]
                                           for o in outs}) == 1,
          "phase 15 portable branch ran, the same bits on every rank")
    check(rel < PARITY_TOL, f"phase 15 portable branch within {PARITY_TOL} "
          "of float64")

    # NCCL: two ranks on one card are refused; one rank runs.
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        distributed.check_nccl_devices()
        refused = False
    except RuntimeError:
        refused = True
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    check(refused, "NCCL with two ranks on one card raises")
    distributed.initialize(init_method=f"tcp://localhost:{launch.free_port()}",
                           world_size=1, rank=0, backend="nccl")
    try:
        mesh = make_mesh(batch=1, spec=1)
        spec = P.Spectroscopy(col_a, grid_a, db, mesh=mesh)
        cold, cold_s, _ = timed_call(torch, lambda: total_of(
            spec.compute_absorption(output_format="total")))
        warm, warm_s, _ = timed_call(torch, lambda: total_of(
            spec.compute_absorption(output_format="total")))
        gap, gap_abs = rel_diff(torch.as_tensor(cold),
                                torch.as_tensor(total_a), 1e-6)
        print(f"phase 15 NCCL 1x1 (balanced, transport {mesh.transport}): "
              f"wall cold {cold_s:.4f} s, warm {warm_s:.4f} s; gap to phase "
              f"3: max rel {gap:.3e}, max abs {gap_abs:.3e}")
        check(mesh.backend == "nccl" and np.array_equal(cold, warm)
              and stacked_fn(spec).step.backend == "kernel",
              "phase 15 NCCL mesh ran the kernels, warm equal to cold")
    finally:
        dist.destroy_process_group()
    print(f"phase 15 took {time.perf_counter() - start:.1f} s")


def phase_ingest(torch, P, lc, native, packs, db_a, col_a, grid_a, total_a,
                 records):
    """Phase 16: phase 3's packs through ``Database.create`` from stand-in
    clients, then the main path on the ingested database."""
    start = time.perf_counter()
    hitran, tips = HitranStandIn(packs), TipsStandIn(packs)
    render_s = time.perf_counter() - start
    path = WORK / "ingest.db"
    if path.exists():
        path.unlink()
    db = P.Database(path)
    profile = cProfile.Profile()
    t0 = time.perf_counter()
    profile.runcall(db.create, hitran, "all", tips_webapi=tips,
                    cross_section_directory=None)
    create_s = time.perf_counter() - t0
    text = hitran.texts["H2O"]
    t0 = time.perf_counter()
    parsed = native.parse_transitions_csv(text)
    parse_s = time.perf_counter() - t0
    rows = sum(pack.num_lines for pack in packs.values())
    csv_bytes = sum(len(t) for t in hitran.texts.values())
    print(f"phase 16 ingest: {rows} transition rows of {len(packs)} gases, "
          f"CSV {csv_bytes} bytes (rendered by the stand-in in "
          f"{render_s:.4f} s); Database.create wall {create_s:.4f} s "
          f"(under cProfile); native parse of H2O's {len(text)} bytes in "
          f"{parse_s:.4f} s, {parsed['nu'].size / parse_s:.6e} rows/s")
    print("  Database.create, cumulative seconds by function:")
    pstats.Stats(profile, stream=sys.stdout).sort_stats(
        "cumulative").print_stats(10)
    check(parsed["nu"].size == packs["H2O"].num_lines and rows == 420000,
          "phase 16 parsed every row of H2O's text (420k rows in all)")
    t0 = time.perf_counter()
    ingested = {name: db.line_pack(name) for name in packs}
    print(f"phase 16 cold line_pack of {len(packs)} gases from sqlite: "
          f"{time.perf_counter() - t0:.4f} s")
    unequal = [f"{name}.{field}" for name in packs for field in PACK_ARRAYS
               if not np.array_equal(getattr(ingested[name], field),
                                     getattr(db_a.line_pack(name), field))]
    check(not unequal, f"phase 16 every ingested pack equals phase 3's, "
          f"{len(PACK_ARRAYS)} arrays x {len(packs)} gases {unequal}")

    lc.reset_launches()
    spec, total, wall, dev, peak = phase_main(
        torch, P, db, col_a, grid_a,
        "phase 16 (ingested database, A: 0.1 cm-1, 16 layers, cold)")
    launches = dict(lc.LAUNCHES)
    check(launches["wings_strided"] > 0 and launches["core_segmix"] > 0,
          f"phase 16 launched the strided wings and core kernels "
          f"{ {k: v for k, v in launches.items() if v} }")
    for name in ("wings_strided", "core_segmix"):
        records[name]["launches_ingest"] = launches[name]
    check(np.array_equal(total, total_a),
          "phase 16 total equals phase 3's bit for bit")
    again, wall_w, dev_w = timed_call(
        torch, lambda: spec.compute_absorption(output_format="total"))
    print(f"phase 16 again (warm): wall {wall_w:.4f} s (CUDA events "
          f"{dev_w:.4f} s)")
    check(np.array_equal(total_of(again), total_a),
          "phase 16 warm total equals phase 3's bit for bit")
    print(f"phase 16 took {time.perf_counter() - start:.1f} s")


def flagged(value):
    """The strings in a bench record that mark a failed, skipped or
    invalid measurement."""
    if isinstance(value, dict):
        return [f for v in value.values() for f in flagged(v)]
    if isinstance(value, list):
        return [f for v in value for f in flagged(v)]
    if isinstance(value, str) and (value.startswith(("error", "skipped"))
                                   or "invalid" in value):
        return [value]
    return []


def layer_pair(dataset, names):
    """Layers 0 and 15 of ``dataset`` as (t, p, x[2, G]) in ``names``
    order."""
    t = np.asarray(dataset["t"].data)[[0, -1]]
    p = np.asarray(dataset["p"].data)[[0, -1]]
    x = np.stack([np.asarray(dataset[n.lower()].data)[[0, -1]]
                  for n in names], axis=1)
    return t, p, x


def phase_wings_chunk(torch, lc, packs, spec, two, grid, label, ref64,
                      wings, records):
    """Phase 18.1/18.2: the stacked pipeline of phase 3 or 4 (``spec``: its
    kernel envelope) at ``wings_chunk=128``: its launches and lines total
    on layers 0 and 15 (``two``) against the float64 plain pipeline
    ``ref64``, its two kernels against their plain versions on phase 5's
    inputs (the first two layers of ``spec``'s column), beside phase 5's
    records.  Each bound counts the operations (``tools.tile_ops``) of its
    own layout's SoA: a strided layout copies a line into every tile its
    window reaches, so the count moves with the chunk."""
    from pylbl_tpu_torch.parallel import make_multigas_batched_fn

    t_max, p_max_atm = spec._envelope
    fn = make_multigas_batched_fn(packs, grid, t_max=t_max,
                                  p_max_atm=p_max_atm,
                                  wings_chunk=WINGS_CHUNK, device="cuda")
    check(fn.wings_chunk == WINGS_CHUNK and (fn.wings_stride is not None)
          == (wings == "wings_strided"), f"phase 18 {label}: {wings} at "
          f"wings_chunk {fn.wings_chunk} (stride {fn.wings_stride})")
    if wings == "wings_strided":
        check(fn.wings_tail_csr is not None,
              f"phase 18 {label}: the strided layout has the tail class")
    t, p, x = layer_pair(two, fn.names)
    lc.reset_launches()
    total = fn.total(t, p, x)
    torch.cuda.synchronize()
    counts = dict(lc.LAUNCHES)
    print(f"phase 18 {label} (wings_chunk {WINGS_CHUNK}): launches {counts}")
    check(counts[wings] > 0 and counts["core_segmix"] > 0,
          f"phase 18 {label} launched {wings} and core_segmix")
    chunked = {f"{wings} at wings_chunk {WINGS_CHUNK}": {},
               f"core_segmix at wings_chunk {WINGS_CHUNK}": {}}
    phase_kernels(torch, lc, fn, spec.atmosphere.dataset, list(chunked),
                  chunked)
    got = chunked[f"{wings} at wings_chunk {WINGS_CHUNK}"]
    base = records[wings]
    print(f"  {wings}: {got['ms']:.4f} ms at chunk {WINGS_CHUNK} (bound "
          f"{got['bound_ms']:.6f} ms, {got['operations']:.6e} operations, "
          f"reciprocal floor {got['rcp_floor_ms']:.6f} ms), "
          f"{base['ms']:.4f} ms at phase 5's chunk (bound "
          f"{base['bound_ms']:.6f} ms, {base['operations']:.6e} "
          f"operations, reciprocal floor {base['rcp_floor_ms']:.6f} ms)")
    base.update({f"{key}_wings_chunk_{WINGS_CHUNK}": got[key]
                 for key in ("ms", "plain_ms", "bound_ms", "operations",
                             "bytes", "rcp_floor_ms")})
    base[f"launches_wings_chunk_{WINGS_CHUNK}"] = counts[wings]
    rel, err = rel_diff(total, ref64.total(*layer_pair(two, ref64.names)),
                        1e-6)
    print(f"  lines total vs float64 plain: max rel {rel:.3e}, max abs "
          f"{err:.3e} m-1")
    check(rel < PARITY_TOL, f"phase 18 {label} lines total within "
          f"{PARITY_TOL} of float64")


def phase_installed(torch, k_c):
    """Phase 18.3: the package copied alone, its build in the user cache
    (``can_write`` reports the copy's parent unwritable), the headline
    layer's spectrum equal to phase 8's."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as site, \
            tempfile.TemporaryDirectory() as cache, \
            tempfile.TemporaryDirectory() as out:
        site, cache, out = Path(site), Path(cache), Path(out)
        shutil.copytree(ROOT / "pylbl_tpu_torch", site / "pylbl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        before = sorted(str(q) for q in site.rglob("*"))
        env = dict(os.environ, XDG_CACHE_HOME=str(cache))
        args = {"root": str(site), "surface": SURFACE,
                "out": str(out / "k.npy")}
        start = time.perf_counter()
        done = subprocess.run([sys.executable, "-I", "-B", "-c", INSTALLED,
                               json.dumps(args)], capture_output=True,
                              text=True, timeout=600, env=env, cwd=out)
        wall = time.perf_counter() - start
        check(done.returncode == 0, "phase 18 the lone copy ran (exit "
              f"{done.returncode}: {done.stderr[-800:]})")
        got = json.loads(done.stdout.strip().splitlines()[-1])
        print(f"phase 18 installed layout ({wall:.1f} s, both builds "
              f"included): {json.dumps(got)}")
        check(got["build_dir"] == str(cache / "pylbl_tpu_torch")
              and got["libs"] == ["liblineshape_cuda.so",
                                  "libpylbl_native.so"],
              "phase 18 both libraries built into $XDG_CACHE_HOME")
        check(Path(got["package"]).parent == site / "pylbl_tpu_torch"
              and not got["refused"],
              "phase 18 ran the copy, importing neither jax nor pylbl_tpu")
        check(got["launches"].get("wings_strided_single", 0) > 0
              and got["launches"].get("core_segmix_single", 0) > 0,
              "phase 18 the copy launched the single-layer kernels")
        check(sorted(str(q) for q in site.rglob("*")) == before,
              "phase 18 nothing was written beside or into the copy")
        check(np.array_equal(np.load(out / "k.npy"), k_c),
              "phase 18 the copy's spectrum equals phase 8's bit for bit")


def phase_compat(torch, P, lc, pack, grid, col, k_c):
    """Phase 18.4: the JAX positional calls: ``Gas(pack, formula,
    dtype)`` and ``make_batched_tpu_fn``."""
    from pylbl_tpu_torch.parallel import (make_batched_fn,
                                          make_batched_tpu_fn)

    lc.reset_launches()
    k = P.Gas(pack, "H2O", np.float32).absorption_coefficient(*SURFACE,
                                                              grid)
    counts = dict(lc.LAUNCHES)
    print(f"phase 18 Gas(pack, 'H2O', np.float32): launches {counts}")
    check(counts["wings_strided_single"] > 0
          and counts["core_segmix_single"] > 0,
          "phase 18 the positional dtype ran the single-layer kernels")
    check(np.array_equal(k, k_c), "phase 18 Gas(pack, 'H2O', np.float32) "
          "equals phase 8 bit for bit")
    t, p, x = (np.asarray(col[n].data)[[0, -1]] for n in ("t", "p", "h2o"))
    tpu = make_batched_tpu_fn(pack, grid, CUT_OFF, None, None, 350.0, 5.0,
                              False)
    lc.reset_launches()
    got = tpu(t, p, x)
    torch.cuda.synchronize()
    counts = dict(lc.LAUNCHES)
    print(f"phase 18 make_batched_tpu_fn (interpret=False by position): "
          f"launches {counts}")
    check(counts["wings_strided"] > 0 and counts["core_segmix"] > 0,
          "phase 18 make_batched_tpu_fn launched the batched kernels")
    check(torch.equal(got, make_batched_fn(pack, grid)(t, p, x)),
          "phase 18 make_batched_tpu_fn equals make_batched_fn bit for "
          "bit")


def bits_equal(torch, got, want):
    """NaN where ``want`` has NaN, every other bit equal."""
    nan = torch.isnan(want)
    return got.shape == want.shape and torch.equal(torch.isnan(got), nan) \
        and torch.equal(got[~nan].view(torch.int32),
                        want[~nan].view(torch.int32))


def phase_nonfinite(torch, lc):
    """Phase 19: every kernel on a small poisoned input
    (``pylbl_tpu_torch/tools/nonfinite.py``), held to its plain version bit
    for bit, a repeat too; then CORR and the rows core on the NaN-y
    inputs."""
    from pylbl_tpu_torch.tools.nonfinite import (KERNEL_CASES, family_case,
                                                 nan_y_corr, nan_y_rows)

    start = time.perf_counter()
    cases = [family_case(f, n, "cuda") for f, n in KERNEL_CASES]
    cases += [nan_y_corr(1, "cuda"), nan_y_corr(2, "cuda"),
              nan_y_rows(1, "cuda"), nan_y_rows(2, "cuda"),
              nan_y_rows(1, "cuda", vmem=True)]
    lc.reset_launches()
    for case in cases:
        before = lc.LAUNCHES[case.counter]
        got, again = case.run(), case.run()
        want = case.plain()
        torch.cuda.synchronize()
        nan = int(torch.isnan(want).sum())
        inf = int(torch.isinf(want).sum())
        check(lc.LAUNCHES[case.counter] == before + 2
              and bits_equal(torch, got, want)
              and bits_equal(torch, again, got),
              f"phase 19 {case.counter} ({case.family}, {case.layers} "
              f"layer(s), {nan} NaN and {inf} infinite points of "
              f"{want.numel()}) equals its plain version bit for bit, "
              "repeat too")
    launches = dict(lc.LAUNCHES)
    check(set(launches) == set(KERNELS) and all(launches.values()),
          f"phase 19 ran every kernel on poisoned lines: {launches}")
    print(f"phase 19 took {time.perf_counter() - start:.1f} s")


def pedestal_terms(torch, ka):
    """The endpoint terms kernel A computes: each (layer, bucket) walks its
    segment twice, a term for each line whose window holds the endpoint of
    that walk."""
    s, e = ka["s_idx"].long(), ka["e_idx"].long()
    batch = s.shape[0]
    lo, hi = ka["seg_lo"].long(), ka["seg_hi"].long()
    total = 0
    for m in range(int((hi - lo).max())):
        j = (lo + m).clamp(max=s.shape[1] - 1).expand(batch, -1)
        valid = (lo + m < hi).expand(batch, -1)
        for point in (ka["p_s"].long(), ka["p_e"].long()):
            total += int((valid & (s.gather(1, j) <= point)
                          & (e.gather(1, j) >= point)).sum())
    return total


def pedestal_record(record, got, want, ms, plain_ms, ops, nbytes, exact):
    """A pedestal kernel's record against its plain version's outputs
    (tuples of tensors), its bound at the float64 peak and the bytes."""
    errs = [(float((g.double() - w.double()).abs().max()),
             float(w.double().abs().max())) for g, w in zip(got, want)]
    err = max(e for e, _ in errs)
    rel = max(e / scale if scale else e for e, scale in errs)
    t_ops, t_bytes = ops / PEAK_FP64, nbytes / PEAK_BYTES
    record.update(max_abs_err=err, max_rel_err=rel,
                  ms=ms, plain_ms=plain_ms, library_ms=None,
                  bound_ms=max(t_ops, t_bytes) * 1e3,
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  operations=ops, bytes=nbytes)
    print(f"{record['name']}: max abs {err:.3e} ({rel:.3e} of its output's "
          f"largest), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {record['bound_ms']:.6f} ms ({record['bound_by']}: "
          f"{ops:.6e} float64 operations, {nbytes} bytes)")
    if exact:
        check(err == 0, f"{record['name']} equals its plain version bit for "
              "bit")
    else:
        check(rel <= 1e-14, f"{record['name']} within 1e-14 of the largest "
              "value of each output of its plain version")


def phase_pedestal(torch, spec, packs, grid, records):
    """Phase 20: the stacked pedestal remover at col60-0p1-default's width
    (PEDESTAL_LAYERS layers of the canonical column, the seven gases at
    0.1 cm-1): the remover's call timed and its launches counted, then
    each kernel on H2O's lines against its plain version (the
    contributions within 1e-14 of their largest value, the scan and the
    field bit for bit) and its bound; a repeat gives the same bits."""
    from pylbl_tpu_torch.models.lines.gas import internal_grid
    from pylbl_tpu_torch.ops import pedestal_cuda as pc

    (fn, remover, names), = [v for v in spec._multigas_fns.values()
                             if v != "unstackable"]
    t, p, vmr = canonical_layers(PEDESTAL_LAYERS)
    x = np.stack([vmr[name] for name in names], axis=1)
    k = fn(t, p, x)
    pc.reset_launches()
    out = remover(k, t, p, x)
    launches = dict(pc.LAUNCHES)
    check(launches == {name: len(names) for name in PEDESTAL},
          f"phase 20 the remover launched each kernel once a gas {launches}")
    ms = kernel_ms(torch, lambda: remover(k, t, p, x), 3)
    check(torch.equal(remover(k, t, p, x), out),
          "phase 20 the remover repeats bit for bit")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    remover(k, t, p, x)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"phase 20 remover, {PEDESTAL_LAYERS} layers x {len(names)} gases: "
          f"{ms:.3f} ms a call (CUDA events), {peak:.3f} GB above the field")

    v0, vn, n_per_v, n = internal_grid(grid)
    pack = packs["H2O"]
    gas = pc.GasLines(pack, pack.compat_break_filter(v0, vn, CUT_OFF))
    b0, nb, margin = gas.bucket_range(p)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=k.device)

    line_args = (gas.on(k.device), f64(t), f64(p),
                 f64(x[:, names.index("H2O")]), f64(gas.q_slots(t)), v0,
                 n_per_v, CUT_OFF, (b0, nb, margin), n)
    ka = pc.line_inputs(*line_args)
    names_p = ("center", "srw", "y", "pref", "s_idx", "e_idx", "bucket")
    field = k.reshape(k.shape[0], -1)
    off = names.index("H2O") * n
    rows, num = ka["s_idx"].shape
    recs = {name: dict(name=name, route="cuda",
                       source="pylbl_tpu_torch/csrc/pedestal.cu",
                       replaces=replaces, launches=launches[name])
            for name, replaces in PEDESTAL.items()}

    plain = pc.line_inputs(*line_args, plain=True)
    pedestal_record(
        recs["pedestal_lines"], [ka[name] for name in names_p],
        [plain[name] for name in names_p],
        kernel_ms(torch, lambda: pc.line_inputs(*line_args), 5),
        kernel_ms(torch, lambda: pc.line_inputs(*line_args, plain=True), 1,
                  warm=False),
        0, len(pc.GasLines.KERNEL_ORDER) * num * 8
        + rows * num * (4 * 8 + 3 * 4), False)
    del plain
    got = pc.endpoint_contributions(ka, field, off, n)
    want = pc.endpoint_contributions(ka, field, off, n, plain=True)
    torch.cuda.synchronize()
    terms = pedestal_terms(torch, ka)
    line_bytes = rows * num * (4 * 8 + 3 * 4)
    pedestal_record(
        recs["pedestal_contrib"], got, want,
        kernel_ms(torch, lambda: pc.endpoint_contributions(ka, field, off,
                                                           n), 5),
        kernel_ms(torch, lambda: pc.endpoint_contributions(
            ka, field, off, n, plain=True), 1, warm=False),
        terms * PEDESTAL_TERM_OPS, line_bytes + rows * num * 4 * 8, False)
    print(f"  {terms:.6e} endpoint terms ({terms / rows:.6e} a layer)")
    check(all(torch.equal(a, b) for a, b in zip(
        pc.endpoint_contributions(ka, field, off, n), got)),
        "phase 20 kernel A repeats bit for bit")

    scan_in = (ka["bucket"], ka["s_idx"], ka["e_idx"], *want)
    window = 2 * CUT_OFF + 1
    got = pc.scan(*scan_in, n, window, nb)
    want = pc.scan(*scan_in, n, window, nb, plain=True)
    pedestal_record(
        recs["pedestal_scan"], (got,), (want,),
        kernel_ms(torch, lambda: pc.scan(*scan_in, n, window, nb), 5),
        kernel_ms(torch, lambda: pc.scan(*scan_in, n, window, nb,
                                         plain=True), 1, warm=False),
        0, rows * num * (3 * 4 + 4 * 8 + 8), True)
    print(f"  {rows} rows of {num} lines, {nb} buckets; its bound is the "
          "row's dependent chain of float64 operations, not a rate")

    ped = got
    totals = pc.bucket_totals(ped, ka, k.dtype)
    pedestal_record(
        recs["pedestal_totals"], (totals,),
        (pc.bucket_totals(ped, ka, k.dtype, plain=True),),
        kernel_ms(torch, lambda: pc.bucket_totals(ped, ka, k.dtype), 5),
        kernel_ms(torch, lambda: pc.bucket_totals(ped, ka, k.dtype,
                                                  plain=True), 1,
                  warm=False),
        rows * num, rows * num * (8 + 4) + rows * nb * 8, True)
    blo, bhi = (torch.as_tensor(w, device=k.device) for w in
                pc.bucket_windows(v0, vn, n_per_v, n, CUT_OFF))
    adds = int(((bhi.long() - blo.long() + 1).clamp(min=0)).sum()) * rows

    def field_run(plain):
        dst = field.clone()
        pc.subtract_field(dst, off, n, totals, blo, bhi, b0, plain=plain)
        return (dst,)

    pedestal_record(
        recs["pedestal_field"], field_run(False), field_run(True),
        kernel_ms(torch, lambda: field_run(False), 5),
        kernel_ms(torch, lambda: field_run(True), 1, warm=False),
        adds * PEDESTAL_FIELD_OPS,
        2 * rows * n * field.element_size() + rows * nb * 8, True)
    records.update(recs)


def phase_bench(headline_rate, card, records):
    """Phase 17: ``python -m pylbl_tpu_torch bench`` as a user runs it, at
    the JAX bench's widths."""
    start = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "pylbl_tpu_torch", "bench"],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    (WORK / "bench.out").write_text(done.stdout + done.stderr)
    check(done.returncode == 0, f"phase 17 bench exited 0 (exit "
          f"{done.returncode}: {done.stderr[-600:]})")
    lines = done.stdout.strip().splitlines()
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    extra = full["extra"]
    print(f"phase 17 bench ({time.perf_counter() - start:.1f} s): "
          f"{extra['card']}, {json.dumps(extra['versions'])}, build "
          f"{extra['build_s']:.2f} s")
    print(f"  compact: {lines[-1]}")
    check(set(compact) == {"metric", "value", "unit", "vs_baseline",
                           "parity_max_rel", "stages", "scaling_eff_at_4"},
          "phase 17 the compact line is last, with the JAX keys")
    stages = {name: extra.get(name) for name in (
        *BENCH_KERNELS, "scaling")}
    for name, record in stages.items():
        bad = flagged(record) if isinstance(record, dict) else [record]
        check(not bad, f"phase 17 {name} is a record with no error or "
              f"invalid timing {bad}")
    for name, kernels in BENCH_KERNELS.items():
        record = stages[name]
        rate_hi = record.get("rate_hi")
        print(f"  {name}: {record['evals_per_s']:.6e} evaluations/s "
              f"({record.get('method', 'streamed wall')}; band top "
              f"{rate_hi if rate_hi is None else f'{rate_hi:.6e}'}), "
              f"launches {record['launches']}, host syncs "
              f"{record['host_syncs']}, peak {record['peak_gib']:.4f} GiB, "
              f"stage {record['stage_wall_s']:.1f} s on {card}")
        check(all(record["launches"].get(k, 0) > 0 for k in kernels),
              f"phase 17 {name} launched {kernels}")
        for k in kernels:
            records[k]["launches_bench"] = records[k].get(
                "launches_bench", 0) + record["launches"][k]
        # The wings' reciprocal floor beside the stage's time per call (a
        # config-5 block), at phase 5's SM clock.
        terms = record.get("wings_terms",
                           record.get("device_wings_terms_per_block"))
        stage_ms = record.get("ms_per_call",
                              record.get("device_ms_per_block"))
        floor = rcp_floor_ms(terms, records["wings_strided"]["sm_mhz"])
        records[kernels[0]].setdefault("rcp_floor_ms_bench", {})[name] = \
            floor
        print(f"    {stage_ms:.4f} ms a call; its {kernels[0]}: "
              f"{terms:.6e} terms, reciprocal floor {floor:.6f} ms")
    c5 = stages["config5"]
    print(f"  config5 streamed: wall {c5['wall_s']:.4f} s (cold "
          f"{c5['cold_wall_s']:.4f}), compute+fetch "
          f"{c5['compute_fetch_s']:.4f} s, write {c5['write_s']:.4f} s "
          f"({c5['writer']}, {c5['bytes_written']} bytes); a block's "
          f"fn.inner {c5['device_ms_per_block']:.4f} ms = "
          f"{c5['device_evals_per_s']:.6e} evaluations/s")
    for name in BENCH_PARITY:
        err = stages[name]["max_rel_err_vs_float64"]
        check(err < PARITY_TOL, f"phase 17 {name} within {PARITY_TOL} of "
              f"float64 ({err:.3e})")
    check(stages["sharded_1chip"]["backend"] == "kernel",
          "phase 17 sharded_1chip ran the kernel branch")
    points = [r for key in ("scaling", "halo", "ring")
              for r in stages["scaling"].get(key, [])]
    check(points and all(r["backend"] == "kernel" for r in points),
          f"phase 17 scaling: every point ran the kernel branch "
          f"(efficiency at 4: {stages['scaling']['efficiency_at_4']})")
    ratio = compact["value"] / headline_rate
    print(f"  headline {compact['value']:.6e}/s against phase 8's "
          f"{headline_rate:.6e}/s: {ratio:.4f}")
    check(0.5 <= ratio <= 2.0, "phase 17 headline within 0.5-2x of phase 8")
    print(f"phase 17 took {time.perf_counter() - start:.1f} s")


def print_ptxas(log):
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` output: its
    registers, static shared memory and spill bytes."""
    for name, use in ptxas_usage(log).items():
        print(f"  ptxas {name}: {use['registers']} registers, {use['smem']} "
              f"bytes smem, {use['spill_stores']} bytes spill stores, "
              f"{use['spill_loads']} bytes spill loads")


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
    print(optional_modules(("h5py", "netCDF4", "pyarts")))

    # Phase 2: build, the nvcc and g++ builds started together, from the
    # sources (an earlier run's libraries are removed first, so that the
    # compiler's report of this build is read).
    for name in ("liblineshape_cuda.so", "libpylbl_native.so"):
        (build.build_dir() / name).unlink(missing_ok=True)
    t0 = time.perf_counter()

    def timed_build(load):
        load()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cuda_s = pool.submit(timed_build, lc.cuda_library)
        native_s = pool.submit(timed_build, native.load)
        print(f"build: CUDA kernels {cuda_s.result():.2f} s, native scan "
              f"{native_s.result():.2f} s (concurrent)")
    log = build.BUILD_LOGS.get("liblineshape_cuda.so", "")
    print_ptxas(log)
    walk = walk_usage(log) or {}
    check(set(walk) == set(WALK.values()), "the Lorentzian walk compiled "
          f"for every line kind: {walk}")
    core_use = core_usage(log)
    check(core_use is not None, f"the mixed-slot core compiled: {core_use}")
    pair_use = pair_usage(log)
    check(all(pair_use.values()), "the unit walk compiled for CORR and the "
          f"rows core: {pair_use}")
    seg_use = {name: core_usage(log, kernel) for name, kernel in (
        ("seg_core", "seg_core_kernel"), ("seg_wings", "seg_wings_kernel"))}
    check(all(seg_use.values()), "the segment core and wings compiled: "
          f"{seg_use}")

    records = {name: {"name": name, "route": "cuda",
                      "source": "pylbl_tpu_torch/csrc/lineshape.cu",
                      "replaces": replaces}
               for name, replaces in KERNELS.items()}
    for name, kind in WALK.items():
        use = walk[kind]
        records[name].update(line=kind.upper(), registers=use["registers"],
                             spill_stores=use["spill_stores"],
                             spill_loads=use["spill_loads"],
                             points_per_lane=use["points"])
    for name in ("core_segmix", "core_segmix_single"):
        records[name].update({key: core_use[key] for key in (
            "registers", "spill_stores", "spill_loads", "smem")})
    for name, use in seg_use.items():
        records[name].update({key: use[key] for key in (
            "registers", "spill_stores", "spill_loads", "smem")})
    for name, kind in (("tile_correction", "corr"), ("core_rows", "rows"),
                       ("core_rows_single", "rows"),
                       ("core_rows_vmem", "rows_vmem")):
        records[name].update({key: pair_use[kind][key] for key in (
            "registers", "spill_stores", "spill_loads")})
    WORK.mkdir(parents=True, exist_ok=True)
    db_path = WORK / "smoke.db"
    if db_path.exists():
        db_path.unlink()
    t0 = time.perf_counter()
    db = P.Database(db_path)
    packs = line_packs(fixtures)
    for pack in packs.values():
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
    for name in STACKED:
        check(launches[name] > 0, f"main path launched {name}")
        records[name]["launches"] = launches[name]

    # Phase 5: kernels against their plain versions at main-path shapes.
    fn_a = stacked_fn(spec_a)
    fn_b = stacked_fn(spec_b)
    check(fn_a.wings_stride is not None and fn_b.wings_stride is None,
          "0.1 cm-1 takes the strided wings, 0.01 cm-1 the splat wings")
    phase_kernels(torch, lc, fn_a, col_a, ["wings_strided", "core_segmix"],
                  records)
    phase_kernels(torch, lc, fn_b, col_b,
                  ["wings_splat", "core_segmix at 0.01 cm-1"],
                  {"wings_splat": records["wings_splat"],
                   "core_segmix at 0.01 cm-1": None})
    # The same two kernels of phase 3 at all 16 layers: with the chunk
    # walk split into pieces their time grows with the layers.
    sixteen = {"wings_strided": {}, "core_segmix": {}}
    phase_kernels(torch, lc, fn_a, col_a, list(sixteen), sixteen,
                  layers=16)
    for name, record in sixteen.items():
        records[name].update({f"{key}_16_layers": record[key] for key in (
            "ms", "plain_ms", "bound_ms", "rcp_floor_ms", "ops41_bound_ms")
            if key in record})
    pieces = fn_a.core_plan.pieces
    print(f"core_segmix scratch at 16 layers: {pieces.num_slots} slots of "
          f"split tiles per layer, {16 * pieces.num_slots * 1024 * 4} bytes")

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

    # Phases 8-11: the single-gas engine.
    gas, gas64, grid_h, kin, arrays, npv, n, plan, k64, k_c, rate = \
        phase_gas(
        torch, P, lc, fixtures, records, card)
    phase_gas_batch(torch, lc, gas, gas64, grid_h, col_a)
    phase_formulations(torch, lc, kin, arrays, npv, n, plan, k64, records)
    phase_rows(torch, lc, gas, gas64, grid_h, kin, arrays, npv, n, plan, k64,
               col_a, records)
    phase_portable(torch, P, lc, db_path, gas, grid_h, k64, k_c, spec_a,
                   col_a, grid_a, card)
    phase_streamed(torch, P, lc, db, gas.pack, records, card)
    phase_sharded(torch, P, lc, db, db_path, col_a, grid_a, total_a, want,
                  records)
    phase_ingest(torch, P, lc, native, packs, db, col_a, grid_a, total_a,
                 records)
    phase_bench(rate, card, records)

    # Phase 18: the JAX package's API (wings_chunk, the installed layout,
    # the positional calls).
    start = time.perf_counter()
    from pylbl_tpu_torch.parallel import make_multigas_batched_fn
    phase_wings_chunk(torch, lc, packs, spec_a, two, grid_a, "A",
                      stacked_fn(s64), "wings_strided", records)
    b64 = make_multigas_batched_fn(packs, grid_b, device="cuda",
                                   dtype=torch.float64, backend="plain")
    phase_wings_chunk(torch, lc, packs, spec_b, two, grid_b, "B", b64,
                      "wings_splat", records)
    del b64
    phase_installed(torch, k_c)
    phase_compat(torch, P, lc, gas.pack, grid_h, col_a, k_c)
    print(f"phase 18 took {time.perf_counter() - start:.1f} s")

    # Phase 19: every kernel on poisoned lines (after the records' counts:
    # these launches are not the main path's).
    phase_nonfinite(torch, lc)

    # Phase 20: the pedestal remover's kernels at col60-0p1-default's width.
    phase_pedestal(torch, spec_a, packs, grid_a, records)
    for name, record in records.items():
        check(record.get("launches", 0) > 0 and all(
            key in record for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")),
              f"{name} launched on its path, compared with its plain "
              "version and bounded")

    print(json.dumps({"kernels": [records[k] for k in (*KERNELS,
                                                       *PEDESTAL)]}))
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
