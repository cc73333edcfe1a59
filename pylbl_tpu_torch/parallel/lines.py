"""Batched line-absorption pipelines on one device (torch).

Counterpart of the single-device part of pylbl_tpu/parallel/lines.py:

- :func:`device_line_pack` / :func:`stack_device_packs` (host numpy, copied)
  prepare per-line float32 constants for a target grid, every gas's lines
  concatenated over a flat ``[G * num_points]`` output grid;
- :func:`as_tensors` carries those numpy dicts onto a torch device — the
  one conversion point, also used by the tests to feed both packages
  identical inputs;
- :func:`line_kernel_arrays` is the per-layer line physics in torch,
  vectorized over the layer batch;
- :func:`make_multigas_batched_fn` (all gases stacked) and
  :func:`make_batched_fn` (one gas) assemble the wings SoA and the
  core parameters (segment-32 or rows) and run the wings and core passes
  (ops/lineshape_cuda.py: CUDA kernels on the card, plain versions on the
  CPU, or the plain versions anywhere with ``backend="plain"``);
- :func:`make_stacked_pedestal_remover` removes the reference pedestal on
  the field's device (ops/pedestal_cuda.py), deterministically.

Precision note: line centers are passed as an exact integer grid index
plus a small fractional part computed on the host, so float32 kernels see
no catastrophic cancellation in x = ((p - c_int) - c_frac) * srw.
"""
import contextlib
import math

import numpy as np
import torch

from ..ops import lineshape_cuda as lc
from ..ops.lineshape import accumulate_segment
from ..runtime.device import resolve_backend, resolve_device, resolve_dtype
from ..utils import constants as c
from ..utils.observability import metrics


class UnstackableError(ValueError):
    """The given molecules cannot share one stacked kernel launch (flat grid
    too large for exact float32 integers, or mismatched TIPS base
    temperatures).  Callers that fall back to per-gas dispatch catch
    exactly this."""


# Per-line constant fields of a device line pack (plus q_table).
_LINE_KEYS = ("c_base_int", "c_base_frac", "nu", "sw", "gamma_air",
              "gamma_self", "n_air", "delta_air", "elower", "mass", "q_row",
              "sw_pre", "repwid_base")


def as_tensors(arrays, device, dtype=None):
    """numpy per-line arrays -> torch tensors on ``device``.

    Args:
        arrays: dict of numpy arrays (:func:`device_line_pack`,
            :func:`stack_device_packs`, or a LinePack's array fields).
        device: torch device.
        dtype: float dtype for the floating fields (default: keep theirs),
            a torch or numpy spelling (runtime/device.resolve_dtype);
            integer fields keep their type.

    Returns:
        dict name -> tensor.
    """
    dtype = None if dtype is None else resolve_dtype(dtype)
    out = {}
    for key, value in arrays.items():
        value = np.asarray(value)
        t = torch.as_tensor(np.ascontiguousarray(value), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t
    return out


def device_line_pack(pack, grid, keep=None, cut_off=c.DEFAULT_CUT_OFF):
    """Prepares per-line float32 arrays for a target grid (host numpy).

    Args:
        pack: LinePack (host, float64).
        grid: target user grid (fixes v0/n_per_v for the split-center
            representation).
        keep: optional compat-break line count
            (pack.compat_break_filter result).

    Returns:
        (arrays dict of np.float32/[int32] arrays, static dict).
    """
    from ..models.lines.gas import internal_grid
    v0, vn, n_per_v, num_points = internal_grid(grid)
    if keep is None:
        keep = pack.compat_break_filter(v0, vn, cut_off)
    sl = slice(0, keep)
    center64 = (pack.nu[sl] - v0) * n_per_v
    c_base_int = np.rint(center64)
    arrays = {
        "c_base_int": c_base_int.astype(np.float32),
        "c_base_frac": (center64 - c_base_int).astype(np.float32),
        "nu": pack.nu[sl].astype(np.float32),
        "sw": pack.sw[sl].astype(np.float32),
        "gamma_air": pack.gamma_air[sl].astype(np.float32),
        "gamma_self": pack.gamma_self[sl].astype(np.float32),
        "n_air": pack.n_air[sl].astype(np.float32),
        "delta_air": pack.delta_air[sl].astype(np.float32),
        "elower": pack.elower[sl].astype(np.float32),
        "mass": pack.mass[sl].astype(np.float32),
        "q_row": np.clip(pack.iso[sl] - 1, 0,
                         pack.q_table.shape[0] - 1).astype(np.int32),
        "q_table": pack.q_table.astype(np.float32),
    }
    # Layer-independent physics, hoisted out of the per-layer assembly:
    #   sw_pre = sw * 1e-4 * Q(296) / (1 - exp(-c2 nu0 / 296))
    #   repwid_base = sqrt(ln 2) / ((nu0 / c) * sqrt(r2 / mass))
    # so per layer: sw = sw_pre * sb(T) * (1 - g(T)) / Q(T) and
    # repwid = repwid_base / sqrt(T).
    q32 = arrays["q_table"]
    t0q = int(float(pack.q_temperature[0]))  # matches _q_interp's int(q_t0)
    i296 = int(np.clip(296 - t0q, 0, q32.shape[1] - 2))
    # Clamped fraction: a TIPS table topping out below 296 K must not
    # extrapolate (matches _q_interp on the edge-padded stacked table).
    frac296 = np.float32(np.clip(296.0 - (i296 + t0q), 0.0, 1.0))
    q_slots296 = q32[:, i296] + (q32[:, i296 + 1] - q32[:, i296]) * frac296
    q_ref = q_slots296[arrays["q_row"]].astype(np.float64)
    gref = np.exp(-c.C2 * pack.nu[sl] / 296.0)
    arrays["sw_pre"] = (pack.sw[sl] * 1.0e-4 * q_ref
                        / (1.0 - gref)).astype(np.float32)
    alpha_base = (pack.nu[sl] / c.VLIGHT) * np.sqrt(c.R2 / pack.mass[sl])
    arrays["repwid_base"] = (c.SQRT_LN2
                             / np.maximum(alpha_base,
                                          1e-300)).astype(np.float32)
    static = {"v0": v0, "vn": vn, "n_per_v": n_per_v,
              "num_points": num_points, "cut_off": cut_off,
              "q_t0": float(pack.q_temperature[0]),
              "num_lines": int(keep)}
    return arrays, static


def _one_minus_exp_neg(z):
    """1 - exp(-z) for z >= 0.

    float32: a degree-7 Taylor series for z < 0.5 (the radiation
    denominator amplifies exp's absolute error near 0 by 1/z), expm1
    beyond; float64: expm1 directly (the series would cap accuracy at
    ~2.6e-7 near z = 0.5)."""
    if z.dtype == torch.float64:
        return -torch.expm1(-z)
    poly = z * (1.0 - z * (1.0 / 2.0 - z * (1.0 / 6.0 - z * (
        1.0 / 24.0 - z * (1.0 / 120.0 - z * (1.0 / 720.0
                                             - z * (1.0 / 5040.0)))))))
    return torch.where(z < 0.5, poly, -torch.expm1(-z))


def _q_interp(q_table, q_t0, q_row, temperature):
    """Uniform-grid TIPS interpolation (reference spectral_database.c:97-104)
    per isotopologue slot, gathered per line: temperature [B] -> [B, N]."""
    i = torch.clamp(torch.floor(temperature).to(torch.int32) - int(q_t0), 0,
                    q_table.shape[-1] - 2).long()
    lo = q_table[:, i]                                   # [slots, B]
    hi = q_table[:, i + 1]
    frac = temperature - (i + int(q_t0)).to(temperature.dtype)
    q_slots = lo + (hi - lo) * frac
    return q_slots.index_select(0, q_row.long()).transpose(0, 1)


def line_kernel_arrays(arrays, static, temperature, pressure,
                       volume_mixing_ratio):
    """Per-layer line physics: [B] T/p and [B] (one gas) or [B, G]
    (stacked) vmr -> [B, N] kernel arrays (reference spectra.c:17-45).

    In a gas-stacked pack each line broadens against its own gas's partial
    pressure, and its window is clamped to its gas segment then offset
    into the flat [G * num_points] grid.
    """
    n_per_v = static["n_per_v"]
    cut_off = static["cut_off"]
    temperature = temperature[:, None]
    pressure = pressure[:, None]
    stacked = "flat_off" in arrays
    if stacked:
        vmr = volume_mixing_ratio.index_select(1, arrays["gas_idx"].long())
    else:
        vmr = volume_mixing_ratio[:, None]
    p_atm = pressure * c.PA_TO_ATM
    partial = p_atm * vmr
    tfact = 296.0 / temperature

    shift = p_atm * arrays["delta_air"]
    gamma = (arrays["gamma_air"] * (p_atm - partial)
             + arrays["gamma_self"] * partial) * tfact ** arrays["n_air"]

    sb = torch.exp(arrays["elower"] * c.C2 * (temperature - 296.0)
                   / (temperature * 296.0))
    one_minus_g = _one_minus_exp_neg(c.C2 * arrays["nu"] / temperature)
    q_t = _q_interp(arrays["q_table"], static["q_t0"], arrays["q_row"],
                    temperature[:, 0])
    sw = arrays["sw_pre"] * sb * (one_minus_g / q_t)
    repwid = arrays["repwid_base"] * torch.rsqrt(temperature)
    dc = shift * n_per_v
    c_frac = arrays["c_base_frac"] + dc
    # The window's wavenumber floor(nu_shift) - v0 from the split center:
    # with c_base_int = q * n_per_v + r exactly, floor((r + c_frac) /
    # n_per_v) is decided on a small number.  (The JAX package's float32
    # floor(center / n_per_v + v0) rounds across the integer for a line
    # within float32 rounding of one and moves its window by a wavenumber;
    # ROADMAP Queue 3.)
    base = arrays["c_base_int"].to(torch.int64)
    q = torch.div(base, n_per_v, rounding_mode="floor")
    r = (base - q * n_per_v).to(c_frac.dtype)
    bucket = q + torch.floor((r + c_frac) / n_per_v)      # minus v0
    s_idx = ((bucket - cut_off) * n_per_v).to(torch.int32)
    e_idx = ((bucket + cut_off + 1) * n_per_v).to(torch.int32)
    c_int = arrays["c_base_int"]
    if stacked:
        # Clamp to the gas segment FIRST, then shift into the flat grid.
        n = static["num_points"]
        off = arrays["flat_off"]
        s_idx = off + torch.clamp(s_idx, 0, n - 1)
        e_idx = off + torch.clamp(e_idx, 0, n - 1)
        c_int = c_int + off.to(c_int.dtype)
    return {
        "c_int": c_int.to(torch.int32).expand_as(s_idx),
        "c_frac": c_frac,
        "scaled_repwid": (repwid / n_per_v).expand_as(dc),
        "y": repwid * gamma,
        "prefactor": sw * c.RSQRPI * repwid,
        "s_idx": s_idx,
        "e_idx": e_idx,
    }


def stack_device_packs(packs, grid, cut_off=c.DEFAULT_CUT_OFF):
    """Concatenates several molecules' line lists into one flat launch.

    The output grid is the per-gas internal grid tiled G times (flat index
    = gas_idx * num_points + local point) and every line carries its gas
    index.

    Args:
        packs: dict name -> LinePack (insertion order fixes gas order).
        grid: shared user grid.

    Returns:
        (arrays, host, static, names): ``arrays`` as
        :func:`device_line_pack` plus per-line int32 ``gas_idx`` and
        ``flat_off`` and a row-stacked ``q_table``; ``host`` holds
        concatenated float64 per-line params for host-side window sizing;
        ``static["flat_points"]`` = G * num_points.
    """
    from ..models.lines.gas import internal_grid
    names = list(packs)
    v0, vn, n_per_v, num_points = internal_grid(grid)
    if len(names) * num_points >= 2 ** 24:
        raise UnstackableError(
            "flat stacked grid exceeds the float32 exact-integer range; "
            "split the gases into groups")
    keeps = {n: packs[n].compat_break_filter(v0, vn, cut_off)
             for n in names}
    per = [(n, *device_line_pack(packs[n], grid, keep=keeps[n],
                                 cut_off=cut_off)) for n in names]
    q_t0 = per[0][2]["q_t0"]
    if any(s["q_t0"] != q_t0 for _, _, s in per):
        raise UnstackableError("stacked gases must share the TIPS table "
                               "base temperature")
    n_temps = max(a["q_table"].shape[1] for _, a, _ in per)

    parts = {key: [] for key in _LINE_KEYS}
    gas_idx, flat_off, q_tables = [], [], []
    host = {key: [] for key in ("nu", "mass", "delta_air", "gamma_air",
                                "n_air")}
    row_off = 0
    for g, (name, a, s) in enumerate(per):
        num = a["nu"].shape[0]
        for key in _LINE_KEYS:
            parts[key].append(a[key] + row_off if key == "q_row"
                              else a[key])
        q_tab = a["q_table"]
        if q_tab.shape[1] < n_temps:
            q_tab = np.pad(q_tab, ((0, 0), (0, n_temps - q_tab.shape[1])),
                           mode="edge")
        q_tables.append(q_tab)
        row_off += q_tab.shape[0]
        gas_idx.append(np.full(num, g, np.int32))
        flat_off.append(np.full(num, g * num_points, np.int32))
        pack = packs[name]
        keep = keeps[name]
        host["nu"].append(pack.nu[:keep])
        host["mass"].append(pack.mass[:keep])
        host["delta_air"].append(pack.delta_air[:keep])
        host["gamma_air"].append(pack.gamma_air[:keep])
        host["n_air"].append(pack.n_air[:keep])

    arrays = {key: np.concatenate(parts[key]) for key in _LINE_KEYS}
    arrays["q_table"] = np.concatenate(q_tables, axis=0)
    arrays["gas_idx"] = np.concatenate(gas_idx)
    arrays["flat_off"] = np.concatenate(flat_off)
    host = {key: np.concatenate(val) for key, val in host.items()}
    static = dict(per[0][2])
    static["num_lines"] = int(arrays["nu"].shape[0])
    static["num_gases"] = len(names)
    static["flat_points"] = len(names) * num_points
    return arrays, host, static, names


def derive_envelope(temperature, pressure, t_quantum=5.0,
                    p_quantum_atm=0.25):
    """Smallest quantized (t_max, p_max_atm) kernel envelope covering the
    given conditions.

    The batched pipeline sizes its layer-independent core-instance windows
    for the envelope's hottest/highest-pressure layer; quantizing up (next
    5 K / 0.25 atm) lets near-identical atmospheres share one pipeline and
    guarantees the runtime envelope guard cannot fire.

    Returns:
        (t_max [K], p_max_atm [atm]) floats.
    """
    temperature = np.asarray(temperature, np.float64)
    pressure = np.asarray(pressure, np.float64)
    if temperature.size == 0 or pressure.size == 0:
        return 350.0, 5.0
    if not (np.isfinite(temperature).all() and np.isfinite(pressure).all()):
        raise ValueError(
            "non-finite temperature or pressure in the atmosphere; "
            "cannot derive a kernel envelope")
    t_max = t_quantum * np.ceil(float(temperature.max()) / t_quantum)
    p_atm = float(pressure.max()) * c.PA_TO_ATM
    p_max_atm = p_quantum_atm * max(np.ceil(p_atm / p_quantum_atm), 1.0)
    return float(t_max), float(p_max_atm)


def shift_origin(kernel_arrays, origin):
    """Kernel arrays with the grid coordinates (c_int, s_idx, e_idx)
    relative to a shard's first point ``origin``."""
    if not origin:
        return kernel_arrays
    out = dict(kernel_arrays)
    for key in ("c_int", "s_idx", "e_idx"):
        out[key] = out[key] - origin
    return out


def wings_soa(ka, prepacked, dtype, pad=0):
    """The wings SoA [B, 8, N + pad] from per-line kernel arrays [B, N]:
    C_INT, C_FRAC, SRW, Y, PREF, S_IDX, E_IDX and a zero row, prepacked (Y
    = y^2, PREF = pref*y/sqrt(pi)) or raw, with ``pad`` dead lines."""
    y, pref = ka["y"], ka["prefactor"]
    if prepacked:
        y, pref = y * y, pref * y * c.RSQRPI
    rows = (ka["c_int"].to(dtype), ka["c_frac"], ka["scaled_repwid"], y,
            pref, ka["s_idx"].to(dtype), ka["e_idx"].to(dtype),
            torch.zeros_like(ka["c_frac"]))
    # Dead-line fills: zero strength, an empty window, y above the
    # pure-Lorentz threshold.
    fill = (0.0, 0.0, 1.0, 1.0e4 if prepacked else 100.0, 0.0, -1.0, -2.0,
            0.0)
    return torch.stack([torch.nn.functional.pad(r, (0, pad), value=v)
                        for r, v in zip(rows, fill)], dim=1).contiguous()


def _layer_tensor(value, device, dtype):
    return torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value, device=device).to(
            resolve_dtype(dtype))


def _pad_to_chunk(kernel_arrays, chunk):
    """Pads the line axis of [B, N] kernel tensors to a multiple of
    ``chunk`` with dead lines (zero strength, window [-1, -2])."""
    pad = -kernel_arrays["prefactor"].shape[-1] % chunk
    if pad == 0:
        return kernel_arrays
    fill = {"c_int": 0, "c_frac": 0.0, "scaled_repwid": 1.0, "y": 1.0,
            "prefactor": 0.0, "s_idx": -1, "e_idx": -2}
    return {name: torch.nn.functional.pad(kernel_arrays[name], (0, pad),
                                          value=value)
            for name, value in fill.items()}


def _host64(value):
    return np.asarray(value.cpu() if isinstance(value, torch.Tensor)
                      else value, np.float64)


def _envelope_guard(t_max, p_max_atm):
    """Refuses layers outside the (t_max, p_max_atm) envelope the
    core-instance windows were sized for: core-correction coverage would
    silently degrade at window edges there.  The check reads the layers on
    the host: on card tensors it waits for the card."""
    def check(temperature, pressure):
        t_check = _host64(temperature)
        p_check = _host64(pressure) * c.PA_TO_ATM
        if t_check.size and float(t_check.max()) > t_max:
            raise ValueError(
                f"temperature {float(t_check.max()):.1f} K exceeds the "
                f"kernel envelope t_max={t_max} K; rebuild with a larger "
                "t_max")
        if p_check.size and float(p_check.max()) > p_max_atm:
            raise ValueError(
                f"pressure {float(p_check.max()):.2f} atm exceeds the "
                f"kernel envelope p_max_atm={p_max_atm}; rebuild with a "
                "larger p_max_atm")
    return check


def _core_reach(host, v0, n_per_v, cut_off, t_max, p_max_atm):
    """Layer-independent core-instance reach per line: (center0, reach,
    y_ref).  ``reach`` covers the line's core at the envelope's widest
    Doppler width (``t_max``) plus its largest pressure shift
    (``p_max_atm``); ``y_ref`` is its y at 275 K, 1 atm, air-broadened,
    the sort key that keeps core chunks y-class homogeneous."""
    alpha_ref = (host["nu"] / c.VLIGHT) * np.sqrt(
        c.R2 * t_max / np.maximum(host["mass"], 1.0))
    repwid_ref = c.SQRT_LN2 / np.maximum(alpha_ref, 1e-300)
    core_w = lc.core_halfwidths(repwid_ref, n_per_v, cut_off)
    shift_w = np.ceil(np.abs(host["delta_air"]) * p_max_atm
                      * n_per_v).astype(np.int64) + 1
    center0 = np.rint((host["nu"] - v0) * n_per_v).astype(np.int64)
    y_ref = (c.SQRT_LN2 / np.maximum(
        (host["nu"] / c.VLIGHT) * np.sqrt(
            c.R2 * 275.0 / np.maximum(host["mass"], 1.0)), 1e-300)
        ) * host["gamma_air"] * (296.0 / 275.0) ** host["n_air"]
    return center0, core_w + shift_w, y_ref


class _LineStage:
    """The device part of a batched pipeline: plans for one line set on an
    ``n_out``-point grid, the line constants on ``device``, and the
    per-layer assembly and kernel passes.

    Strided overlapped-tile wings (two chunk classes when ``wings_tail``)
    wherever a stride fits the widened windows ``s_wide``/``e_wide``, the
    splat wings otherwise; the core pass of a ``core_mode`` plan over the
    windows ``core_lo``/``core_hi``, its parameters computed directly in
    instance space (segment modes) or gathered into groups from the
    per-line kernel arrays on the device (rows mode; parallel/lines.py
    ``_assemble`` of the JAX package).  The wings rows are prepacked (Y =
    y^2, PREF = pref*y/sqrt(pi)) except for the splat under a "seg" or
    "rows" core plan, which takes the raw Lorentzian rows
    (lineshape_pallas.py ``wings_core``).

    ``wings_chunk`` is the wings pass's line chunk, as the JAX
    ``make_multigas_batched_fn`` takes it: the strided plan's (default
    ``STRIDED_CHUNK``) or the splat CSR's (default ``chunk``); the kernels
    take at most ``MAX_CHUNK``.

    A sharded step (parallel/sharded.py) hands each shard's stage its plan
    (``planned``: (stride, StridedLayout, CorePlan) under the one global
    stride, ``arrays_np`` already in layout order) and assembles with the
    shard's ``origin`` subtracted from the grid coordinates.
    """

    def __init__(self, arrays_np, static, s_wide, e_wide, core_lo, core_hi,
                 y_ref, n_out, tile, chunk, core_mode, wings_tail, device,
                 dtype, plain, planned=None, wings_chunk=None):
        if wings_chunk is not None and not 0 < wings_chunk <= lc.MAX_CHUNK:
            raise ValueError(f"wings_chunk {wings_chunk}: the wings kernel "
                             f"takes 1-{lc.MAX_CHUNK} lines per chunk")
        with metrics.timed("lines.plan"):
            if planned is None:
                planned = lc.plan_strided_stage(
                    s_wide, e_wide, core_lo, core_hi, y_ref, n_out,
                    tile=tile, chunk=wings_chunk or lc.STRIDED_CHUNK,
                    core_mode=core_mode, tail=wings_tail)
                if planned is not None:
                    with metrics.timed("lines.permute"):
                        arrays_np = lc.permute_line_arrays(arrays_np,
                                                           planned[1].perm)
            if planned is not None:
                self.wings_stride, lay, self.core_plan = planned
                csr = [lay.w_start, lay.w_n]
                if lay.t_start is not None:
                    csr += [lay.t_start, lay.t_n]
                nlines = lay.nlines
                self.wings_chunk = wings_chunk or lc.STRIDED_CHUNK
            else:
                self.wings_stride = None
                self.wings_chunk = wings_chunk or chunk
                with metrics.timed("lines.layout"):
                    csr = list(lc.tile_line_ranges(s_wide, e_wide, n_out,
                                                   tile, self.wings_chunk))
                nlines = static["num_lines"]
                with metrics.timed("lines.core_plan"):
                    self.core_plan = lc.CorePlan(core_lo, core_hi, n_out,
                                                 tile, sort_key=y_ref,
                                                 mode=core_mode)
            with metrics.timed("lines.pieces"):
                self.wings_pieces = lc.TilePieces.of_csr(*csr[1::2])
        self.csr = csr
        self.static = static
        self.n_out = n_out
        self.tile = tile
        self.wings_tail = wings_tail
        self.dtype = dtype
        self.plain = plain
        self.prepacked = self.wings_stride is not None \
            or self.core_plan.mode == "segmix"
        with metrics.timed("lines.upload"):
            self.csr_dev = [torch.as_tensor(a, device=device) for a in csr]
            self.arrays = as_tensors(arrays_np, device, dtype)
            self.core_inst = None if self.core_plan.mode == "rows" \
                else self.core_plan.expand_line_arrays(self.arrays)
        # The SoA holds whole wings chunks (JAX pads to ``chunk``, which
        # every default wings chunk divides).
        self.pad = -nlines % math.lcm(chunk, self.wings_chunk)

    def assemble(self, t, p, x, origin=0):
        """Layer-batch kernel inputs: (wings SoA [B, 8, N], core params
        [B, 8, I] or rows groups [B, 64, G]), grid coordinates relative to
        ``origin``."""
        with metrics.timed("lines.assemble"):
            ka = shift_origin(line_kernel_arrays(self.arrays, self.static, t,
                                                 p, x), origin)
            soa = wings_soa(ka, self.prepacked, self.dtype, self.pad)
            if self.core_inst is None:
                return soa, self.core_plan.group_params(ka)
            ka_i = shift_origin(line_kernel_arrays(self.core_inst,
                                                   self.static, t, p, x),
                                origin)
            return soa, self.core_plan.seg_params(ka_i).contiguous()

    def wings_pass(self, soa, plain=None):
        with metrics.timed("lines.wings"):
            plain = self.plain if plain is None else plain
            csr = self.csr_dev
            if self.wings_stride is not None:
                tail_csr = csr[2:] or [None, None]
                if plain:
                    return lc.wings_strided_plain(
                        soa, csr[0], csr[1], self.n_out, self.tile,
                        self.wings_stride, self.wings_chunk, *tail_csr,
                        tail=self.wings_tail or 128)
                return lc.wings_strided_pass(
                    soa, csr[0], csr[1], self.n_out, self.tile,
                    self.wings_stride, self.wings_chunk, *tail_csr,
                    tail=self.wings_tail or 128, pieces=self.wings_pieces)
            kind = "wings_pre" if self.prepacked else "wings"
            if plain:
                return lc.tile_plain(soa, csr[0], csr[1], self.n_out,
                                     self.tile, self.wings_chunk, kind)
            return lc.tile_pass(soa, csr[0], csr[1], self.n_out, self.tile,
                                self.wings_chunk, kind, self.wings_pieces)

    def core_pass(self, params, plain=None):
        with metrics.timed("lines.core"):
            return self.core_plan.core_pass(
                params, plain=self.plain if plain is None else plain)

    def run(self, t, p, x, origin=0):
        soa, core = self.assemble(t, p, x, origin)
        return self.wings_pass(soa) + self.core_pass(core)

    def attach(self, fn):
        """Exposes the stage handles on a pipeline function."""
        fn.stage = self
        fn.core_plan = self.core_plan
        fn.wings_stride = self.wings_stride
        fn.wings_chunk = self.wings_chunk
        fn.wings_prepacked = self.prepacked
        fn.wings_csr = tuple(self.csr[:2])
        fn.wings_tail_csr = tuple(self.csr[2:]) or None
        fn.wings_pass = self.wings_pass
        fn.core_pass = self.core_pass
        return fn


def make_multigas_batched_fn(packs, grid, cut_off=c.DEFAULT_CUT_OFF,
                             tile=None, chunk=None, t_max=350.0,
                             p_max_atm=5.0, backend="kernel",
                             interpret=False, core_mode=None,
                             wings_chunk=None, wings_tail=128, *,
                             device="cuda", dtype=torch.float32):
    """Builds the all-gases batched pipeline for one grid on one device.

    One wings pass and one core pass per layer batch cover every gas:
    strided overlapped-tile wings (two chunk classes when ``wings_tail``)
    wherever a stride fits the line windows, the splat wings otherwise,
    and the core pass of ``core_mode`` (the mixed-slot segment-32 core by
    default).  The parameters up to ``wings_tail`` are the JAX function's,
    in its order.

    Args:
        packs: dict name -> LinePack.
        backend: "kernel" (the wrappers: CUDA kernels for CUDA tensors,
            plain versions for CPU tensors), "plain" (plain versions on
            any device, in ``dtype``), "xla" (the portable two-pass path,
            ops/lineshape.py ``accumulate_segment``, over every layer at
            once, in ``dtype``; no envelope guard, as it sizes no windows
            ahead) or a spelling runtime/device.resolve_backend maps to
            one of them.
        interpret: the JAX package's Pallas interpret mode: True runs the
            kernels' plain versions on ``device`` (``backend="plain"``);
            the "xla" path, which has no kernel, is unchanged.
        core_mode: "segmix" (default), "seg" or "rows".
        wings_chunk: lines per wings chunk (at most ``MAX_CHUNK``, 512):
            the strided plan's (default ``STRIDED_CHUNK``, 256) or, where
            no stride fits, the splat CSR's (default ``chunk``);
            ``fn.wings_chunk`` reports the one used.
        device: torch device of the line constants and outputs: the card
            by default, raising without one; "cpu" runs the plain
            versions on the host.
        dtype: float dtype of the pipeline, torch or numpy spelling (the
            CUDA kernels take float32).

    Returns:
        fn(temperature[B], pressure[B], vmr[B, G]) -> [B, G, num_points]
        tensor of absorption cross sections [m2] on the internal grid,
        gases ordered as ``fn.names`` = ``list(packs)``.
        ``fn.total(t, p, vmr)`` returns the density-weighted gas sum [B,
        num_points] in m-1.  ``fn.inner`` and ``fn.inner_total`` are the
        two without the envelope guard, whose host read of the layers
        waits for the card (a caller that checked the layers once with
        ``fn.check_envelope(t, p)`` keeps its calls free of host syncs).
    """
    backend = resolve_backend(backend, device, interpret)
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    tile = tile or lc.DEFAULT_TILE
    chunk = chunk or lc.DEFAULT_CHUNK
    with metrics.timed("lines.stack"):
        arrays_np, host, static, names = stack_device_packs(packs, grid,
                                                            cut_off)
    num_points = static["num_points"]
    flat_points = static["flat_points"]
    n_per_v = static["n_per_v"]
    v0 = static["v0"]
    num_gases = static["num_gases"]
    guard = _envelope_guard(t_max, p_max_atm)

    def _inputs(temperature, pressure, vmr):
        t = _layer_tensor(temperature, device, dtype).reshape(-1)
        p = _layer_tensor(pressure, device, dtype).reshape(-1)
        x = _layer_tensor(vmr, device, dtype).reshape(t.shape[0], -1)
        return t, p, x

    def _total(k, t, p, x):
        n_density = p[:, None] * x / (c.KB * t[:, None])
        total = k[:, 0] * n_density[:, 0, None]
        for g in range(1, k.shape[1]):
            total = total + k[:, g] * n_density[:, g, None]
        return total

    def _pipeline(run, guarded):
        """fn, fn.total and the unguarded fn.inner and fn.inner_total
        around ``run(t, p, x)`` -> [B, G, num_points] on layer tensors."""
        def inputs(temperature, pressure, vmr, check):
            t, p, x = _inputs(temperature, pressure, vmr)
            if check and guarded:
                with metrics.timed("lines.guard"):
                    guard(t, p)
            return t, p, x

        def weighted(temperature, pressure, vmr, check):
            t, p, x = inputs(temperature, pressure, vmr, check)
            return _total(run(t, p, x), t, p, x)

        def fn(temperature, pressure, vmr):
            return run(*inputs(temperature, pressure, vmr, True))

        fn.inner = lambda t, p, x: run(*inputs(t, p, x, False))
        fn.total = lambda t, p, x: weighted(t, p, x, True)
        fn.inner_total = lambda t, p, x: weighted(t, p, x, False)
        fn.check_envelope = guard
        fn.names = names
        return fn

    if static["num_lines"] == 0:
        return _pipeline(lambda t, p, x: torch.zeros(
            (t.shape[0], num_gases, num_points), dtype=dtype, device=device),
            backend != "xla")

    if backend == "xla":
        # JAX's portable branch: its fixed core half width (not
        # core_halfwidth), the full window, the splat chunk.
        window = (2 * cut_off + 1) * n_per_v + 1
        core_w = min(128, (cut_off + 1) * n_per_v)
        with metrics.timed("lines.upload"):
            arrays_dev = as_tensors(arrays_np, device, dtype)

        def run_xla(t, p, x):
            ka = _pad_to_chunk(
                line_kernel_arrays(arrays_dev, static, t, p, x), chunk)
            k = accumulate_segment(ka, 0, flat_points, flat_points, window,
                                   core_w, chunk)
            return k.reshape(t.shape[0], num_gases, num_points)

        return _pipeline(run_xla, False)

    # Flat windows for the CSR, from unshifted positions +/-1 wavenumber
    # slop, clamped per gas segment then offset; core instance windows
    # placed in the flat grid the same way.
    with metrics.timed("lines.plan"):
        off = arrays_np["flat_off"].astype(np.int64)
        b0 = np.floor(host["nu"]).astype(np.int64)
        s_loc = np.clip((b0 - 1 - cut_off - v0) * n_per_v, 0,
                        num_points - 1)
        e_loc = np.clip((b0 + 1 + cut_off + 1 - v0) * n_per_v, 0,
                        num_points - 1)
        center0, reach, y_ref = _core_reach(host, v0, n_per_v, cut_off,
                                            t_max, p_max_atm)
        core_lo = off + np.clip(center0 - reach, 0, num_points - 1)
        core_hi = off + np.clip(center0 + reach, 0, num_points - 1)
    stage = _LineStage(arrays_np, static, off + s_loc, off + e_loc, core_lo,
                       core_hi, y_ref, flat_points, tile, chunk, core_mode,
                       wings_tail, device, dtype, backend == "plain",
                       wings_chunk=wings_chunk)
    fn = _pipeline(lambda t, p, x: stage.run(t, p, x).reshape(
        t.shape[0], num_gases, num_points), True)

    def assemble(temperature, pressure, vmr):
        t, p, x = _inputs(temperature, pressure, vmr)
        guard(t, p)
        return stage.assemble(t, p, x)

    fn.assemble = assemble
    return stage.attach(fn)


def make_batched_fn(pack, grid, cut_off=c.DEFAULT_CUT_OFF, tile=None,
                    chunk=None, t_max=350.0, p_max_atm=5.0, core_mode=None,
                    wings_tail=None, backend="kernel", device="cuda",
                    dtype=torch.float32):
    """Builds the single-gas batched pipeline for one (gas, grid) on one
    device (counterpart of ``make_batched_tpu_fn``, which takes the JAX
    function's parameters and forwards here).

    Line constants go to the device once; each call ships only the [B]
    layer conditions, runs the line physics on the device and feeds the
    layer-batched kernels.  The per-tile line ranges come from the
    *unshifted* line positions widened by one wavenumber, so they are
    layer-independent; the kernels' window masks use the exact per-layer
    windows.  The core-instance windows are sized per line for the
    hottest plausible layer (``t_max``) plus the line's own worst-case
    pressure shift at ``p_max_atm``; layers outside that envelope are
    refused.  ``wings_tail=None`` gives the single-class strided layout
    (the stacked pipeline defaults to a 128-line tail).

    Args:
        pack: LinePack.
        core_mode: "segmix" (default), "seg" or "rows".
        backend / device / dtype: as :func:`make_multigas_batched_fn`,
            without the portable "xla" path (``Gas`` runs it layer by
            layer, as the JAX engine does).

    Returns:
        fn(temperature[B], pressure[B], vmr[B]) -> [B, num_points] tensor
        of absorption cross sections [m2] on the internal grid;
        ``fn.inner`` skips the envelope guard, ``fn.assemble_layer(t, p,
        x)`` gives one layer's (wings SoA, core params), and
        ``fn.core_plan``, ``fn.wings_stride``, ``fn.wings_csr`` and the
        pass handles expose the stages.
    """
    backend = resolve_backend(backend, device)
    if backend == "xla":
        raise ValueError("make_batched_fn has no portable backend; use "
                         "Gas(..., backend='xla')")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    tile = tile or lc.DEFAULT_TILE
    chunk = chunk or lc.DEFAULT_CHUNK
    arrays_np, static = device_line_pack(pack, grid, cut_off=cut_off)
    num_points = static["num_points"]
    n_per_v = static["n_per_v"]
    v0 = static["v0"]
    keep = static["num_lines"]
    guard = _envelope_guard(t_max, p_max_atm)

    def tensors(temperature, pressure, vmr):
        return tuple(_layer_tensor(a, device, dtype).reshape(-1)
                     for a in (temperature, pressure, vmr))

    def fn(temperature, pressure, vmr):
        t, p, x = tensors(temperature, pressure, vmr)
        guard(t, p)
        return fn.inner(t, p, x)

    if keep == 0:
        fn.inner = lambda t, p, x: torch.zeros(
            (tensors(t, p, x)[0].shape[0], num_points), dtype=dtype,
            device=device)
        return fn

    # Layer-independent CSR windows from unshifted positions, +/-1
    # wavenumber slop; core instance windows inside them.
    nu = pack.nu[:keep]
    b0 = np.floor(nu).astype(np.int64)
    s_wide = (b0 - 1 - cut_off - v0) * n_per_v
    e_wide = (b0 + 1 + cut_off + 1 - v0) * n_per_v
    host = {"nu": nu, "mass": pack.mass[:keep],
            "delta_air": pack.delta_air[:keep],
            "gamma_air": pack.gamma_air[:keep], "n_air": pack.n_air[:keep]}
    center0, reach, y_ref = _core_reach(host, v0, n_per_v, cut_off, t_max,
                                        p_max_atm)
    stage = _LineStage(arrays_np, static, s_wide, e_wide,
                       np.maximum(center0 - reach, s_wide),
                       np.minimum(center0 + reach, e_wide), y_ref,
                       num_points, tile, chunk, core_mode, wings_tail,
                       device, dtype, backend == "plain")

    fn.inner = lambda t, p, x: stage.run(*tensors(t, p, x))
    fn.assemble_layer = lambda t, p, x: tuple(
        a[0] for a in stage.assemble(*tensors([t], [p], [x])))
    return stage.attach(fn)


def make_batched_tpu_fn(pack, grid, cut_off=c.DEFAULT_CUT_OFF, tile=None,
                        chunk=None, t_max=350.0, p_max_atm=5.0,
                        interpret=False, core_mode=None, wings_tail=None, *,
                        backend="kernel", device="cuda",
                        dtype=torch.float32):
    """The JAX package's ``make_batched_tpu_fn``, with its parameters in
    its order: :func:`make_batched_fn` on ``device``.  ``interpret=True``
    (Pallas's interpret mode) runs the kernels' plain versions
    (``backend="plain"``)."""
    return make_batched_fn(pack, grid, cut_off, tile, chunk, t_max,
                           p_max_atm, core_mode, wings_tail,
                           backend=resolve_backend(backend, device,
                                                   interpret),
                           device=device, dtype=dtype)


def make_stacked_pedestal_remover(packs, grid, cut_off=c.DEFAULT_CUT_OFF):
    """Reference-exact pedestal removal for [B, G, num_points] fields, on
    the field's device.

    The sequential pedestal scan (models/lines/pedestal.py, reference
    spectra.c:66-78) runs, gas by gas, as ops/pedestal_cuda.py's float64
    line physics, endpoint contributions, scan, bucket totals and
    bucket-window field: CUDA kernels for a field on the card, each gas
    on a stream of its own, their plain versions for one on the CPU.  Per
    call the host computes only [B]-sized values (the TIPS Q(T) per
    isotopologue slot, the buckets' range) and sends them in one copy,
    from pinned memory to a card; it fetches nothing, so it never waits
    for the card.  The field is the pedestals, each rounded to the
    field's dtype, summed per point in float64 in a fixed order and
    subtracted in the field's dtype: no scatter and no float atomics, so
    repeat calls give the same bits.

    Returns:
        remove(k, temperature[B], pressure[B], vmr_mat[B, G]) -> a new
        tensor of k's shape with pedestals removed; each call opens the
        ``lines.pedestal`` timer and counts ``lines.pedestal_device``.
    """
    from ..models.lines.gas import internal_grid
    from ..ops import pedestal_cuda as pc

    v0, vn, n_per_v, num_points = internal_grid(grid)
    names = list(packs)
    gases = []
    for name in names:
        keep = packs[name].compat_break_filter(v0, vn, cut_off)
        gases.append(pc.GasLines(packs[name], keep) if keep else None)
    windows_np = pc.bucket_windows(v0, vn, n_per_v, num_points, cut_off)
    windows = {}
    live = [g for g, gas in enumerate(gases) if gas is not None]
    streams = {}

    def gas_streams(device):
        """On a card, a stream a live gas, made once: each gas reads and
        writes only its own columns, so the small gases' work runs beside
        the largest gas's."""
        if device.type != "cuda":
            return [contextlib.nullcontext()] * len(live), None
        if str(device) not in streams:
            streams[str(device)] = [torch.cuda.Stream(device) for _ in live]
        side = streams[str(device)]
        main = torch.cuda.current_stream(device)
        for stream in side:
            stream.wait_stream(main)
        return [torch.cuda.stream(stream) for stream in side], main

    def remove(k, temperature, pressure, vmr_mat):
        if not live:
            return k
        with metrics.timed("lines.pedestal"):
            t64 = np.atleast_1d(np.asarray(temperature, np.float64))
            p64 = np.atleast_1d(np.asarray(pressure, np.float64))
            x64 = np.atleast_2d(np.asarray(vmr_mat, np.float64))
            batch = k.shape[0]
            device = k.device
            out = k.reshape(batch, len(names) * num_points).clone(
                memory_format=torch.contiguous_format)
            if str(device) not in windows:
                windows[str(device)] = tuple(
                    torch.as_tensor(w, device=device) for w in windows_np)
            blo, bhi = windows[str(device)]
            # One copy of the [B]-sized inputs: T, p, the mole fractions
            # of the live gases, and each live gas's Q(T) per slot.
            host = [t64, p64] + [x64[:, g] for g in live] \
                + [gases[g].q_slots(t64).ravel() for g in live]
            dev = pc.upload(np.concatenate(host), device)
            t, p = dev[:batch], dev[batch:2 * batch]
            at = (2 + len(live)) * batch
            contexts, main = gas_streams(device)
            for i, g in enumerate(live):
                gas = gases[g]
                x = dev[(2 + i) * batch:(3 + i) * batch]
                q = dev[at:at + gas.num_slots * batch].view(gas.num_slots,
                                                            batch)
                at += gas.num_slots * batch
                b0, nb, margin = gas.bucket_range(p64)
                off = g * num_points
                with contexts[i]:
                    ka = pc.line_inputs(gas.on(device), t, p, x, q, v0,
                                        n_per_v, cut_off, (b0, nb, margin),
                                        num_points)
                    ks, pre, c0, cn = pc.endpoint_contributions(
                        ka, out, off, num_points)
                    ped = pc.scan(ka["bucket"], ka["s_idx"], ka["e_idx"], ks,
                                  pre, c0, cn, num_points, 2 * cut_off + 1,
                                  nb)
                    del ks, pre, c0, cn
                    totals = pc.bucket_totals(ped, ka, out.dtype)
                    del ka, ped
                    pc.subtract_field(out, off, num_points, totals, blo,
                                      bhi, b0)
            if main is not None:
                for stream in streams[str(device)]:
                    main.wait_stream(stream)
            metrics.count("lines.pedestal_device")
        return out.reshape(k.shape)

    return remove


def remove_stacked_pedestal(packs, grid, k, temperature, pressure,
                            vmr_mat, cut_off=c.DEFAULT_CUT_OFF):
    """Reference-exact pedestal removal applied per gas, layer-batched, on
    the host (JAX ``remove_stacked_pedestal``).

    Args:
        packs: dict name -> LinePack in gas order.
        k: [B, G, num_points] cross sections (numpy or tensor; a float64
            copy is returned).
        vmr_mat: [B, G] float64 mole fractions.

    Returns:
        [B, G, num_points] float64 numpy array with each gas's pedestal
        subtracted (reference spectra.c:66-78 semantics,
        models/lines/pedestal.py).
    """
    from ..models.lines.gas import internal_grid
    from ..models.lines.pedestal import (apply_pedestal_batch,
                                         compute_pedestals_batch)
    from ..models.lines.physics import kernel_inputs, line_profile_params

    v0, vn, n_per_v, num_points = internal_grid(grid)
    if isinstance(k, torch.Tensor):
        k = k.cpu().numpy()
    k = np.array(k, np.float64, copy=True)
    for g, (name, pack) in enumerate(packs.items()):
        keep = pack.compat_break_filter(v0, vn, cut_off)
        if keep == 0:
            continue
        params = line_profile_params(pack, temperature, pressure,
                                     vmr_mat[:, g], keep=keep)
        kin = kernel_inputs(params, v0, n_per_v, cut_off)
        kin["nu_raw"] = pack.nu[:keep]
        kin["nu_shift"] = params["nu_shift"]
        ped = compute_pedestals_batch(k[:, g], kin, num_points, n_per_v,
                                      cut_off, device="cpu")
        k[:, g] = apply_pedestal_batch(k[:, g], ped, kin["s_idx"],
                                       kin["e_idx"], num_points)
    return k
