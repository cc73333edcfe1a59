"""Stacked all-gases line-absorption pipeline on one device (torch).

Counterpart of the single-device part of pylbl_tpu/parallel/lines.py:

- :func:`device_line_pack` / :func:`stack_device_packs` (host numpy, copied)
  prepare per-line float32 constants for a target grid, every gas's lines
  concatenated over a flat ``[G * num_points]`` output grid;
- :func:`as_tensors` carries those numpy dicts onto a torch device — the
  one conversion point, also used by the tests to feed both packages
  identical inputs;
- :func:`line_kernel_arrays` is the per-layer line physics in torch,
  vectorized over the layer batch;
- :func:`make_multigas_batched_fn` assembles the prepacked wings SoA and the
  mixed-slot core parameters and runs the wings and core passes
  (ops/lineshape_cuda.py: CUDA kernels on the card, plain versions on the
  CPU, or the plain versions anywhere with ``backend="plain"``);
- :func:`make_stacked_pedestal_remover` removes the reference pedestal with
  the host float64 scan and a deterministic box-subtract.

Precision note: line centers are passed as an exact integer grid index
plus a small fractional part computed on the host, so float32 kernels see
no catastrophic cancellation in x = ((p - c_int) - c_frac) * srw.
"""
import numpy as np
import torch

from ..ops import lineshape_cuda as lc
from ..runtime.device import resolve_device
from ..utils import constants as c


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
        dtype: float dtype for the floating fields (default: keep theirs);
            integer fields keep their type.

    Returns:
        dict name -> tensor.
    """
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
    v0 = static["v0"]
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
    center = arrays["c_base_int"] + (arrays["c_base_frac"] + dc)
    bucket = torch.floor(center / n_per_v + v0)
    s_idx = ((bucket - cut_off - v0) * n_per_v).to(torch.int32)
    e_idx = ((bucket + cut_off + 1 - v0) * n_per_v).to(torch.int32)
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
        "c_frac": arrays["c_base_frac"] + dc,
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


def _layer_tensor(value, device, dtype):
    return torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value, device=device).to(dtype)


def make_multigas_batched_fn(packs, grid, cut_off=c.DEFAULT_CUT_OFF,
                             tile=None, chunk=None, t_max=350.0,
                             p_max_atm=5.0, backend="kernel", device="cpu",
                             dtype=torch.float32, wings_tail=128):
    """Builds the all-gases batched pipeline for one grid on one device.

    One wings pass and one core pass per layer batch cover every gas:
    strided overlapped-tile wings (two chunk classes when ``wings_tail``)
    wherever a stride fits the line windows, the splat wings otherwise,
    and the mixed-slot segment-32 core pass.

    Args:
        packs: dict name -> LinePack.
        backend: "kernel" (the wrappers: CUDA kernels for CUDA tensors,
            plain versions for CPU tensors) or "plain" (plain versions on
            any device, in ``dtype``).
        device: torch device of the line constants and outputs.
        dtype: float dtype of the pipeline (the CUDA kernels take
            float32).

    Returns:
        fn(temperature[B], pressure[B], vmr[B, G]) -> [B, G, num_points]
        tensor of absorption cross sections [m2] on the internal grid,
        gases ordered as ``list(packs)``.  ``fn.total(t, p, vmr)`` returns
        the density-weighted gas sum [B, num_points] in m-1.
    """
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    tile = tile or lc.DEFAULT_TILE
    chunk = chunk or lc.DEFAULT_CHUNK
    plain = backend == "plain"
    arrays_np, host, static, names = stack_device_packs(packs, grid,
                                                        cut_off)
    num_points = static["num_points"]
    flat_points = static["flat_points"]
    n_per_v = static["n_per_v"]
    v0 = static["v0"]
    num_gases = static["num_gases"]
    keep = static["num_lines"]

    def _check_envelope(temperature, pressure):
        t_check = np.asarray(temperature.cpu(), np.float64)
        p_check = np.asarray(pressure.cpu(), np.float64) * c.PA_TO_ATM
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

    def _inputs(temperature, pressure, vmr):
        t = _layer_tensor(temperature, device, dtype).reshape(-1)
        p = _layer_tensor(pressure, device, dtype).reshape(-1)
        x = _layer_tensor(vmr, device, dtype).reshape(t.shape[0], -1)
        _check_envelope(t, p)
        return t, p, x

    def _total(k, t, p, x):
        n_density = p[:, None] * x / (c.KB * t[:, None])
        total = k[:, 0] * n_density[:, 0, None]
        for g in range(1, k.shape[1]):
            total = total + k[:, g] * n_density[:, g, None]
        return total

    if keep == 0:
        def empty(temperature, pressure, vmr):
            t, _, _ = _inputs(temperature, pressure, vmr)
            return torch.zeros((t.shape[0], num_gases, num_points),
                               dtype=dtype, device=device)
        empty.total = lambda t, p, x: empty(t, p, x).sum(dim=1)
        return empty

    # Flat windows for the CSR, from unshifted positions +/-1 wavenumber
    # slop, clamped per gas segment then offset.
    off = arrays_np["flat_off"].astype(np.int64)
    b0 = np.floor(host["nu"]).astype(np.int64)
    s_loc = np.clip((b0 - 1 - cut_off - v0) * n_per_v, 0, num_points - 1)
    e_loc = np.clip((b0 + 1 + cut_off + 1 - v0) * n_per_v, 0,
                    num_points - 1)
    s_wide = off + s_loc
    e_wide = off + e_loc

    # Core instance windows, sized for the envelope's widest Doppler core
    # and largest pressure shift, placed in the flat grid.
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
    core_lo = off + np.clip(center0 - core_w - shift_w, 0, num_points - 1)
    core_hi = off + np.clip(center0 + core_w + shift_w, 0, num_points - 1)
    planned = lc.plan_strided_stage(s_wide, e_wide, core_lo, core_hi,
                                    y_ref, flat_points, tile=tile,
                                    chunk=lc.STRIDED_CHUNK, tail=wings_tail)
    if planned is not None:
        wings_stride, lay, core_plan = planned
        arrays_np = lc.permute_line_arrays(arrays_np, lay.perm)
        csr = [lay.w_start, lay.w_n]
        if lay.t_start is not None:
            csr += [lay.t_start, lay.t_n]
        nlines = lay.nlines
        wings_chunk = lc.STRIDED_CHUNK
    else:
        wings_stride = None
        wings_chunk = chunk
        csr = list(lc.tile_line_ranges(s_wide, e_wide, flat_points, tile,
                                       wings_chunk))
        nlines = keep
        core_plan = lc.CorePlan(core_lo, core_hi, flat_points, tile,
                                sort_key=y_ref)
    csr_dev = [torch.as_tensor(a, device=device) for a in csr]
    arrays_dev = as_tensors(arrays_np, device, dtype)
    core_inst = core_plan.expand_line_arrays(arrays_dev)
    pad = -nlines % chunk
    # Prepacked wings rows: Y carries y^2, PREF carries pref*y/sqrt(pi);
    # dead-line fills give zero strength and an empty window.
    fill = (0.0, 0.0, 1.0, 1.0e4, 0.0, -1.0, -2.0, 0.0)

    def assemble(t, p, x):
        """Layer-batch kernel inputs: (wings SoA [B, 8, N], core params
        [B, 8, I])."""
        ka = line_kernel_arrays(arrays_dev, static, t, p, x)
        rows = (ka["c_int"].to(dtype), ka["c_frac"], ka["scaled_repwid"],
                ka["y"] * ka["y"], ka["prefactor"] * ka["y"] * c.RSQRPI,
                ka["s_idx"].to(dtype), ka["e_idx"].to(dtype),
                torch.zeros_like(ka["c_frac"]))
        soa = torch.stack([torch.nn.functional.pad(r, (0, pad), value=v)
                           for r, v in zip(rows, fill)], dim=1)
        ka_i = line_kernel_arrays(core_inst, static, t, p, x)
        return soa.contiguous(), core_plan.seg_params(ka_i).contiguous()

    def wings_pass(soa, plain=plain):
        if wings_stride is not None:
            f = lc.wings_strided_plain if plain else lc.wings_strided_pass
            tail_csr = csr_dev[2:] or [None, None]
            return f(soa, csr_dev[0], csr_dev[1], flat_points, tile,
                     wings_stride, wings_chunk, *tail_csr,
                     tail=wings_tail or 128)
        f = lc.wings_splat_plain if plain else lc.wings_splat_pass
        return f(soa, csr_dev[0], csr_dev[1], flat_points, tile,
                 wings_chunk)

    def core_pass(params, plain=plain):
        return core_plan.core_pass(params, plain=plain)

    def run(t, p, x):
        soa, core = assemble(t, p, x)
        k = wings_pass(soa) + core_pass(core)
        return k.reshape(t.shape[0], num_gases, num_points)

    def fn(temperature, pressure, vmr):
        return run(*_inputs(temperature, pressure, vmr))

    def total(temperature, pressure, vmr):
        t, p, x = _inputs(temperature, pressure, vmr)
        return _total(run(t, p, x), t, p, x)

    fn.total = total
    fn.assemble = lambda t, p, x: assemble(*_inputs(t, p, x))
    fn.wings_pass = wings_pass
    fn.core_pass = core_pass
    fn.core_plan = core_plan
    fn.wings_stride = wings_stride
    fn.wings_chunk = wings_chunk
    fn.wings_csr = tuple(csr[:2])
    fn.wings_tail_csr = tuple(csr[2:]) or None
    fn.names = names
    return fn


def make_stacked_pedestal_remover(packs, grid, cut_off=c.DEFAULT_CUT_OFF):
    """Reference-exact pedestal removal for [B, G, num_points] fields.

    The sequential pedestal scan (models/lines/pedestal.py, reference
    spectra.c:66-78) needs the accumulated field only at each line's left
    window endpoint, so this:

    1. gathers the [B, N_total] endpoint values on the field's device and
       fetches only those;
    2. runs the float64 physics and scan per gas (prefix contributions on
       the field's device, the order-dependent scan natively on the host);
    3. builds the pedestal field with a difference array and a sequential
       float64 cumulative sum per gas segment on the host (deterministic:
       the card's float cumsum and scatter-add are not; float64 keeps the
       running sum over a whole gas segment from losing the small
       residuals the subtraction leaves) and subtracts it, cast to the
       field's dtype, on the device.

    Returns:
        remove(k, temperature[B], pressure[B], vmr_mat[B, G]) -> k with
        pedestals removed.
    """
    from ..models.lines.gas import internal_grid
    from ..models.lines.pedestal import compute_pedestals_batch
    from ..models.lines.physics import kernel_inputs, line_profile_params

    v0, vn, n_per_v, num_points = internal_grid(grid)
    names = list(packs)
    keeps = [packs[n].compat_break_filter(v0, vn, cut_off) for n in names]

    def remove(k, temperature, pressure, vmr_mat):
        t64 = np.atleast_1d(np.asarray(temperature, np.float64))
        p64 = np.atleast_1d(np.asarray(pressure, np.float64))
        x64 = np.atleast_2d(np.asarray(vmr_mat, np.float64))
        batch = k.shape[0]
        k_flat = k.reshape(batch, -1)

        kins, ps_rows = [], []
        for g, name in enumerate(names):
            if keeps[g] == 0:
                kins.append(None)
                continue
            params = line_profile_params(packs[name], t64, p64, x64[:, g],
                                         keep=keeps[g])
            kin = kernel_inputs(params, v0, n_per_v, cut_off)
            kin["nu_raw"] = packs[name].nu[:keeps[g]]
            kin["nu_shift"] = params["nu_shift"]
            kins.append(kin)
            p_s = np.clip(kin["s_idx"], 0, num_points - 1)
            ps_rows.append(g * num_points + p_s)
        if not ps_rows:
            return k
        flat_ps = torch.as_tensor(np.concatenate(ps_rows, axis=1),
                                  device=k.device)
        k_at = k_flat.gather(1, flat_ps).cpu().numpy().astype(np.float64)

        diff = np.zeros((batch, len(names), num_points + 1))
        col = 0
        row0 = (np.arange(batch) * (num_points + 1))[:, None]
        for g, kin in enumerate(kins):
            if kin is None:
                continue
            n_g = kin["s_idx"].shape[1]
            ped = compute_pedestals_batch(
                None, kin, num_points, n_per_v, cut_off,
                k_at_ps=k_at[:, col:col + n_g], device=k.device)
            col += n_g
            live = (kin["s_idx"] < num_points) & (kin["e_idx"] >= 0)
            ped = np.where(live, ped, 0.0).astype(
                np.float64 if k.dtype == torch.float64 else np.float32)
            s = np.clip(kin["s_idx"], 0, num_points - 1)
            e = np.clip(kin["e_idx"], 0, num_points - 1)
            # Every +ped at s in line order, then every -ped at e + 1: the
            # order of np.add.at's two passes, so the same float64 sums.
            diff[:, g] = np.bincount(
                np.concatenate([(row0 + s).ravel(), (row0 + e + 1).ravel()]),
                weights=np.concatenate([ped.ravel(), -ped.ravel()]),
                minlength=batch * (num_points + 1)).reshape(batch, -1)
        field = np.cumsum(diff[..., :num_points], axis=-1)
        field = torch.as_tensor(field, device=k.device).to(k.dtype)
        return (k.reshape(batch, len(names), num_points) - field) \
            .reshape(k.shape)

    return remove
