"""Host planners of the line-sharded pipelines (numpy copies of
pylbl_tpu/parallel/lines.py ``shard_line_pack`` .. ``_build_ring_plans``,
held byte-identical to them by tests/test_torch_sharding_plans.py).

- :func:`shard_line_pack` / :func:`shard_stacked_packs` partition a line
  list (one gas, or every gas over the flat stacked grid) into per-shard
  nu-bucket blocks: "halo" (equal-width slabs, boundary lines duplicated),
  "ring" (each line in its owner's block, blocks circulate at run time)
  or "balanced" (equal line counts, one reduce-scatter);
- :func:`_build_shard_plans` / :func:`_build_ring_plans` build the
  kernels' per-shard plans (strided-wings layout plus mixed-slot core
  plan; for the ring one per (step, shard) pair, holding gather indices
  into the arriving block) with the one global wings stride.  The JAX
  functions stack the plans of every shard over a leading [spec] axis;
  the port's steps build only their own shard's plans
  (:func:`shard_plan_list`, :func:`ring_plan_list`), and the two
  ``_build_*`` functions stack those as JAX does.
"""
import numpy as np

from ..ops import lineshape_cuda as lc
from ..utils import constants as c
from .lines import device_line_pack, stack_device_packs

# Per-line block keys exchanged by the ring pass / sharded by nu-bucket.
_LINE_KEYS = ("c_base_int", "c_base_frac", "nu", "sw", "gamma_air",
              "gamma_self", "n_air", "delta_air", "elower", "mass", "q_row",
              "sw_pre", "repwid_base")
# Benign pad values: sw/sw_pre=0 make the physics prefactor exactly 0, so
# padded entries add zeros; mass/nu/repwid_base > 0 keep the broadening
# math finite.
_LINE_PAD = {"c_base_int": 0.0, "c_base_frac": 0.0, "nu": 1.0, "sw": 0.0,
             "gamma_air": 1e-3, "gamma_self": 1e-3, "n_air": 0.0,
             "delta_air": 0.0, "elower": 0.0, "mass": 1.0, "q_row": 0,
             "sw_pre": 0.0, "repwid_base": 1.0}


def shard_line_pack(pack, grid, spec, cut_off=c.DEFAULT_CUT_OFF,
                    mode="halo"):
    """Partitions a molecule's line list into per-shard nu-bucket blocks.

    The spectral grid is split into ``spec`` contiguous slabs; lines are
    assigned by position.  Window bounds come from the *unshifted*
    positions widened by one wavenumber, so the assignment is
    layer-independent (pressure shifts are sub-0.1 cm-1).

    Args:
        spec: number of spectral shards.
        mode: "halo" (each block holds every line whose widened window
            meets its slab; no collective at run time), "ring" (each line
            in exactly its owner's block; blocks circulate up and down the
            spec ring at run time) or "balanced" (equal line counts per
            shard; every shard accumulates the full grid for its lines and
            one reduce-scatter lands each its slab).

    Returns:
        (blocks, q_table, static, info): blocks is a dict of [spec, L]
        float32/int32 arrays (L = the largest block, padded with inert
        lines); info carries ring_steps/local_points/duplication stats.
    """
    from ..models.lines.gas import internal_grid
    v0, vn, n_per_v, num_points = internal_grid(grid)
    arrays, static = device_line_pack(pack, grid, cut_off=cut_off)
    keep = static["num_lines"]
    local_n = -(-num_points // spec)

    b0 = np.floor(pack.nu[:keep]).astype(np.int64)
    s_wide = (b0 - 1 - cut_off - v0) * n_per_v
    e_wide = (b0 + 1 + cut_off + 1 - v0) * n_per_v
    center = np.rint((pack.nu[:keep] - v0) * n_per_v).astype(np.int64)

    los, his, ring_steps = _partition_lines(s_wide, e_wide, center, keep,
                                            spec, local_n, mode)
    blocks = _slice_blocks(arrays, los, his, spec)
    info = {"ring_steps": ring_steps,
            "block_len": int((his - los).max(initial=0)),
            "local_points": local_n, "padded_points": local_n * spec,
            "duplication": float((his - los).sum() / max(keep, 1)),
            "mode": mode}
    return blocks, arrays["q_table"], static, info


def _partition_lines(s_wide, e_wide, center, keep, spec, local_n, mode):
    """Shared shard-assignment logic (window coordinates may be per-gas or
    flat/stacked; both are monotone in processing order)."""
    if keep == 0:
        return np.zeros(spec, np.int64), np.zeros(spec, np.int64), 0
    if mode == "halo":
        slab_lo = np.arange(spec, dtype=np.int64) * local_n
        # s_wide/e_wide are monotone in the (sorted) line positions, so
        # each shard's overlap set is one contiguous slice.
        los = np.searchsorted(e_wide, slab_lo, side="left")
        his = np.searchsorted(s_wide, slab_lo + local_n, side="left")
        return los, his, 0
    if mode == "ring":
        owner = np.clip(center // local_n, 0, spec - 1)
        shards = np.arange(spec, dtype=np.int64)
        los = np.searchsorted(owner, shards, side="left")
        his = np.searchsorted(owner, shards, side="right")
        reach_l = owner - np.clip(s_wide // local_n, 0, spec - 1)
        reach_r = np.clip(e_wide // local_n, 0, spec - 1) - owner
        ring_steps = int(min(max(reach_l.max(initial=0),
                                 reach_r.max(initial=0)), spec - 1))
        return los, his, ring_steps
    if mode == "balanced":
        bounds = np.linspace(0, keep, spec + 1).round().astype(np.int64)
        return bounds[:-1], bounds[1:], 0
    raise ValueError(f"unknown line-sharding mode '{mode}'")


def _slice_blocks(arrays, los, his, spec):
    lengths = his - los
    block_len = int(lengths.max(initial=0))
    blocks = {}
    for key in _LINE_KEYS + (("gas_idx", "flat_off")
                             if "flat_off" in arrays else ()):
        src = arrays[key]
        out = np.full((spec, block_len), _LINE_PAD.get(key, 0),
                      dtype=src.dtype)
        for s in range(spec):
            out[s, :lengths[s]] = src[los[s]:his[s]]
        blocks[key] = out
    return blocks


def shard_stacked_packs(packs, grid, spec, cut_off=c.DEFAULT_CUT_OFF,
                        mode="balanced"):
    """Gas-stacked AND line-sharded blocks: the full config-5 layout.

    Combines :func:`~pylbl_tpu_torch.parallel.lines.stack_device_packs`
    (every molecule in one launch, flat [G * num_points] grid) with
    :func:`shard_line_pack`'s decompositions over the flat grid.

    Returns:
        (blocks, q_table, static, info, names): blocks additionally carry
        per-line gas_idx/flat_off; info["flat_points"] is the flat output
        size the sharded step decomposes.
    """
    arrays, host, static, names = stack_device_packs(packs, grid, cut_off)
    flat_points = static["flat_points"]
    num_points = static["num_points"]
    n_per_v = static["n_per_v"]
    v0 = static["v0"]
    keep = static["num_lines"]
    local_n = -(-flat_points // spec)

    off = arrays["flat_off"].astype(np.int64)
    b0 = np.floor(host["nu"]).astype(np.int64)
    s_wide = off + np.clip((b0 - 1 - cut_off - v0) * n_per_v, 0,
                           num_points - 1)
    e_wide = off + np.clip((b0 + 1 + cut_off + 1 - v0) * n_per_v, 0,
                           num_points - 1)
    center = off + np.clip(
        np.rint((host["nu"] - v0) * n_per_v).astype(np.int64), 0,
        num_points - 1)

    los, his, ring_steps = _partition_lines(s_wide, e_wide, center, keep,
                                            spec, local_n, mode)
    blocks = _slice_blocks(arrays, los, his, spec)
    info = {"ring_steps": ring_steps,
            "block_len": int((his - los).max(initial=0)),
            "local_points": local_n, "padded_points": local_n * spec,
            "duplication": float((his - los).sum() / max(keep, 1)),
            "mode": mode, "flat_points": flat_points}
    return blocks, arrays["q_table"], static, info, names


def _shard_window_arrays(blk, static):
    """Host wings-window/center arrays for one shard's block.

    Derived from the exact split-center representation (c_base_int/_frac)
    so the widened windows bound the per-layer windows the device physics
    computes; blocks carry float32 nu whose floor can disagree with the
    float64 host nu near integers.
    """
    npv = static["n_per_v"]
    n = static["num_points"]
    cut = static["cut_off"]
    center = blk["c_base_int"].astype(np.int64)
    b0_rel = np.floor((blk["c_base_int"].astype(np.float64)
                       + blk["c_base_frac"]) / npv).astype(np.int64)
    s_wide = (b0_rel - 1 - cut) * npv
    e_wide = (b0_rel + 1 + cut + 1) * npv
    if "flat_off" in blk:
        off = blk["flat_off"].astype(np.int64)
        s_wide = off + np.clip(s_wide, 0, n - 1)
        e_wide = off + np.clip(e_wide, 0, n - 1)
        center = off + np.clip(center, 0, n - 1)
    return s_wide, e_wide, center


def _shard_core_windows(blk, static, s_wide, e_wide, center, t_max,
                        p_max_atm):
    """Layer-independent core-instance windows + y sort key for one
    shard's block (from the block's packed constants: repwid(T) =
    repwid_base / sqrt(T))."""
    npv = static["n_per_v"]
    repwid_base = blk["repwid_base"].astype(np.float64)
    core_w = lc.core_halfwidths(repwid_base / np.sqrt(t_max), npv,
                                static["cut_off"])
    shift_w = np.ceil(np.abs(blk["delta_air"].astype(np.float64))
                      * p_max_atm * npv).astype(np.int64) + 1
    y_ref = (repwid_base / np.sqrt(275.0)) * blk["gamma_air"] \
        * (296.0 / 275.0) ** blk["n_air"]
    if "flat_off" in blk:
        n = static["num_points"]
        off = blk["flat_off"].astype(np.int64)
        local_c = center - off
        core_lo = off + np.clip(local_c - core_w - shift_w, 0, n - 1)
        core_hi = off + np.clip(local_c + core_w + shift_w, 0, n - 1)
    else:
        core_lo = np.maximum(center - core_w - shift_w, s_wide)
        core_hi = np.minimum(center + core_w + shift_w, e_wide)
    return core_lo, core_hi, y_ref


def _pad_1d(v, size, fill=None):
    pad = size - v.shape[0]
    if pad <= 0:
        return v
    tail = np.full(pad, v[0] if fill is None else fill, dtype=v.dtype)
    return np.concatenate([v, tail])


def _pad_line_dict(consts, size):
    """Pads per-line constants to ``size``, repeating element 0 for the
    physics fields (keeps values in range) but zeroing the strength fields
    so padded slots are inert by construction."""
    return {k: _pad_1d(v, size, 0.0 if k in ("sw", "sw_pre") else None)
            for k, v in consts.items()}


def _block(blocks, s):
    return {k: v[s] for k, v in blocks.items()}


def _block_windows(blocks, static, t_max, p_max_atm):
    """Every block's (s_wide, e_wide, core_lo, core_hi, y_ref) and the
    widest window over all of them (the one global wings stride's input)."""
    spec = next(iter(blocks.values())).shape[0]
    out = []
    window_max = 1
    for s in range(spec):
        blk = _block(blocks, s)
        s_wide, e_wide, center = _shard_window_arrays(blk, static)
        core_lo, core_hi, y_ref = _shard_core_windows(
            blk, static, s_wide, e_wide, center, t_max, p_max_atm)
        out.append((s_wide, e_wide, core_lo, core_hi, y_ref))
        window_max = max(window_max,
                         int((e_wide - s_wide).max(initial=0)) + 1)
    return out, window_max


def shard_plan_list(blocks, static, info, tile, t_max, p_max_atm,
                    shards=None):
    """The halo/balanced plans of the given shards (default: all), each
    unpadded: ([(plan dict, StridedLayout, CorePlan) per shard], meta) or
    None when no stride fits the widest window of ANY shard (the stride is
    global, so every rank's plan agrees with the JAX stacked one).

    A plan dict holds the JAX keys: permuted line constants ("lines"),
    "assign", the wings CSR "w_start"/"w_n" (and the tail CSR
    "tw_start"/"tw_n" on the stacked grid), the instance-order constants
    "inst", "seg0f", "dead", "slotf" and the core CSR
    "t_start"/"t_chunks".
    """
    spec = next(iter(blocks.values())).shape[0]
    balanced = info.get("mode") == "balanced"
    local_n = info["local_points"]
    n_out = info["padded_points"] if balanced else local_n
    windows, window_max = _block_windows(blocks, static, t_max, p_max_atm)
    stride = lc.pick_wings_stride(tile, window_max)
    if stride is None:
        return None
    # Two-class tail layout for the gas-stacked decomposition: its
    # per-gas tiles are sparse.
    tail = 128 if "flat_points" in info else None

    per = []
    for s in range(spec) if shards is None else shards:
        s_wide, e_wide, core_lo, core_hi, y_ref = windows[s]
        origin = 0 if balanced else s * local_n
        _, lay, cp = lc.plan_strided_stage(
            s_wide - origin, e_wide - origin, core_lo - origin,
            core_hi - origin, y_ref, n_out, tile=tile, core_mode="segmix",
            stride=stride, tail=tail)
        consts = lc.permute_line_arrays(_block(blocks, s), lay.perm)
        idx = np.maximum(cp.inst_line, 0)
        plan = {"lines": consts,
                "assign": lay.assign.astype(np.float32),
                "w_start": lay.w_start, "w_n": lay.w_n,
                "inst": {k: np.ascontiguousarray(v[idx])
                         for k, v in consts.items()},
                "seg0f": cp.seg0.astype(np.float32),
                "dead": cp.inst_line < 0,
                "slotf": cp._slotf,
                "t_start": cp.t_start, "t_chunks": cp.t_chunks}
        if tail is not None:
            # Wings tail-chunk CSR ("t_start"/"t_chunks" above are the
            # CORE plan's tile arrays; distinct keys).
            plan["tw_start"] = lay.t_start
            plan["tw_n"] = lay.t_n
        per.append((plan, lay, cp))
    return per, {"stride": stride, "n_out": n_out, "balanced": balanced,
                 "tail": tail}


def _build_shard_plans(blocks, static, info, tile, t_max, p_max_atm):
    """Per-shard execution plans of every shard, padded to common shapes
    and stacked on a leading [spec] axis, as the JAX function returns
    them: (plan dict, meta), or None when no stride fits."""
    built = shard_plan_list(blocks, static, info, tile, t_max, p_max_atm)
    if built is None:
        return None
    per, meta = built
    m_max = max(lay.nlines for _, lay, _ in per)
    i_max = max(cp.inst_line.size for _, _, cp in per)
    lines = [_pad_line_dict(p["lines"], m_max) for p, _, _ in per]
    inst = [_pad_line_dict(p["inst"], i_max) for p, _, _ in per]
    plan = {
        "lines": {k: np.stack([p[k] for p in lines]) for k in lines[0]},
        "assign": np.stack([_pad_1d(p["assign"], m_max, -1.0)
                            for p, _, _ in per]),
        "w_start": np.stack([p["w_start"] for p, _, _ in per]),
        "w_n": np.stack([p["w_n"] for p, _, _ in per]),
        "inst": {k: np.stack([p[k] for p in inst]) for k in inst[0]},
        "seg0f": np.stack([_pad_1d(p["seg0f"], i_max, 0.0)
                           for p, _, _ in per]),
        "dead": np.stack([_pad_1d(p["dead"], i_max, True)
                          for p, _, _ in per]),
        "slotf": np.stack([_pad_1d(p["slotf"], i_max, 0.0)
                           for p, _, _ in per]),
        "t_start": np.stack([p["t_start"] for p, _, _ in per]),
        "t_chunks": np.stack([p["t_chunks"] for p, _, _ in per]),
    }
    if meta["tail"] is not None:
        plan["tw_start"] = np.stack([p["tw_start"] for p, _, _ in per])
        plan["tw_n"] = np.stack([p["tw_n"] for p, _, _ in per])
    return plan, meta


def ring_schedule(info, spec):
    """The ring's stops: ("self", 0), then "up" r = 1..R (block (d - r) mod
    spec arrives) and "dn" r = 1..min(R, spec - 1 - R) (block (d + r) mod
    spec).  Offsets +r and -(spec - r) coincide mod spec; capping the down
    chain keeps every visited block distinct while the up chain's
    wrap-around covers the rest."""
    ring_steps = info["ring_steps"]
    dn_steps = min(ring_steps, spec - 1 - ring_steps)
    return ([("self", 0)]
            + [("up", r) for r in range(1, ring_steps + 1)]
            + [("dn", r) for r in range(1, dn_steps + 1)])


def ring_plan_list(blocks, static, info, tile, t_max, p_max_atm,
                   shards=None):
    """The ring plans of the given slabs (default: all), unpadded:
    ([per stop: [(entry dict, StridedLayout or None, CorePlan or None)
    per slab]], meta) or None when no stride fits.

    For the pair (visiting block b -> slab d) an entry holds the
    strided-wings layout and mixed-slot core plan built over just the
    block lines whose windows reach the slab, with ``wsel``/``isel``
    gather indices into the ARRIVING block (indices, 4 bytes a line, not
    the 13 constant fields: the ring's point is line memory ~1/spec).  A
    pair with no such line gets the all-dead plan: one dead chunk, zero
    core instances.
    """
    spec = next(iter(blocks.values())).shape[0]
    local_n = info["local_points"]
    n_out = local_n
    schedule = ring_schedule(info, spec)
    per_block, window_max = _block_windows(blocks, static, t_max, p_max_atm)
    stride = lc.pick_wings_stride(tile, window_max)
    if stride is None:
        return None
    tail = 128 if "flat_points" in info else None

    step_plans = []
    for kind, r in schedule:
        per = []
        for d in range(spec) if shards is None else shards:
            b = (d - r) % spec if kind in ("self", "up") else (d + r) % spec
            s_wide, e_wide, core_lo, core_hi, y_ref = per_block[b]
            lo = d * local_n
            sel = np.nonzero((e_wide >= lo)
                             & (s_wide < lo + local_n))[0]
            if sel.size == 0:
                m = lc.STRIDED_CHUNK
                num_tiles = (n_out - 1) // stride + 1
                entry = {
                    "wsel": np.zeros(m, np.int32),
                    "wdead": np.ones(m, bool),
                    "assign": np.full(m, -1.0, np.float32),
                    "w_start": np.zeros(num_tiles, np.int32),
                    "w_n": np.zeros(num_tiles, np.int32),
                    "isel": np.zeros(0, np.int32),
                    "idead": np.ones(0, bool),
                    "seg0f": np.zeros(0, np.float32),
                    "slotf": np.zeros(0, np.float32),
                    "t_start": np.zeros(-(-n_out // tile), np.int32),
                    "t_chunks": np.zeros(-(-n_out // tile), np.int32),
                }
                if tail is not None:
                    entry["tw_start"] = np.zeros(num_tiles, np.int32)
                    entry["tw_n"] = np.zeros(num_tiles, np.int32)
                per.append((entry, None, None))
                continue
            _, lay, cp = lc.plan_strided_stage(
                s_wide[sel] - lo, e_wide[sel] - lo,
                core_lo[sel] - lo, core_hi[sel] - lo, y_ref[sel],
                n_out, tile=tile, core_mode="segmix", stride=stride,
                tail=tail)
            wsel = sel[lay.idx].astype(np.int32)
            inst_idx = np.maximum(cp.inst_line, 0)
            entry = {
                "wsel": wsel,
                "wdead": lay.dead,
                "assign": lay.assign.astype(np.float32),
                "w_start": lay.w_start,
                "w_n": lay.w_n,
                "isel": wsel[inst_idx],
                "idead": (cp.inst_line < 0) | lay.dead[inst_idx],
                "seg0f": cp.seg0.astype(np.float32),
                "slotf": cp._slotf,
                "t_start": cp.t_start,
                "t_chunks": cp.t_chunks,
            }
            if tail is not None:
                entry["tw_start"] = lay.t_start
                entry["tw_n"] = lay.t_n
            per.append((entry, lay, cp))
        step_plans.append(per)
    return step_plans, {"stride": stride, "n_out": n_out,
                        "schedule": schedule, "tail": tail}


# Ring entry fills and the axis each padded field is padded to.
_RING_FILLS = {"wsel": 0, "wdead": True, "assign": -1.0, "isel": 0,
               "idead": True, "seg0f": 0.0, "slotf": 0.0}
_RING_LINE_FIELDS = ("wsel", "wdead", "assign")


def _build_ring_plans(blocks, static, info, tile, t_max, p_max_atm):
    """Per-(step, shard) plans of every slab, padded and stacked over
    [spec] per step as the JAX function returns them: (step_plans, meta),
    or None when no stride fits.  The JAX side pads the instance axis to
    at least 128 (a TPU lane width); so does this copy."""
    built = ring_plan_list(blocks, static, info, tile, t_max, p_max_atm)
    if built is None:
        return None
    step_plans, meta = built
    stacked = []
    for per in step_plans:
        entries = [e for e, _, _ in per]
        m_max = max(e["wsel"].size for e in entries)
        i_max = max(max(e["isel"].size for e in entries), 128)
        stacked.append({
            k: np.stack([_pad_1d(e[k], m_max if k in _RING_LINE_FIELDS
                                 else i_max, _RING_FILLS[k])
                         if k in _RING_FILLS else e[k] for e in entries])
            for k in entries[0]})
    return stacked, meta
