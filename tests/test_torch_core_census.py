"""The Humlicek cores' census (pylbl_tpu_torch/tools/core_census.py).

Its float32 counts are held against a brute-force count: every (layer,
chunk, instance, offset) of the walk visited one by one in numpy float32
scalars, labelled by the kernel's scalar rules (csrc/lineshape.cu
``core_needs``, ``region_limits``, ``region_at``), on a small plan with
every class and region present: a y <= 1e-6 chunk, chunks at y >= 70.55,
dead instances, and windows inside, across and outside offsets 0..31.
The counts add up (needed + not needed = in-window, in-window + outside =
the lane evaluations), on that plan and on a real pipeline's.  The unit
walk's censuses (CORR's lines over a tile CSR, the rows core's instances
over their rows) are held the same way, pair by pair, with the need
window of ``pair_item`` in float32 scalars: no needed point lies outside
it.
"""
import numpy as np
import pytest
import torch

from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel.lines import make_multigas_batched_fn
from pylbl_tpu_torch.tools import (CENSUS_OPS, OPS_K1_LIMIT, OPS_LIMITS,
                                   census_ops)
from pylbl_tpu_torch.tools import core_census as cc

torch.set_num_threads(1)
f32 = np.float32


def limits(y):
    """region_limits in float32 scalars: (xlim0, xlim1, xlim2, xlim3,
    xlim4)."""
    xlim0 = np.sqrt(max(f32(15100.0) + y * (f32(40.0) - y * f32(3.6)),
                        f32(0.0)))
    xlim1 = f32(0.0) if y >= f32(8.425) else np.sqrt(max(
        f32(164.0) - y * (f32(4.3) + y * f32(1.8)), f32(0.0)))
    xlim2 = f32(6.8) - y
    xlim3 = f32(2.4) * y
    xlim4 = f32(18.1) * y + f32(1.65)
    if y <= f32(1e-6):
        xlim1 = xlim2 = xlim0
    return xlim0, xlim1, xlim2, xlim3, xlim4


def brute_force(params, t_start, t_chunks):
    """Label counts, chunk classes and instance counts, one point at a
    time."""
    labels = {k: 0 for k in ("out", "none", "k1", "r1", "r2", "r3",
                             "cpf12_i", "cpf12_ii")}
    classes = [0] * 5
    instances = nothing = 0
    by_list = {k: 0 for k in ("k1", "r1", "r2", "r3", "cpf12")}
    for b in range(params.shape[0]):
        for t in range(t_chunks.size):
            for k in range(int(t_chunks[t])):
                col = (int(t_start[t]) + k) * 128
                blk = params[b, :, col:col + 128]
                ymin = blk[lc.SR_Y].min()
                cls = 0 if ymin >= f32(70.55) else 1 if ymin >= f32(8.425) \
                    else 2 if ymin >= f32(6.8) else 3 if ymin >= f32(2.0) \
                    else 4
                classes[cls] += 1
                for i in range(128):
                    seg0, cfrac, srw, y, _, s, e, _ = blk[:, i]
                    seen = set()
                    for o in range(32):
                        of = f32(o)
                        if not (of >= s and of <= e):
                            labels["out"] += 1
                            continue
                        seen.add("in")
                        x = ((seg0 + of) - cfrac) * srw
                        abx = abs(x)
                        lab = "none"
                        if cls == 1:
                            lim = max(f32(15100.0) + y * (f32(40.0)
                                                          - y * f32(3.6)),
                                      f32(0.0))
                            if x * x < lim and y < f32(70.55):
                                lab = "k1"
                        elif cls > 1:
                            x0, x1, x2, x3, x4 = limits(y)
                            if abx < x0 and y < f32(70.55):
                                if abx >= x1:
                                    lab = "r1"
                                elif cls == 2 or abx >= x2:
                                    lab = "r2"
                                elif cls == 3 or abx < x3:
                                    lab = "r3"
                                else:
                                    lab = "cpf12_i" if abx <= x4 \
                                        else "cpf12_ii"
                        labels[lab] += 1
                        seen.add(lab[:5])
                    if "in" in seen:
                        instances += 1
                        nothing += len(seen - {"in", "none"}) == 0
                    for key in by_list:
                        by_list[key] += key in seen
    return labels, classes, instances, nothing, by_list


@pytest.mark.parametrize("seed", [0, 1])
def test_census_matches_brute_force(seed):
    params, t_start, t_chunks, _ = cc.synthetic_core(seed)
    got = cc.census(torch.as_tensor(params), t_start, t_chunks)
    labels, classes, instances, nothing, by_list = brute_force(
        params, t_start, t_chunks)
    assert got["chunks"] == 2 * int(t_chunks.sum())
    assert list(got["chunks_by_class"].values()) == classes
    assert all(classes)                             # every class present
    assert got["needed"] == {k: labels[k] for k in got["needed"]}
    assert all(got["needed"].values())              # every region present
    assert got["in_window"] == sum(labels.values()) - labels["out"]
    assert got["instances"] == instances
    assert got["instances_needing_nothing"] == nothing
    assert got["instances_by_list"] == by_list
    # The plan holds what the census must see: tiny y, y >= 70.55 inside
    # a chunk that is walked, dead fills, windows outside 0..31.
    y = params[:, lc.SR_Y]
    assert (y <= 1e-6).any() and (y >= 70.55).any() and (y == 100.0).any()
    assert ((params[:, lc.SR_EREL] < 0) | (params[:, lc.SR_SREL] > 31)).any()


@pytest.mark.parametrize("seed,classes", [(0, (0, 1, 2, 3, 4)),
                                          (5, (4, 4, 4, 1))])
def test_segment_census_matches_brute_force(seed, classes):
    """The segment core's census (``SegCell.census``: the mixed-slot
    census over a seg plan's chunk CSR, its instances all in slot 0) on
    a synthetic segment input of every class (and a class-4-heavy one)
    in streams of several chunks: the brute-force counts."""
    params, t_start, t_chunks, c_slot, n = cc.synthetic_segment(
        seed, "core", odd=False, classes=classes, slots_used=2)
    plan = lc.CorePlan.__new__(lc.CorePlan)       # the walk alone
    plan.kind, plan.tile, plan.num_points, plan._dev = "core", 256, n, {}
    plan.mode, plan.t_start, plan.t_chunks = "seg", t_start, t_chunks
    plan.slot, plan.c_slot = None, c_slot
    plan.seg0 = plan.inst_line = np.zeros(params.shape[-1], np.int64)
    plan.streams = lc.SegStreams(t_start, t_chunks, c_slot, 8)
    cell = cc.SegCell("S", plan, torch.as_tensor(params))
    got = cell.census()
    labels, classes_seen, instances, nothing, by_list = brute_force(
        params, t_start, t_chunks)
    assert (params[:, lc.SR_SLOT] == 0).all()
    assert list(got["chunks_by_class"].values()) == classes_seen
    assert got["needed"] == {k: labels[k] for k in got["needed"]}
    assert got["needed"]["cpf12_i"] and got["needed"]["r3"]
    assert got["in_window"] == sum(labels.values()) - labels["out"]
    assert got["instances"] == instances
    assert got["instances_needing_nothing"] == nothing
    assert got["instances_by_list"] == by_list
    assert np.diff(plan.streams.ptr).max() > 1


def test_census_counts_add_up():
    """needed + in-window needing nothing = in-window; in-window + outside
    = lane evaluations; the classes add up to the chunks; on the
    synthetic plan and on a real two-gas pipeline at two tiles."""
    params, t_start, t_chunks, _ = cc.synthetic_core(2, layers=3)
    cases = [(torch.as_tensor(params), t_start, t_chunks)]
    packs = {"H2O": synthetic_line_pack("H2O", num_lines=800, nu_min=20.0,
                                        nu_max=180.0, seed=5,
                                        band_centers=(60.0, 150.0)),
             "CO2": synthetic_line_pack("CO2", num_lines=300, nu_min=5.0,
                                        nu_max=190.0, seed=6,
                                        band_centers=(100.0,))}
    for tile in (256, 1024):
        fn = make_multigas_batched_fn(packs, np.arange(1.0, 200.0, 0.1),
                                      tile=tile, chunk=128, device="cpu")
        _, core = fn.assemble(np.asarray([288.99, 227.74]),
                              np.asarray([98388.0, 1032.0]),
                              np.asarray([[6.6e-03, 3.6e-04],
                                          [4.8e-06, 3.6e-04]]))
        plan = fn.core_plan
        cases.append((core, plan.t_start, plan.t_chunks))
    for params, t_start, t_chunks in cases:
        got = cc.census(params, t_start, t_chunks)
        label, _ = cc.pair_labels(cc.walked_blocks(params, t_start,
                                                   t_chunks))
        none = int((label == cc.NONE).sum())
        assert got["needed_total"] + none == got["in_window"]
        assert got["needed_total"] == sum(got["needed"].values())
        outside = int((label == cc.OUT).sum())
        assert got["in_window"] + outside == got["lane_evals"]
        assert sum(got["chunks_by_class"].values()) == got["chunks"]
        assert got["lane_evals"] == got["chunks"] * 128 * 32
        assert got["instances_needing_nothing"] <= got["instances"]
        assert got["needing_k1_chunks"] + got["needing_region_chunks"] \
            == got["instances"] - got["instances_needing_nothing"]
        assert got["needed_total"] > 0
        # Rounds of 32 pairs: at least the pairs over 32, at most that
        # plus one a list of each chunk.
        assert got["needed_total"] <= 32 * got["rounds"] \
            < got["needed_total"] + 32 * 5 * got["chunks"]


def test_census_ops_counts_each_list():
    """census_ops: each needed point at its list's count, each instance
    with one at its limits' cost."""
    counts = {"needed": {"k1": 3, "r1": 5, "r2": 7, "r3": 11,
                         "cpf12_i": 13, "cpf12_ii": 17},
              "needing_k1_chunks": 19, "needing_region_chunks": 23}
    want = (3 * CENSUS_OPS["k1"] + 5 * CENSUS_OPS["r1"]
            + 7 * CENSUS_OPS["r2"] + 11 * CENSUS_OPS["r3"]
            + 30 * CENSUS_OPS["cpf12"] + 19 * OPS_K1_LIMIT
            + 23 * OPS_LIMITS)
    assert census_ops(counts) == want
    assert CENSUS_OPS["cpf12"] > 10 * CENSUS_OPS["r1"]


@pytest.mark.parametrize("scale,by", [(1, "operations"), (10 ** 6, "bytes")])
def test_census_bound_is_the_larger_of_operations_and_bytes(scale, by):
    """census_bound: the census's operations over the FP32 peak, or the
    bytes over the memory rate where they take longer."""
    from pylbl_tpu_torch.tools import PEAK_BYTES, PEAK_OPS, census_bound

    counts = {"needed": {"k1": 0, "r1": 1000, "r2": 0, "r3": 0,
                         "cpf12_i": 0, "cpf12_ii": 0},
              "needing_k1_chunks": 0, "needing_region_chunks": 100}
    nbytes = 1000 * scale
    ms, bound_by = census_bound(counts, nbytes)
    assert bound_by == by
    assert ms == max(census_ops(counts) / PEAK_OPS,
                     nbytes / PEAK_BYTES) * 1e3


# --- The unit walk's census (CORR and the rows core). ---

def item_window(ws, we, c_int, c_frac, srw, y, pref, cls):
    """csrc ``pair_item``'s need window in float32 scalars: (lo, hi)."""
    if cls > 0 and not np.isfinite(pref):
        return ws, we
    if cls == 0 or not y < f32(70.55):
        return f32(0.0), f32(-1.0)
    if cls == 1:
        x0 = np.sqrt(max(f32(15100.0) + y * (f32(40.0) - y * f32(3.6)),
                         f32(0.0)))
    else:
        x0 = limits(y)[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        half = (x0 / abs(srw)) * f32(1.0009765625)
    far = f32(2.0 ** 21)
    if half <= far and abs(c_int) <= far and abs(c_frac) <= far:
        c = c_int + c_frac
        lo = np.floor(c - half) - f32(1.0)
        hi = np.ceil(c + half) + f32(1.0)
        ws = lo if lo > ws else ws
        we = hi if hi < we else we
    return ws, we


def item_class(y):
    return 0 if not y < f32(70.55) else 1 if y >= f32(8.425) \
        else 2 if y >= f32(6.8) else 3 if y >= f32(2.0) else 4


def brute_items(items):
    """The unit walk's counts, one (item, point) at a time: ``items``
    yields (c_int, c_frac, srw, y, pref, ws, we, class, points), the
    points a list of float32 whole groups of 32."""
    labels = {k: 0 for k in ("out", "none", "k1", "r1", "r2", "r3",
                             "cpf12_i", "cpf12_ii")}
    out = {"classes": [0] * 5, "instances": 0, "nothing": 0,
           "by_list": {k: 0 for k in ("k1", "r1", "r2", "r3", "cpf12")},
           "k1_items": 0, "region_items": 0, "visits": 0, "rows": 0,
           "parent": 0, "outside": 0}
    for c_int, c_frac, srw, y, pref, ws, we, cls, points in items:
        out["classes"][cls] += 1
        lo, hi = item_window(ws, we, c_int, c_frac, srw, y, pref, cls)
        seen = set()
        for g in range(0, len(points), 32):
            glo, ghi = points[g], points[g + 31]
            out["visits"] += bool(hi >= glo and lo <= ghi)
            out["parent"] += bool(cls > 0 and we >= glo and ws <= ghi)
            row = False
            for p in points[g:g + 32]:
                if not (p >= ws and p <= we):
                    labels["out"] += 1
                    continue
                seen.add("in")
                x = ((p - c_int) - c_frac) * srw
                abx = abs(x)
                lab = "none"
                live = cls > 0 and y < f32(70.55) and np.isfinite(pref)
                if live and cls == 1:
                    lim = max(f32(15100.0) + y * (f32(40.0) - y * f32(3.6)),
                              f32(0.0))
                    lab = "k1" if x * x < lim else "none"
                elif live:
                    x0, x1, x2, x3, x4 = limits(y)
                    if abx < x0:
                        lab = "r1" if abx >= x1 else "r2" \
                            if cls == 2 or abx >= x2 else "r3" \
                            if cls == 3 or abx < x3 else "cpf12_i" \
                            if abx <= x4 else "cpf12_ii"
                labels[lab] += 1
                seen.add(lab[:5])
                if lab != "none":
                    row = True
                    out["outside"] += not (p >= lo and p <= hi)
            out["rows"] += row
        if "in" in seen:
            out["instances"] += 1
            needing = bool(seen - {"in", "none"})
            out["nothing"] += not needing
            if needing:
                out["k1_items" if cls == 1 else "region_items"] += 1
        for key in out["by_list"]:
            out["by_list"][key] += key in seen
    return labels, out


def corr_items(soa, start, nchunks, tile, chunk):
    for b in range(soa.shape[0]):
        for t in range(nchunks.size):
            points = [f32(t * tile + o) for o in range(tile)]
            for k in range(int(nchunks[t])):
                line0 = int(start[t]) + k * chunk
                for line in range(line0, line0 + chunk):
                    c_int, c_frac, srw, y, pref, ws, we, _ = soa[b, :, line]
                    yield (c_int, c_frac, srw, y, pref, ws, we,
                           item_class(y), points)


def rows_items(groups, g_start, g_n, tile):
    row_w = tile // 8
    for b in range(groups.shape[0]):
        for t in range(g_n.size):
            for col in range(int(g_start[t]),
                             int(g_start[t]) + int(g_n[t]) * 128):
                cls = item_class(groups[b, lc.YMIN_ROW, col])
                for r in range(8):
                    c_int, c_frac, srw, y, pref, s, e = \
                        groups[b, r::8][:lc.N_FIELDS, col]
                    points = [f32(t * tile + r * row_w + o)
                              for o in range(row_w)]
                    yield c_int, c_frac, srw, y, pref, s, e, cls, points


def check_against_brute_force(got, labels, out):
    assert got["needed"] == {k: labels[k] for k in got["needed"]}
    assert got["in_window"] == sum(labels.values()) - labels["out"]
    assert got["pairs"] == sum(labels.values())
    assert list(got["items_by_class"].values()) == out["classes"]
    assert got["instances"] == out["instances"]
    assert got["instances_needing_nothing"] == out["nothing"]
    assert got["instances_by_list"] == out["by_list"]
    assert got["needing_k1_chunks"] == out["k1_items"]
    assert got["needing_region_chunks"] == out["region_items"]
    assert got["visits"] == out["visits"] and got["rows"] == out["rows"]
    assert got["parent_lane_evals"] == 32 * out["parent"]
    assert got["needed_outside"] == out["outside"] == 0
    assert all(got["needed"].values())              # every list present
    assert all(out["classes"])                      # every class present
    assert got["rows"] <= got["visits"] < got["parent_lane_evals"] // 32


@pytest.mark.parametrize("seed", [0, 1])
def test_corr_census_matches_brute_force(seed):
    """corr_census: CORR's (line, point) pairs over the tile CSR, the class
    from the line's own y, against a count one pair at a time in float32
    scalars: labels, classes, items, the point groups the need window
    meets and those with a needed point, the earlier walk's lanes, and no
    needed point outside the need window."""
    soa, start, nchunks, _ = cc.synthetic_corr(seed, layers=2, tile=256,
                                               num_tiles=2, num_lines=120,
                                               chunk=32)
    got = cc.corr_census(torch.as_tensor(soa), start, nchunks, 256, 32)
    labels, out = brute_items(corr_items(soa, start, nchunks, 256, 32))
    check_against_brute_force(got, labels, out)


@pytest.mark.parametrize("seed", [0, 2])
def test_rows_census_matches_brute_force(seed):
    """rows_census: the rows core's (instance, point) pairs of each row,
    the class from the group's min y, against a count one pair at a time
    (dead slots, instances at y >= 70.55 in walked groups among them)."""
    groups, plan, _ = cc.synthetic_rows(seed, layers=1, tile=256,
                                        num_tiles=2, num_lines=120)
    got = cc.rows_census(torch.as_tensor(groups), plan.g_start, plan.g_n,
                         256)
    labels, out = brute_items(rows_items(groups[None], plan.g_start,
                                         plan.g_n, 256))
    check_against_brute_force(got, labels, out)


@pytest.mark.parametrize("kind", ["corr", "rows", "rows_vmem"])
def test_pair_bytes_counts_the_rows_the_function_reads(kind):
    """pair_bytes: the unit walk's bytes are the parameter rows its plain
    version reads, its index tensors and its output, no more.  The rows
    it leaves out (CORR's _PAD row; the rows core's seven zero rows, and
    row 56 where the separate min-y block takes its place) filled with NaN
    leave the plain version's output bit for bit as it was."""
    from pylbl_tpu_torch.tools import pair_bytes

    if kind == "corr":
        soa, start, nchunks, n = cc.synthetic_corr(0, layers=2, tile=256,
                                                   num_tiles=2,
                                                   num_lines=120, chunk=32)
        data = torch.as_tensor(soa)
        index = [torch.as_tensor(start), torch.as_tensor(nchunks)]
        unread, extra = [lc._PAD], []

        def plain(d):
            return lc.tile_plain(d, *index, n, 256, 32, "core")
    else:
        groups, plan, n = cc.synthetic_rows(0, layers=2, tile=256,
                                            num_tiles=2, num_lines=120)
        data = torch.as_tensor(groups)
        index = list(plan.walk.tensors("cpu"))
        unread = list(range(lc.YMIN_ROW + 1, lc.GROUP_ROWS))
        ymin = None
        if kind == "rows_vmem":
            ymin = lc.group_min_y(data).clone()
            unread.append(lc.YMIN_ROW)
        extra = [] if ymin is None else [ymin]

        def plain(d):
            return lc.rows_plain(d, *index, n, 256, ymin=ymin)
    want = plain(data)
    poisoned = data.clone()
    poisoned[:, unread, :] = float("nan")
    got = plain(poisoned)
    assert torch.isfinite(want).all() and float(want.abs().max()) > 0
    assert torch.equal(got, want)
    read = [data[:, [r for r in range(data.shape[1]) if r not in unread]]]
    nbytes = sum(t.numel() * t.element_size()
                 for t in read + extra + index) \
        + want.numel() * want.element_size()
    assert pair_bytes(kind, data, index, n) == nbytes
    assert pair_bytes(kind, data[0], index, n) \
        == nbytes - (read[0][0].numel() + sum(t[0].numel() for t in extra)
                     + want[0].numel()) * 4
