"""CORR's unit walk (csrc/lineshape.cu ``corr_walk_kernel``) on the CPU.

The kernel cannot run here, so its arithmetic is held through a model of
what its blocks compute, phase by phase:

- each line of a landed chunk becomes an item (``pair_item``, transcribed
  as ``core_census.pair_items``): its class from its own y (skipped at y
  >= 70.55 or NaN) and the need window, the wing window
  narrowed to the points that can need a correction (a non-finite
  prefactor keeps the wing window);
- the units, an item with each point group of 32 its need window meets,
  in item order; classify each unit's points (``unit_needs``): the point
  in the need window, then x^2 < k1_limit (class 1) or |x| < xlim0 and
  region_at's tests, giving the list of each point (K1, region 1, 2, 3,
  CPF12, or every in-window point of a non-finite prefactor);
- evaluate each list through the plain correction functions
  (ops/voigt.py: the region bodies minus the Lorentzian, the K1 form, the
  whole class correction) into the units' values;
- sum each point group's units in unit order (line order) into the chunk
  partial from +0.0, the chunk partials into the piece, the pieces in
  piece order.

The model equals ``_tile_partials_plain(line="corr")`` folded as the
kernel folds (``tile_plain(..., "core")``) bit for bit, at tiles 256, 512
and 1024, one layer and two, on the core-window CSR and the wing-window
CSR, at pieces of 1 and 2 chunks, on inputs made from a numpy seed with
every class and region, a tiny y, lines at y >= 70.55 and NaN y, dead pad
lines, a non-finite prefactor and windows across point groups (a NaN y
takes class 4, the whole correction, as the JAX conds take it).  The need
window holds every point that needs a correction, by brute force.  The
plain version still matches the JAX ``_pallas_pass(..., "core")`` in
interpret mode on a class-4-heavy input at the tolerance of
tests/test_torch_lineshape.py ``test_tile_pass_matches_pallas[core]``.
The kernel itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.tools import core_census as cc
from pylbl_tpu_torch.tools import nonfinite as nf
from test_torch_core_walk import ANY, K1, R1, list_value

torch.set_num_threads(1)
GROUP = 32


def walk_lists(items, p):
    """([M, P] list of each (item, point) the walk lists, -1 for none;
    x), as unit_needs labels the points of the units (the point groups
    the need window meets): a point outside the need window is never
    listed."""
    col = {k: v[:, None] for k, v in items.items()}
    x = ((p - col["c_int"]) - col["c_frac"]) * col["srw"]
    abx = x.abs()
    cls = col["cls"]
    region = torch.where(
        abx >= col["xlim1"], 0, torch.where(
            (cls == 2) | (abx >= col["xlim2"]), 1,
            torch.where((cls == 3) | (abx < col["xlim3"]), 2, 3)))
    lst = torch.where(cls == 1, torch.where(x * x < col["lim0"], K1, -1),
                      torch.where(abx < col["lim0"], R1 + region, -1))
    lst = torch.where(col["any"], ANY, lst)
    listed = (p >= col["lo"]) & (p <= col["hi"]) & (cls > 0)
    return torch.where(listed, lst, -1), x


def walk_values(items, p):
    """([M, P] pref * the value of each listed pair, +0.0 elsewhere; the
    lists): each list evaluated through the plain functions, per class."""
    lists, x = walk_lists(items, p)
    val = torch.zeros_like(x)
    for lst in range(ANY + 1):
        for cls in range(1, 5):
            m, q = torch.nonzero(
                (lists == lst) & (items["cls"] == cls)[:, None],
                as_tuple=True)
            if m.numel():
                v = list_value(x[m, q], items["y"][m], cls, lst)
                val[m, q] = items["pref"][m] * v
    return val, lists


def walk_sums(items, p, seen=None):
    """[P] the points' sums from +0.0 over the units in order: per item in
    order, each point group of 32 with a listed point adds the unit's
    values (its unlisted points +0.0; a unit with none adds +0.0 only)."""
    val, lists = walk_values(items, p)
    if seen is not None:
        seen.append((items, lists))
    part = p.new_zeros(p.shape[-1])
    rows = (lists >= 0).reshape(lists.shape[0], -1, GROUP).any(dim=-1)
    for m, j in torch.nonzero(rows).tolist():
        g = slice(GROUP * j, GROUP * (j + 1))
        part[g] = part[g] + val[m, g]
    return part


def fold(pieces):
    """A tile of one piece is that piece, else ((0 + P0) + P1) + ..."""
    if len(pieces) == 1:
        return pieces[0]
    tot = torch.zeros_like(pieces[0])
    for q in pieces:
        tot = tot + q
    return tot


def line_items(rows):
    """The items of lines' raw SoA rows [8, M], the class from own y."""
    y = rows[lc.Y]
    return cc.pair_items(rows[lc.S_IDX], rows[lc.E_IDX], rows[lc.C_INT],
                         rows[lc.C_FRAC], rows[lc.SRW], y, rows[lc.PREF],
                         cc.item_class(y))


def corr_model(soa, start, nchunks, n, tile, chunk, piece=1, seen=None):
    """[B, n]: per (layer, tile) each chunk's partial from the walk, added
    into its piece in walk order, the pieces folded in piece order."""
    out = soa.new_zeros((soa.shape[0], len(nchunks), tile))
    offs = torch.arange(tile)
    for b in range(soa.shape[0]):
        for t in range(len(nchunks)):
            p = (t * tile + offs).to(soa.dtype)
            pieces = []
            for k0 in range(0, max(int(nchunks[t]), 1), piece):
                acc = soa.new_zeros(tile)
                for k in range(k0, min(k0 + piece, int(nchunks[t]))):
                    line0 = int(start[t]) + k * chunk
                    items = line_items(soa[b, :, line0:line0 + chunk])
                    acc = acc + walk_sums(items, p, seen)
                pieces.append(acc)
            out[b, t] = fold(pieces)
    return out.reshape(soa.shape[0], -1)[:, :n]


def same_bits(got, want):
    """Equal values and equal NaN positions."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) \
        and torch.equal(got[~nan], want[~nan])


def corr_input(seed, tile, layers=2, csr="core", **kwargs):
    soa, start, nchunks, n = cc.synthetic_corr(seed, layers=layers,
                                               tile=tile, csr=csr, **kwargs)
    soa = torch.as_tensor(soa)
    return (soa if layers > 1 else soa[None]), start, nchunks, n


@pytest.mark.parametrize("tile,layers,csr,piece", [
    (256, 2, "core", 1), (256, 1, "wings", 1), (256, 2, "core", 2),
    (512, 2, "core", 1), (1024, 1, "core", 1), (1024, 2, "wings", 2)])
def test_model_equals_plain_on_every_class_and_region(tile, layers, csr,
                                                      piece):
    """Every class (a skipped line, K1, 2, 3, 4 with y = 0 and a tiny y),
    every list, dead pad lines, need windows across point groups, on the
    core-window CSR and the wing-window CSR: the model equals the plain
    version bit for bit, never -0.0, and every list is met."""
    soa, start, nchunks, n = corr_input(tile // 64, tile, layers, csr,
                                        num_tiles=max(2, 1280 // tile))
    seen = []
    got = corr_model(soa, start, nchunks, n, tile, 64, piece, seen)
    want = lc.tile_plain(soa, start, nchunks, n, tile, 64, "core",
                         piece=piece)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())
    classes = torch.cat([it["cls"] for it, _ in seen])
    assert set(classes.unique().tolist()) == {0, 1, 2, 3, 4}
    lists = torch.cat([ls.reshape(-1) for _, ls in seen])
    assert set(lists.unique().tolist()) == {-1, K1, R1, R1 + 1, R1 + 2,
                                            R1 + 3}
    if piece > 1:
        assert int(nchunks.max()) > piece          # a tile of pieces
    # Need windows narrower than the wing windows, some across a group.
    lo = torch.cat([it["lo"][it["live"]] for it, _ in seen])
    hi = torch.cat([it["hi"][it["live"]] for it, _ in seen])
    ws = torch.cat([it["ws"][it["live"]] for it, _ in seen])
    we = torch.cat([it["we"][it["live"]] for it, _ in seen])
    assert bool(((hi - lo) < (we - ws)).any())
    assert bool(((lo // GROUP) != (hi // GROUP)).any())


def test_model_keeps_non_finite_prefactors_and_takes_a_nan_y_whole():
    """A line of infinite prefactor keeps its whole wing window (pref *
    0.0 is NaN there), one of NaN prefactor too; a NaN y takes class 4,
    the whole correction, as JAX's conds, and with an infinite prefactor
    its window is NaN (correction(x, NaN) is 0, inf * 0 NaN); y >= 70.55
    with an infinite prefactor is skipped (+0.0): the model equals the
    plain version bit for bit, NaN for NaN, and the non-finite points are
    those lines' in-window points."""
    soa, start, nchunks, n = corr_input(7, 256, layers=1)
    line0 = int(start[2])
    y = soa[0, lc.Y, line0:line0 + 64]
    live = torch.nonzero((y < 8.0) & (y > 0.5)).flatten()
    a, c, d = (line0 + int(i) for i in live[:3])
    soa[0, lc.PREF, a] = float("inf")
    soa[0, lc.PREF, c] = float("nan")
    soa[0, lc.Y, d] = float("nan")
    soa[0, lc.PREF, d] = float("inf")
    big = line0 + int(torch.nonzero(y >= 70.55).flatten()[0])
    soa[0, lc.PREF, big] = float("inf")
    got = corr_model(soa, start, nchunks, n, 256, 64)
    want = lc.tile_plain(soa, start, nchunks, n, 256, 64, "core")
    assert same_bits(got, want)
    bad = ~torch.isfinite(want[0])
    assert bool(bad.any())
    for line in (a, c, d):
        # The line's window over the tiles whose walk holds it.
        s, e = int(soa[0, lc.S_IDX, line]), int(soa[0, lc.E_IDX, line])
        inside = torch.zeros(n, dtype=torch.bool)
        inside[max(s, 0):max(e + 1, 0)] = True
        walked = torch.zeros(n, dtype=torch.bool)
        for t in range(len(nchunks)):
            if start[t] <= line < start[t] + 64 * nchunks[t]:
                walked[256 * t:256 * (t + 1)] = True
        inside &= walked
        assert bool(inside.any()) and bool(bad[inside].all())
    assert bool(torch.isnan(want[0][inside]).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_need_window_holds_every_needed_point(seed):
    """pair_item's need window, by brute force over every point of the
    wing window in float32: every point that needs a correction (x^2 <
    k1_limit in class 1, |x| < xlim0 otherwise, y < 70.55) lies in it, and
    it lies in the wing window; far centers, wide and tiny srw, c_frac at
    +/-0.5, the classes' thresholds and y = 0 among the lines."""
    rng = np.random.default_rng(seed)
    m = 3000
    c_int = rng.integers(-2 ** 21, 2 ** 21, m).astype(np.float32)
    c_int[: m // 2] = rng.integers(-50, 5000, m // 2)
    c_frac = rng.uniform(-0.5, 0.5, m).astype(np.float32)
    c_frac[::7] = np.float32(0.5)
    c_frac[1::7] = np.float32(-0.5)
    srw = np.exp(rng.uniform(np.log(0.05), np.log(200.0), m)).astype(
        np.float32)
    y = rng.choice(np.asarray([0.0, 1e-7, 1.0, 2.0, 5.0, 6.8, 7.5, 8.425,
                               30.0, 66.0, 70.5], np.float32), m)
    half = rng.integers(0, 600, m).astype(np.float32)
    t = {k: torch.as_tensor(v) for k, v in dict(
        ws=c_int - half, we=c_int + half, c_int=c_int, c_frac=c_frac,
        srw=srw, y=y, pref=np.ones(m, np.float32)).items()}
    items = cc.pair_items(t["ws"], t["we"], t["c_int"], t["c_frac"],
                          t["srw"], t["y"], t["pref"], cc.item_class(t["y"]))
    offs = torch.arange(-600, 601, dtype=torch.float32)
    p = t["c_int"][:, None] + offs
    label = cc.item_labels(items, p)
    needed = label >= cc.K1
    inside = (p >= items["lo"][:, None]) & (p <= items["hi"][:, None])
    assert int(needed.sum()) > 1000
    assert not bool((needed & ~inside).any())
    live = items["live"]
    assert bool((items["lo"][live] >= items["ws"][live]).all())
    assert bool((items["hi"][live] <= items["we"][live]).all())
    narrowed = live & ((items["hi"] - items["lo"]) < (items["we"]
                                                       - items["ws"]))
    assert int(narrowed.sum()) > m // 4


def test_plain_matches_pallas_on_a_class4_heavy_input():
    """The plain version (unchanged by the redesign) against
    ``_pallas_pass(..., "core")`` in interpret mode, most lines in class
    4 (CPF12 and region 3 among their points) beside the other classes:
    within 1e-6 of the scale, as ``test_tile_pass_matches_pallas[core]``."""
    soa, start, nchunks, n = cc.synthetic_corr(
        5, layers=1, tile=256, num_tiles=3, num_lines=300, chunk=64,
        shares=(0.05, 0.05, 0.05, 0.05, 0.8))
    counts = cc.corr_census(torch.as_tensor(soa), start, nchunks, 256, 64)
    assert counts["items_by_class"]["c4"] > counts["items"] / 2
    assert counts["needed"]["cpf12_i"] and counts["needed"]["r3"]
    got = lc.tile_plain(torch.as_tensor(soa), start, nchunks, n, 256, 64,
                        "core").numpy()
    want = np.asarray(jlp._pallas_pass(jnp.asarray(soa), start, nchunks, n,
                                       256, 64, "core", interpret=True))
    assert got.shape == want.shape == (n,)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


def test_plain_matches_pallas_on_a_nan_y_line():
    """A NaN y with an infinite prefactor (``nonfinite.nan_y_corr``): JAX's
    conds fail every test on the NaN and take the whole correction, which
    is 0 there, so the line's window in tile 1 is NaN at 40 points; the
    plain version has NaN at exactly those points, and the other points
    within 1e-6 of the scale, as ``test_plain_matches_pallas_on_a_class4_
    heavy_input``.  The model takes it bit for bit."""
    case = nf.nan_y_corr()
    i = case.inputs
    got = case.plain().numpy()
    want = np.asarray(jlp._pallas_pass(jnp.asarray(i["soa"]), *i["csr"],
                                       i["n"], 256, 64, "core",
                                       interpret=True))
    assert got.shape == want.shape == (i["n"],)
    assert int(np.isnan(want).sum()) == 40
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want[~np.isnan(want)]).all()
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max()
    assert scale > 0
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=scale * 1e-6)
    model = corr_model(torch.as_tensor(i["soa"])[None], *i["csr"], i["n"],
                       256, 64)
    assert same_bits(model[0], case.plain())
