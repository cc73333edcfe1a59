"""The rows core's unit walk (csrc/lineshape.cu ``rows_kernel``) on the CPU.

The kernel cannot run here, so its arithmetic is held through the model of
tests/test_torch_corr_walk.py, phase by phase, per piece of 32 groups:
thread (r, g) makes instance r of group g an item (the class from the
group's min y, row 56 or the separate [B, 1, G] block:
``core_census.pair_items``); the units (an instance with each point group
of its row its need window meets) are classified, their pairs listed by
Humlicek region (K1, region 1, 2, 3, CPF12, or every in-window point of a
non-finite prefactor) and evaluated through the plain correction
functions; warp r adds row r's units in group order into one running sum
per point and piece from +0.0; the pieces of 32 groups fold in piece
order.

The model equals ``rows_tiles_plain`` (``rows_plain``) bit for bit at tiles
256, 512 and 1024, one layer and two, with the class from row 56 and from
a separate min-y block that differs from it, on inputs made from a numpy
seed with every class and region, dead slots, a tiny y, instances at y >=
70.55 in walked groups, need windows across point groups and non-finite
prefactors (the plain version's NaN at each in-window point of a walked
group, also where the instance's own y is >= 70.55) and a NaN min y (class
4, the whole correction, as the JAX conds take it).  The plain version
still matches the JAX ``_pallas_rows_pass`` in interpret mode on a
class-4-heavy input at the tolerance of tests/test_torch_lineshape.py
``test_rows_pass_matches_pallas``.  The kernel itself is held to the
plain version bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.ops import lineshape_pallas as jlp

from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.tools import core_census as cc
from pylbl_tpu_torch.tools import nonfinite as nf
from test_torch_core_walk import K1, R1
from test_torch_corr_walk import fold, same_bits, walk_sums

torch.set_num_threads(1)


def row_items(groups, b, r, cols, ym):
    """The items of instance r of groups ``cols`` of layer b, the class
    from the groups' min y ``ym``."""
    c_int, c_frac, srw, y, pref, s, e = groups[b, r::8][:lc.N_FIELDS][
        :, cols]
    return cc.pair_items(s, e, c_int, c_frac, srw, y, pref,
                         cc.item_class(ym[cols]))


def rows_model(groups, g_start, g_n, n, tile, ymin=None, seen=None):
    """[B, n]: per (layer, tile, piece of 32 groups) each row's running sum
    from the walk, the pieces folded in piece order."""
    row_w = tile // 8
    piece = lc.ROWS_PIECE_GROUPS
    out = groups.new_zeros((groups.shape[0], len(g_n), tile))
    offs = torch.arange(row_w)
    for b in range(groups.shape[0]):
        ym = groups[b, lc.YMIN_ROW] if ymin is None else ymin[b, 0]
        for t in range(len(g_n)):
            count = int(g_n[t]) * lc.ROWS_CHUNK
            pieces = []
            for q0 in range(0, max(count, 1), piece):
                acc = groups.new_zeros((8, row_w))
                cols = torch.arange(int(g_start[t]) + q0,
                                    int(g_start[t]) + min(q0 + piece, count))
                for r in range(8):
                    if cols.numel():
                        p = (t * tile + r * row_w + offs).to(groups.dtype)
                        acc[r] = walk_sums(row_items(groups, b, r, cols, ym),
                                           p, seen)
                pieces.append(acc.reshape(-1))
            out[b, t] = fold(pieces)
    return out.reshape(groups.shape[0], -1)[:, :n]


def rows_input(seed, tile, layers, **kwargs):
    groups, plan, n = cc.synthetic_rows(seed, layers=layers, tile=tile,
                                        **kwargs)
    groups = torch.as_tensor(groups)
    return (groups if layers > 1 else groups[None]), plan, n


@pytest.mark.parametrize("tile,layers,vmem", [
    (256, 2, False), (256, 1, True), (512, 2, True), (1024, 1, False),
    (1024, 2, True)])
def test_model_equals_plain_on_every_class_and_region(tile, layers, vmem):
    """Every class by the group's min y (skipped, K1, 2, 3, 4), every list,
    dead slots, instances at y >= 70.55 in walked groups: the model equals
    the plain version bit for bit, never -0.0.  With ``vmem`` the class
    comes from a separate min-y block that moves some groups to another
    class (K1 on instances of y < 8.425 among them)."""
    groups, plan, n = rows_input(tile // 128, tile, layers,
                                 num_tiles=max(2, 1024 // tile))
    ymin = None
    if vmem:
        ymin = lc.group_min_y(groups).clone()
        ymin[..., 1::5] = torch.where(ymin[..., 1::5] < 70.55, 9.0,
                                      ymin[..., 1::5])
        ymin[..., 3::7] = 1.5
    seen = []
    got = rows_model(groups, plan.g_start, plan.g_n, n, tile, ymin, seen)
    want = lc.rows_plain(groups, plan.g_start, plan.g_n, n, tile,
                         ymin=ymin)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())
    classes = torch.cat([it["cls"] for it, _ in seen])
    assert set(classes.unique().tolist()) == {0, 1, 2, 3, 4}
    lists = torch.cat([ls.reshape(-1) for _, ls in seen])
    assert set(lists.unique().tolist()) == {-1, K1, R1, R1 + 1, R1 + 2,
                                            R1 + 3}
    assert int(plan.walk.pieces.per_tile.max()) > 1     # a tile of pieces
    y = torch.cat([it["y"][it["cls"] > 0] for it, _ in seen])
    assert bool((y >= 70.55).any()) and bool((y == 100.0).any())
    if vmem:
        k1_small = torch.cat([it["y"][(it["cls"] == 1) & it["live"]]
                              for it, _ in seen])
        assert bool((k1_small < 8.425).any())


def test_model_keeps_non_finite_prefactors():
    """An instance of infinite prefactor in a walked group: every point of
    its row in its window is not finite (pref times the class
    correction), also where its own y is >= 70.55 (pref * 0.0); a NaN
    prefactor the same; a NaN group min y takes class 4, the whole
    correction, as JAX's conds, each instance its own from its y, as the
    group's true min y (below 2) takes it: the model equals the plain
    version bit for bit, NaN for NaN."""
    groups, plan, n = rows_input(9, 256, 1)
    ym = groups[0, lc.YMIN_ROW]
    col = int(torch.nonzero((ym < 8.0) & (ym > 0.5)).flatten()[0])
    far = int(torch.nonzero((ym < 70.55)).flatten()[-1])
    live = [r for r in range(8) if groups[0, 5 * 8 + r, col]
            <= groups[0, 6 * 8 + r, col]]
    assert len(live) >= 2
    groups[0, 4 * 8 + live[0], col] = float("inf")
    groups[0, 4 * 8 + live[1], col] = float("nan")
    groups[0, 4 * 8 + 0, far] = float("inf")
    groups[0, 3 * 8 + 0, far] = 80.0
    groups[0, 5 * 8 + 0, far] = 0.0
    groups[0, 6 * 8 + 0, far] = float(n)
    nan_group = int(torch.nonzero(ym < 2.0).flatten()[1])
    true_min = groups.clone()
    groups[0, lc.YMIN_ROW, nan_group] = float("nan")
    got = rows_model(groups, plan.g_start, plan.g_n, n, 256)
    want = lc.rows_plain(groups, plan.g_start, plan.g_n, n, 256)
    assert same_bits(got, want)
    assert int((~torch.isfinite(want)).sum()) > 32
    assert same_bits(want, lc.rows_plain(true_min, plan.g_start, plan.g_n,
                                         n, 256))
    skipped = groups.clone()
    skipped[0, lc.YMIN_ROW, nan_group] = 80.0
    assert not same_bits(want, lc.rows_plain(skipped, plan.g_start,
                                             plan.g_n, n, 256))


def test_plain_matches_pallas_on_a_class4_heavy_input():
    """The plain version (unchanged by the redesign, its pieces PR 5's
    recorded deviation) against ``_pallas_rows_pass`` in interpret mode,
    most groups in class 4 (CPF12 and region 3 among their points): within
    1e-6 of the scale, as ``test_rows_pass_matches_pallas``."""
    groups, plan, n = cc.synthetic_rows(
        6, layers=1, tile=256, num_tiles=3, num_lines=250,
        shares=(0.05, 0.05, 0.05, 0.05, 0.8))
    counts = cc.rows_census(torch.as_tensor(groups), plan.g_start,
                            plan.g_n, 256)
    walked = counts["items"] - counts["items_by_class"]["skip"]
    assert counts["items_by_class"]["c4"] > walked / 2
    assert counts["needed"]["cpf12_i"] and counts["needed"]["r3"]
    got = lc.rows_plain(torch.as_tensor(groups), plan.g_start, plan.g_n, n,
                        256).numpy()
    want = np.asarray(jlp._pallas_rows_pass(
        jnp.asarray(groups), plan.g_start, plan.g_n, n, 256, plan.chunk,
        interpret=True))
    assert got.shape == want.shape == (n,)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)


@pytest.mark.parametrize("layers,vmem", [(1, False), (2, False),
                                         (1, True)])
def test_plain_matches_pallas_on_a_nan_min_y_group(layers, vmem):
    """A group whose slot 0 has a NaN y, and so a NaN min y
    (``nonfinite.nan_y_rows``): JAX's conds take the whole correction for
    the group, each other instance its own from its y; the plain version
    against ``_pallas_rows_pass`` (one layer, a two-layer batch) and
    ``_pallas_rows_pass_vmem`` (the separate min-y block): within 1e-6 of
    the scale at every point, the same points finite; the model takes it
    bit for bit."""
    case = nf.nan_y_rows(layers, vmem=vmem)
    i = case.inputs
    got = case.plain().numpy()
    if vmem:
        want = jlp._pallas_rows_pass_vmem(
            jnp.asarray(i["groups"]), jnp.asarray(i["ymin"]), *i["csr"],
            i["n"], 256, interpret=True)
    else:
        want = jlp._pallas_rows_pass(jnp.asarray(i["groups"]), *i["csr"],
                                     i["n"], 256, i["chunk"],
                                     interpret=True)
    want = np.asarray(want)
    assert got.shape == want.shape == ((layers, i["n"]) if layers > 1
                                       else (i["n"],))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    scale = np.abs(want).max()
    assert np.isfinite(scale) and scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 1e-6)
    groups = torch.as_tensor(i["groups"]).reshape(layers, 64, -1)
    ymin = None if i["ymin"] is None else torch.as_tensor(
        i["ymin"]).reshape(layers, 1, -1)
    model = rows_model(groups, *i["csr"], i["n"], 256, ymin)
    assert torch.equal(model, case.plain().reshape(layers, -1))
