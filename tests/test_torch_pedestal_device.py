"""The stacked pedestal remover on the field's device (ops/pedestal_cuda.py)
on the CPU: its float64 line physics against the host's ``kernel_inputs``,
the scan kernel's algorithm against the native scan, the bucket-window
field against the host's difference array, and the whole remover against
the host engine (``remove_stacked_pedestal``) and the JAX package's
remover, on a dense cluster and on lines straddling both grid edges."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.models.lines import LinePack
from pylbl_tpu_torch.models.lines.gas import internal_grid
from pylbl_tpu_torch.models.lines.pedestal import (apply_pedestal_batch,
                                                   compute_pedestals_batch)
from pylbl_tpu_torch.models.lines.physics import (kernel_inputs,
                                                  line_profile_params)
from pylbl_tpu_torch.ops import pedestal_cuda as pc
from pylbl_tpu_torch.parallel import lines as tlines
from pylbl_tpu_torch.runtime import native
from pylbl_tpu_torch.utils.observability import metrics

torch.set_num_threads(1)

T = np.asarray([288.99, 227.74, 250.0])
P = np.asarray([98388.0, 1032.0, 50000.0])
CUT_OFF = 25
# Each case: the grid, and per gas (lines, nu range, seed, bands).
CASES = {
    # 2,500 H2O lines within 100 cm-1: many windows overlap every point.
    "dense": (np.arange(400.0, 700.0, 0.1),
              {"H2O": (2500, 450.0, 550.0, 17, (500.0,)),
               "CO2": (400, 450.0, 550.0, 18, (480.0,))}),
    # Lines within the cut-off of both grid edges (inside the window the
    # reference keeps, so that no line breaks the list).
    "edges": (np.arange(50.0, 100.0, 0.2),
              {"H2O": (800, 26.0, 124.0, 19, (40.0, 110.0)),
               "O3": (300, 26.0, 124.0, 20, (52.0, 98.0))}),
}


def case_packs(case):
    """(grid, JAX packs, port packs, vmr [B, G])."""
    grid, gases = CASES[case]
    jp = {name: synthetic_line_pack(name, num_lines=num, nu_min=lo,
                                    nu_max=hi, seed=seed, band_centers=bands)
          for name, (num, lo, hi, seed, bands) in gases.items()}
    tp = {name: LinePack(formula=p.formula,
                         **{f: getattr(p, f) for f in LinePack._ARRAY_FIELDS})
          for name, p in jp.items()}
    vmr = np.stack([np.full(T.size, 6.6e-3), np.linspace(3e-4, 5e-6, T.size)],
                   axis=1)
    return grid, jp, tp, vmr


def rel(got, want, floor):
    den = np.maximum(np.abs(want), floor * np.abs(want).max())
    return float((np.abs(got - want) / den).max())


def gas_inputs(pack, grid, vmr):
    """(GasLines, b0, nb, line_inputs on the CPU, the host's kernel_inputs)
    for one gas over the layers T, P."""
    v0, vn, n_per_v, _ = internal_grid(grid)
    keep = pack.compat_break_filter(v0, vn, CUT_OFF)
    gas = pc.GasLines(pack, keep)
    b0, nb, margin = gas.bucket_range(P)
    ka = pc.line_inputs(gas.on("cpu"), torch.as_tensor(T),
                        torch.as_tensor(P), torch.as_tensor(vmr),
                        torch.as_tensor(gas.q_slots(T)), v0, n_per_v,
                        CUT_OFF, (b0, nb, margin), internal_grid(grid)[3])
    kin = kernel_inputs(line_profile_params(pack, T, P, vmr, keep=keep), v0,
                        n_per_v, CUT_OFF)
    return gas, b0, nb, ka, kin


@pytest.mark.parametrize("case", list(CASES))
def test_line_inputs_equal_kernel_inputs(case):
    """The window's bucket, s_idx, e_idx and the center (mul, add and
    floor) equal the host's bit for bit; the width and strength pass
    through exp, pow and sqrt, within 4e-15 (a few ulp).  Each line lies
    in its bucket's segment, whose endpoints are the line's clamped
    window endpoints."""
    grid, _, packs, vmr = case_packs(case)
    n = internal_grid(grid)[3]
    for g, pack in enumerate(packs.values()):
        _, b0, nb, ka, kin = gas_inputs(pack, grid, vmr[:, g])
        assert np.array_equal(ka["bucket"].numpy() + b0, kin["bucket"])
        assert 0 <= int(ka["bucket"].min()) and int(ka["bucket"].max()) < nb
        for name in ("s_idx", "e_idx", "center"):
            assert np.array_equal(ka[name].numpy(), kin[name]), name
        r = ka["bucket"].long().numpy()
        index = np.arange(r.shape[1])
        assert (ka["seg_lo"].numpy()[r] <= index).all()
        assert (index < ka["seg_hi"].numpy()[r]).all()
        assert np.array_equal(ka["p_s"].numpy()[r],
                              np.clip(kin["s_idx"], 0, n - 1))
        assert np.array_equal(ka["p_e"].numpy()[r],
                              np.clip(kin["e_idx"], 0, n - 1))
        n_per_v = internal_grid(grid)[2]
        for name, want in (("srw", kin["repwid"] / n_per_v), ("y", kin["y"]),
                           ("pref", kin["prefactor"])):
            got = ka[name].numpy()
            assert np.abs(got - want).max() <= 4e-15 * np.abs(want).max(), \
                name


def scan_model(bucket, s, e, ks, pre, c0, cn, n, window, nb):
    """csrc/pedestal.cu pedestal_scan_kernel's loop over one row, in
    Python: the same float64 operations in the same order, with its cached
    left sums, its stop at the highest bucket touched, and its fast lines
    (inside the grid after such a line of the same bucket), whose bucket
    total stays in a register until the next slow line.  Returns (ped,
    the bucket totals)."""
    inside = (s > 0) & (e < n - 1)
    fast = np.zeros(bucket.size, bool)
    fast[1:] = inside[1:] & inside[:-1] & (bucket[1:] == bucket[:-1])
    bkt = np.zeros(nb)
    ped = np.zeros(bucket.size)
    p0r = pnr = cum0 = cumn = c_val = last_val = 0.0
    c_lo, c_b, tmax, last_b, e_top, c_ok = 0, -1, -1, -1, -1, False
    for i in range(bucket.size):
        if fast[i]:
            acc = last_val
            for j in range(last_b + 1, e_top + 1):
                acc += bkt[j]
            k_s = ks[i] - (c_val + last_val)
            k_e = pre[i] - acc
            lt = k_s < k_e
            ped[i] = k_s if lt else k_e
            last_val = last_val + k_s if lt else last_val + k_e
            continue
        if last_b >= 0:
            bkt[last_b] = last_val
        if s[i] >= n or e[i] < 0:
            continue
        b = int(bucket[i])
        cover0 = s[i] <= 0 <= e[i]
        covern = s[i] <= n - 1 <= e[i]
        if cover0:
            cum0 += c0[i]
        if covern:
            cumn += cn[i]
        bb = bkt[b]
        if s[i] < 0:
            k_s = cum0 - p0r
        else:
            wlo = max(b - window, 0)
            if not c_ok or c_lo != wlo or c_b != b:
                acc = 0.0
                for j in range(wlo, b):
                    acc += bkt[j]
                c_val, c_lo, c_b, c_ok = acc, wlo, b, True
            k_s = ks[i] - (c_val + bb)
        if e[i] > n - 1:
            k_e = cumn - pnr
        else:
            acc = bb
            for j in range(b + 1, min(b + window, nb - 1, tmax) + 1):
                acc += bkt[j]
            k_e = pre[i] - acc
        value = k_s if k_s < k_e else k_e
        ped[i] = value
        last_val = bb + value
        bkt[b] = last_val
        last_b, tmax = b, max(tmax, b)
        e_top = min(b + window, nb - 1, tmax)
        if c_lo <= b < c_b:
            c_ok = False
        if cover0:
            p0r += value
        if covern:
            pnr += value
    if last_b >= 0:
        bkt[last_b] = last_val
    return ped, bkt


@pytest.mark.parametrize("seed", range(8))
def test_scan_kernel_algorithm_equals_native(seed):
    """The scan kernel's shortcuts leave the native scan's sums bit for
    bit: lines near bucket edges jump between two buckets (their shifts
    cross the integer), windows reach past both grid edges, and lines miss
    the grid; its plain version is the native scan."""
    rng = np.random.default_rng(seed)
    num, n, n_per_v, cut = 3000, 300, 10, 2
    window = 2 * cut + 1
    base = np.sort(rng.uniform(-4.0, 34.0, num))
    bucket_abs = np.floor(base + rng.choice([-0.6, 0.0, 0.0, 0.6], num))
    s = ((bucket_abs - cut) * n_per_v).astype(np.int64)
    e = ((bucket_abs + cut + 1) * n_per_v).astype(np.int64)
    b0 = int(bucket_abs.min()) - 3
    nb = int(bucket_abs.max()) - b0 + 4
    bucket = (bucket_abs - b0).astype(np.int64)
    ks, pre = rng.normal(1.0, 0.5, num), rng.normal(1.0, 0.5, num)
    c0, cn = rng.uniform(0.0, 0.1, num), rng.uniform(0.0, 0.1, num)
    skip = (s >= n) | (e < 0)
    cover0 = (s <= 0) & (e >= 0) & ~skip
    covern = (s <= n - 1) & (e >= n - 1) & ~skip
    c0, cn = np.where(cover0, c0, 0.0), np.where(covern, cn, 0.0)
    assert cover0.any() and covern.any() and skip.any()
    want = native.pedestal_scan(bucket, skip, s < 0, e > n - 1, cover0,
                                covern, ks, pre, np.cumsum(c0),
                                np.cumsum(cn), window, nb)
    ped, got = scan_model(bucket, s, e, ks, pre, c0, cn, n, window, nb)
    # The native scan's bucket totals: each bucket's pedestals in line
    # order, as np.bincount adds them.
    assert np.array_equal(ped, want)
    assert np.array_equal(got, np.bincount(bucket, weights=want,
                                           minlength=nb))
    rows = [torch.as_tensor(a)[None] for a in (
        bucket.astype(np.int32), s.astype(np.int32), e.astype(np.int32), ks,
        pre, c0, cn)]
    assert np.array_equal(pc.scan(*rows, n, window, nb).numpy()[0], want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bucket_window_field_equals_difference_array(case, dtype):
    """The field as bucket totals summed over each point's window buckets
    equals the host's difference array and cumulative sum, on random
    pedestals of both signs, at the grid's edges too."""
    grid, _, packs, vmr = case_packs(case)
    v0, vn, n_per_v, n = internal_grid(grid)
    blo, bhi = (torch.as_tensor(w) for w in pc.bucket_windows(
        v0, vn, n_per_v, n, CUT_OFF))
    rng = np.random.default_rng(5)
    for g, pack in enumerate(packs.values()):
        _, b0, nb, ka, kin = gas_inputs(pack, grid, vmr[:, g])
        s, e = kin["s_idx"], kin["e_idx"]
        live = (s < n) & (e >= 0)
        if case == "edges":
            assert ((s < 0) & live).any() and ((e > n - 1) & live).any()
        ped = np.where(live, rng.normal(0.0, 1.0, s.shape), 0.0)
        ped = ped.astype(np.float32 if dtype == torch.float32
                         else np.float64).astype(np.float64)
        bucket = ka["bucket"].numpy()
        totals = torch.as_tensor(np.stack([
            np.bincount(bucket[r], weights=ped[r], minlength=nb)
            for r in range(T.size)]))
        out = torch.zeros((T.size, n + 7), dtype=dtype)
        pc.subtract_field(out, 3, n, totals, blo, bhi, b0)
        want = apply_pedestal_batch(np.zeros((T.size, n)), ped, s, e, n)
        got = out.numpy().astype(np.float64)
        assert not got[:, :3].any() and not got[:, 3 + n:].any()
        scale = np.abs(ped).sum(axis=1, keepdims=True)
        # The sums run in another order: 1e-13 of the pedestals' scale; a
        # float32 field rounds once more (2**-24 of its value).
        ulp = 0.0 if dtype == torch.float64 else 2.0 ** -24
        err = np.abs(got[:, 3:3 + n] - want)
        assert (err <= ulp * np.abs(want) + 1e-13 * scale).all()


def host_removal(packs, grid, k32, vmr):
    """The port's former remover from the host's functions: the native
    scan over the float32 field's values, each pedestal rounded to float32,
    a float64 difference array, the field subtracted in float32.  Returns
    (the result, the fields subtracted)."""
    v0, vn, n_per_v, n = internal_grid(grid)
    out = k32.numpy().copy()
    fields = np.zeros(out.shape)
    for g, pack in enumerate(packs.values()):
        keep = pack.compat_break_filter(v0, vn, CUT_OFF)
        params = line_profile_params(pack, T, P, vmr[:, g], keep=keep)
        kin = kernel_inputs(params, v0, n_per_v, CUT_OFF)
        kin.update(nu_raw=pack.nu[:keep], nu_shift=params["nu_shift"])
        ped = compute_pedestals_batch(out[:, g].astype(np.float64), kin, n,
                                      n_per_v, CUT_OFF)
        live = (kin["s_idx"] < n) & (kin["e_idx"] >= 0)
        ped = np.where(live, ped, 0.0).astype(np.float32).astype(np.float64)
        fields[:, g] = -apply_pedestal_batch(np.zeros((T.size, n)), ped,
                                             kin["s_idx"], kin["e_idx"], n)
        out[:, g] = out[:, g] - fields[:, g].astype(np.float32)
    return out, fields


@pytest.mark.parametrize("case", list(CASES))
def test_remover_matches_host_and_jax(case):
    """On a float64 field the remover equals the host engine's float64
    removal within 1e-9 (floor 1e-6: its sums run in another order over
    last-ulp physics).  On a float32 field it equals the port's former
    host remover to a float32 ulp of the field and of the result, and
    1e-13 of the largest field (its float64 sums run in another order:
    the host's running sum leaves round-off where no window reaches), and
    lies no further from the float64 removal than the JAX package's
    float32 remover.  A repeat call gives the same bits; one call counts
    one ``lines.pedestal_device`` in ``lines.pedestal``."""
    grid, jp, tp, vmr = case_packs(case)
    fn = tlines.make_multigas_batched_fn(tp, grid, tile=512, chunk=128,
                                         device="cpu", dtype=torch.float64)
    k64 = fn(T, P, vmr)
    remover = tlines.make_stacked_pedestal_remover(tp, grid)
    metrics.reset()
    got = remover(k64, T, P, vmr)
    snap = metrics.snapshot()
    assert snap["counters"] == {"lines.pedestal_device": 1}
    assert snap["timers"]["lines.pedestal"]["calls"] == 1
    assert got.dtype == torch.float64 and got.shape == k64.shape
    want = tlines.remove_stacked_pedestal(tp, grid, k64, T, P, vmr)
    assert rel(got.numpy(), want, 1e-6) < 1e-9
    k32 = k64.float()
    got32 = remover(k32, T, P, vmr).numpy()
    host32, fields = host_removal(tp, grid, k32, vmr)
    ulp = 2.0 ** -24
    assert (np.abs(got32 - host32) <= ulp * (np.abs(fields) + np.abs(
        host32)) + 1e-13 * np.abs(fields).max()).all()
    jax32 = np.asarray(jlines.make_stacked_pedestal_remover(jp, grid)(
        jnp.asarray(k32.numpy()), T, P, vmr))
    assert rel(got32, want, 1e-6) <= rel(jax32, want, 1e-6)
    assert np.array_equal(remover(k32, T, P, vmr).numpy(), got32)
