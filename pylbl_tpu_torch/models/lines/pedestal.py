"""Pedestal removal with reference-exact sequential semantics.

The reference subtracts, per line and *in processing order*, the minimum of
the accumulated spectrum at the line's two window endpoints from the whole
window (reference pyLBL/c_lib/spectra.c:66-78).  Because the accumulator is
shared, the subtracted "pedestal" of line i includes the wings of every
earlier line j < i — and the pedestals those lines already subtracted.  The
result is genuinely order-dependent, and near grid edges the coupling is
O(1) (each clamped window repeatedly re-zeroes the edge point), so no
perturbative/iterative scheme converges.

The decomposition (the algorithm of pylbl_tpu/models/lines/pedestal.py)
keeps ALL the expensive work (Voigt evaluations, windowed field
accumulation, prefix contribution sums) fully data-parallel — vectorized
over lines AND over a leading layer-batch axis, in float64 torch on the
field's device — and reduces the inherently-sequential remainder to a
per-layer scalar scan with O(window) state, run natively on the host
(runtime/native.py):

For line i with endpoints p_s/p_e (integer-wavenumber grid points, clamped
like spectra.c:49-62), the accumulated value decomposes as

    k_acc_i(p)  =  [prefix contribution sum at p]  -  [prefix pedestal sum at p]

* The prefix contribution sums are order-independent per-point sums that are
  evaluated vectorized up front:
   - interior left endpoint: K(p_s) - suffix_contrib(i), where K is the full
     pedestal-free field (already computed by the main kernels) and the
     suffix collects the few later lines whose windows reach p_s (all within
     ~1 wavenumber of line i — a short local segment);
   - interior right endpoint: a short local *prefix* segment (windows of
     later buckets cannot reach it) plus the line's own contribution;
   - clamped endpoints (grid edges): cumulative sums over the edge blocks.
* The prefix pedestal sums are windowed sums over integer buckets: a window
  anchored at bucket b covers p_s(b_i) iff b in [b_i - (2*cutoff+1), b_i]
  and covers p_e(b_i) iff b in [b_i, b_i + 2*cutoff+1].  The scan maintains
  per-bucket pedestal totals plus two edge accumulators and answers each
  query with an O(window) slice sum — ~50 flops per line, no Voigt math.

The scan reproduces the reference's sequential result to float64 round-off;
verified against a compiled oracle of the unmodified reference C code in
tests/test_lines_parity.py, including dense-cluster and grid-edge cases.
"""
import numpy as np
import torch

from ...ops.voigt import region_limits, voigt_full, voigt_lorentz
from ...runtime import native


def _gather(a, jmat):
    """Per-layer gather: a [B, N], jmat [B, R, M] -> [B, R, M]."""
    b, r, m = jmat.shape
    return torch.take_along_dim(a, jmat.reshape(b, r * m), dim=1) \
        .reshape(b, r, m)


def _sequential_scan(bi_rel, skip, left_clamp, right_clamp, cover0, coverN,
                     k_s_contrib, pre_contrib_e, cum0_incl, cumN_incl,
                     window, n_buckets):
    """The plain version of the native pedestal scan
    (csrc/pylbl_native.cpp), the same algorithm in Python: the tests hold
    the native scan against it.  The port never falls back to it (~1000x
    slower on large lists)."""
    num = bi_rel.size
    bucket_ped = np.zeros(n_buckets)
    ped = np.zeros(num)
    p0_running = 0.0   # pedestals of processed lines covering point 0.
    pn_running = 0.0   # pedestals of processed lines covering point n-1.

    lo_s = np.maximum(bi_rel - window, 0)
    hi_e = np.minimum(bi_rel + window + 1, n_buckets)

    for i in range(num):
        if skip[i]:
            continue
        if left_clamp[i]:
            k_s = cum0_incl[i] - p0_running
        else:
            k_s = k_s_contrib[i] - float(
                bucket_ped[lo_s[i]:bi_rel[i] + 1].sum())
        if right_clamp[i]:
            k_e = cumN_incl[i] - pn_running
        else:
            k_e = pre_contrib_e[i] - float(
                bucket_ped[bi_rel[i]:hi_e[i]].sum())
        value = k_s if k_s < k_e else k_e
        ped[i] = value
        bucket_ped[bi_rel[i]] += value
        if cover0[i]:
            p0_running += value
        if coverN[i]:
            pn_running += value
    return ped


def compute_pedestals_batch(k_nosub, kin, num_points, n_per_v, cut_off,
                            chunk=None, k_at_ps=None, device="cpu"):
    """Computes per-line pedestal values for a batch of layers.

    All contribution sums (the expensive Voigt work) are vectorized over
    [layers, lines] in float64 on ``device``; only the cheap O(N) bucket
    scan runs per layer on the host.

    Args:
        k_nosub: [B, num_points] pedestal-free fields (float64 numpy), or
            None when ``k_at_ps`` is given (the field enters only through
            its values at each line's clamped left window endpoint).
        kin: dict with float64 numpy arrays in nu-sorted processing order:
            nu_raw [N] (shared across layers), and [B, N] arrays nu_shift,
            center, repwid, y, prefactor, s_idx, e_idx, bucket.
        num_points: internal grid size.
        n_per_v: points per wavenumber.
        cut_off: wing cut-off [cm-1].
        chunk: line-rows per vectorized block (scaled down by batch size to
            bound the [B, rows, segment] working set); default 8192 on the
            CPU, 65536 on a card.
        k_at_ps: optional [B, N] field values at each line's clamped left
            window endpoint.
        device: torch device of the contribution sums.

    Returns:
        ped: [B, N] float64 numpy pedestal value per line (0 for lines that
        contribute nothing, i.e. s >= n or e < 0, reference spectra.c:49-53).
    """
    device = torch.device(device)
    if chunk is None:
        chunk = 65536 if device.type == "cuda" else 8192
    n = int(num_points)
    nu_raw = np.asarray(kin["nu_raw"], np.float64)
    center = np.atleast_2d(kin["center"])
    srw = np.atleast_2d(kin["repwid"]) / n_per_v
    y = np.atleast_2d(kin["y"])
    pref = np.atleast_2d(kin["prefactor"])
    s_idx = np.atleast_2d(kin["s_idx"]).astype(np.int64)
    e_idx = np.atleast_2d(kin["e_idx"]).astype(np.int64)
    b = np.atleast_2d(kin["bucket"]).astype(np.int64)
    nu_shift = np.atleast_2d(kin["nu_shift"])
    batch, num = center.shape
    if num == 0:
        return np.zeros((batch, 0))

    skip = (s_idx >= n) | (e_idx < 0)
    live = ~skip
    p_s = np.clip(s_idx, 0, n - 1)
    p_e = np.clip(e_idx, 0, n - 1)
    left_clamp = s_idx < 0
    right_clamp = e_idx > n - 1

    margin = float(np.max(np.abs(nu_shift - nu_raw[None, :]))) + 1e-9

    # ---- local segments (lines within ~1 wavenumber, in sorted order) ----
    seg_start = np.searchsorted(nu_raw, (b - margin).ravel(),
                                side="left").reshape(batch, num)
    seg_end = np.searchsorted(nu_raw, (b + 1 + margin).ravel(),
                              side="right").reshape(batch, num)
    idx_all = np.arange(num)
    m_pre = int(np.max(idx_all[None, :] - seg_start + 1))
    m_suf = max(int(np.max(seg_end - idx_all[None, :] - 1)) if num > 1
                else 0, 1)

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    center_d, srw_d, pref_d, y_d = dev(center), dev(srw), dev(pref), dev(y)
    s_d, e_d, live_d = dev(s_idx), dev(e_idx), dev(live)
    ps_d, pe_d = dev(p_s), dev(p_e)
    seg_start_d, seg_end_d = dev(seg_start), dev(seg_end)
    # voigt_full leaves the Lorentzian only where |x| < xlim0 and y < 70.55;
    # -1 marks lines that never leave it.
    xlim_d = torch.where(y_d < 70.55, region_limits(y_d)[0],
                         torch.full_like(y_d, -1.0))

    def contrib_at(points, jm, valid):
        """Masked contributions pref_j * K_full(x_j(p), y_j) at [B, R]
        grid points for [B, R, M] gathered line indices.

        Equal to voigt_full bit for bit, but the Humlicek regions are
        evaluated only at the points where voigt_full selects them: the
        scan's points lie at window ends, ~cut_off wavenumbers (thousands
        of Doppler widths) from most lines, where K is the Lorentzian."""
        x = (points[..., None] - _gather(center_d, jm)) * _gather(srw_d, jm)
        yj = _gather(y_d, jm)
        k = voigt_lorentz(x, yj)
        core = (x.abs() < _gather(xlim_d, jm)).nonzero(as_tuple=True)
        k[core] = voigt_full(x[core], yj[core])
        vals = _gather(pref_d, jm) * k
        return torch.where(valid, vals, torch.zeros_like(vals))

    def coverage(jm, p):
        return (_gather(s_d, jm) <= p[..., None]) & \
            (_gather(e_d, jm) >= p[..., None]) & _gather(live_d, jm)

    # Vectorized prefix contribution terms (order-independent, parallel).
    suf_contrib_s = torch.zeros((batch, num), dtype=torch.float64,
                                device=device)
    pre_contrib_e = torch.zeros_like(suf_contrib_s)
    rows_per = int(np.clip(
        chunk * 256 // max(batch * max(m_pre, m_suf), 1), 16, chunk))
    rows_all = torch.arange(num, device=device)
    suf_off = torch.arange(m_suf, device=device)
    pre_off = torch.arange(m_pre, device=device)
    for lo in range(0, num, rows_per):
        hi = min(lo + rows_per, num)
        rows = rows_all[lo:hi]
        # Suffix segment (i, seg_end): lines processed after i covering p_s.
        raw = (rows[None, :, None] + 1 + suf_off[None, None, :]).expand(
            batch, hi - lo, m_suf)
        jm = torch.clamp(raw, max=num - 1)
        mask = (raw < seg_end_d[:, lo:hi, None]) & \
            coverage(jm, ps_d[:, lo:hi])
        suf_contrib_s[:, lo:hi] = contrib_at(
            ps_d[:, lo:hi].double(), jm, mask).sum(dim=-1)
        # Prefix segment [seg_start, i]: own and earlier lines covering p_e.
        raw = seg_start_d[:, lo:hi, None] + pre_off[None, None, :]
        jm = torch.clamp(raw, max=num - 1)
        mask = (raw <= rows[None, :, None]) & coverage(jm, pe_d[:, lo:hi])
        pre_contrib_e[:, lo:hi] = contrib_at(
            pe_d[:, lo:hi].double(), jm, mask).sum(dim=-1)

    # Grid-edge blocks: exact inclusive-prefix contribution sums at the two
    # boundary points (every covering line, cumulative in processing order),
    # over the union of covering lines across layers, masked per layer.
    cover0 = (s_idx <= 0) & (e_idx >= 0) & live
    coverN = (s_idx <= n - 1) & (e_idx >= n - 1) & live
    contrib0 = np.zeros((batch, num))
    contribN = np.zeros((batch, num))
    for cover, contrib, point in ((cover0, contrib0, 0.0),
                                  (coverN, contribN, float(n - 1))):
        union = np.where(cover.any(axis=0))[0]
        if union.size:
            jm = dev(np.broadcast_to(union[None, None, :],
                                     (batch, 1, union.size)))
            vals = contrib_at(torch.full((batch, 1), point,
                                         dtype=torch.float64,
                                         device=device), jm,
                              dev(cover[:, union][:, None, :]))
            contrib[:, union] = vals[:, 0, :].cpu().numpy()
    cum0_incl = np.cumsum(contrib0, axis=1)
    cumN_incl = np.cumsum(contribN, axis=1)

    # Interior prefix contributions at p_s: full field minus later windows.
    if k_at_ps is None:
        k_at_ps = np.take_along_axis(np.atleast_2d(k_nosub), p_s, axis=1)
    k_s_contrib = np.asarray(k_at_ps, np.float64) \
        - suf_contrib_s.cpu().numpy()
    pre_contrib_e = pre_contrib_e.cpu().numpy()

    # ---- the sequential remainder: windowed pedestal bucket-sum scan ----
    window = 2 * cut_off + 1
    ped = np.zeros((batch, num))
    for i in range(batch):
        b_min = int(b[i].min())
        n_buckets = int(b[i].max()) - b_min + 1
        bi_rel = (b[i] - b_min).astype(np.int64)
        ped[i] = native.pedestal_scan(
            bi_rel, skip[i], left_clamp[i], right_clamp[i], cover0[i],
            coverN[i], k_s_contrib[i], pre_contrib_e[i], cum0_incl[i],
            cumN_incl[i], window, n_buckets)
    return ped


def compute_pedestals(k_nosub, kin, num_points, n_per_v, cut_off,
                      chunk=None, device="cpu"):
    """Single-layer pedestal values (see :func:`compute_pedestals_batch`).

    Args:
        k_nosub: [num_points] pedestal-free field (float64 numpy).
        kin: dict with float64 per-line [N] arrays in nu-sorted processing
            order: nu_raw, nu_shift, center, repwid, y, prefactor, s_idx,
            e_idx, bucket.
        device: torch device of the contribution sums.

    Returns:
        ped: [N] pedestal value per line.
    """
    kin_b = {"nu_raw": kin["nu_raw"]}
    for name in ("nu_shift", "center", "repwid", "y", "prefactor",
                 "s_idx", "e_idx", "bucket"):
        kin_b[name] = np.asarray(kin[name])[None, :]
    return compute_pedestals_batch(np.asarray(k_nosub)[None, :], kin_b,
                                   num_points, n_per_v, cut_off,
                                   chunk=chunk, device=device)[0]


def apply_pedestal(k_nosub, ped, s_idx, e_idx, num_points):
    """Subtracts each line's pedestal over its clamped window (float64 on
    the host).

    Box subtraction via a difference array (O(num_points + N)), matching the
    reference's per-window loop (spectra.c:73-77) summed over all lines.
    """
    n = int(num_points)
    live = (s_idx < n) & (e_idx >= 0) & (ped != 0.0)
    s = np.clip(s_idx[live], 0, n - 1)
    e = np.clip(e_idx[live], 0, n - 1)
    diff = np.zeros(n + 1)
    np.add.at(diff, s, ped[live])
    np.add.at(diff, e + 1, -ped[live])
    return k_nosub - np.cumsum(diff[:n])


def apply_pedestal_batch(k_nosub, ped, s_idx, e_idx, num_points):
    """Layer-batched :func:`apply_pedestal` ([B, n] / [B, N] arrays)."""
    return np.stack([
        apply_pedestal(k_nosub[i], ped[i], s_idx[i], e_idx[i], num_points)
        for i in range(k_nosub.shape[0])])
