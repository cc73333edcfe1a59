"""Branchless Humlicek Voigt function, numpy or torch.

Counterpart of pylbl_tpu/ops/voigt.py with the same formulas in the same
operation order.  The reference evaluates the Voigt function K(x, y) with a
scalar, per-point branchy decomposition (Humlicek W4 regions 0-3 + CPF12,
reference pyLBL/c_lib/voigt.c:4-191).  This module evaluates the same
numerics as fully vectorized, *branchless* array code: every region formula
is computed on the full (lines, points) block and the per-point region
choice is made with ``where`` selects.  The core-correction CUDA kernel
(ops/lineshape_cuda.py, csrc/lineshape.cu) transcribes the class functions
below as ``__device__`` code in the same order.

Key structural insight used by the fast path: the expensive regions (W4
rationals + CPF12) are only ever selected for |x| < xlim0 <= ~123.3, i.e.
within ~123 Doppler widths of the line center — a band of well under a
wavenumber for atmospheric lines — while the 25 cm-1 wing window is ~96%
region 0 (a 4-flop Lorentzian).  The lines engine therefore splits the sum
into a cheap Lorentzian pass over the full window plus a narrow "core
correction" pass of (K_full - K_lorentz), each an order-independent sum; see
:func:`voigt_correction`.  The combined result is bit-for-tolerance identical
to the reference's per-point region selection.

All functions work with numpy arrays or torch tensors (float32/float64)
and broadcast ``y`` (per line) against ``x`` (per line x point).
"""
import numpy as np

from ..utils.constants import RSQRPI
from ..utils.xp import namespace_of

# CPF12 coefficient tables (reference voigt.c:55-60).
_CPF12_C = (1.0117281, -0.75197147, 0.012557727,
            0.010022008, -0.00024206814, 0.00000050084806)
_CPF12_S = (1.393237, 0.23115241, -0.15535147,
            0.0062183662, 0.000091908299, -0.00000062752596)
_CPF12_T = (0.31424038, 0.94778839, 1.5976826,
            2.2795071, 3.0206370, 3.8897249)

_Y0 = 1.5  # CPF12 offset (reference voigt.c:9).

# Upper bound of xlim0 = sqrt(15100 + y*(40 - 3.6*y)) over y >= 0, attained
# at y = 40/7.2; used by the engine to size the core-correction window.
XLIM0_MAX = float(np.sqrt(15100.0 + (40.0 / 7.2) * (40.0 - 3.6 * (40.0 / 7.2))))


_xp = namespace_of


def _safe_div(num, den, xp):
    """Division that avoids NaN/Inf from branches that will not be selected."""
    return num / xp.where(den == 0, 1.0, den)


def region_limits(y, xp=None):
    """Per-line region boundaries (reference voigt.c:34-53)."""
    xp = xp or _xp(y)
    yq = y * y
    # Clamp: the polynomial goes negative for y > ~66, where the y >= 70.55
    # outer branch usually applies anyway; clamping keeps the unselected
    # branch NaN-free for branchless evaluation.
    xlim0 = xp.sqrt(xp.maximum(15100.0 + y * (40.0 - y * 3.6), 0.0))
    xlim1 = xp.where(y >= 8.425, 0.0,
                     xp.sqrt(xp.maximum(164.0 - y * (4.3 + y * 1.8), 0.0)))
    xlim2 = 6.8 - y
    xlim3 = 2.4 * y
    xlim4 = 18.1 * y + 1.65
    # For y <= 1e-6, skip the W4 rationals entirely (reference voigt.c:48-53).
    tiny = y <= 1.0e-6
    xlim1 = xp.where(tiny, xlim0, xlim1)
    xlim2 = xp.where(tiny, xlim0, xlim2)
    return xlim0, xlim1, xlim2, xlim3, xlim4, yq


def voigt_lorentz(x, y):
    """Region-0 Lorentzian: K = (y/sqrt(pi)) / (x^2 + y^2).

    This is both the far-wing formula (reference voigt.c:79-83) and the
    y >= 70.55 formula (reference voigt.c:17-27; the C writes it as
    y/(pi*(x^2+y^2)) against a sw*repwid prefactor, which equals
    rsqrpi * this value against the common sw*rsqrpi*repwid prefactor).
    """
    xp = _xp(x, y)
    return (y * RSQRPI) / (x * x + y * y)


def _w4_region1(xq, y, yq, xp):
    """Humlicek W4 region 1 (reference voigt.c:86-97)."""
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    den = d0 + xq * (d2 + xq)
    return _safe_div(RSQRPI * y * (a0 + xq), den, xp)


def _w4_region2(xq, y, yq, xp):
    """Humlicek W4 region 2 (reference voigt.c:100-115)."""
    h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)))
    h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0))
    h4 = 10.5 - yq * (6.0 - yq * 6.0)
    h6 = -6.0 + yq * 4.0
    e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq))
    e2 = 5.25 + yq * (1.0 + yq * 3.0)
    e4 = 0.75 * h6
    den = h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq)))
    return _safe_div(y * (e0 + xq * (e2 + xq * (e4 + xq))) * RSQRPI, den, xp)


def _w4_region3(xq, y, xp):
    """Humlicek W4 region 3, 10th-order rational (reference voigt.c:118-146)."""
    z0 = 272.1014 + y * (1280.829 + y * (2802.870 + y * (3764.966
         + y * (3447.629 + y * (2256.981 + y * (1074.409 + y * (369.1989
         + y * (88.26741 + y * (13.39880 + y)))))))))
    z2 = 211.678 + y * (902.3066 + y * (1758.336 + y * (2037.310
         + y * (1549.675 + y * (793.4273 + y * (266.2987
         + y * (53.59518 + y * 5.0)))))))
    z4 = 78.86585 + y * (308.1852 + y * (497.3014 + y * (479.2576
         + y * (269.2916 + y * (80.39278 + y * 10.0)))))
    z6 = 22.03523 + y * (55.02933 + y * (92.75679 + y * (53.59518
         + y * 10.0)))
    z8 = 1.496460 + y * (13.39880 + y * 5.0)
    p0 = 153.5168 + y * (549.3954 + y * (919.4955 + y * (946.8970
         + y * (662.8097 + y * (328.2151 + y * (115.3772 + y * (27.93941
         + y * (4.264678 + y * 0.3183291))))))))
    p2 = -34.16955 + y * (-1.322256 + y * (124.5975 + y * (189.7730
         + y * (139.4665 + y * (56.81652 + y * (12.79458
         + y * 1.2733163))))))
    p4 = 2.584042 + y * (10.46332 + y * (24.01655 + y * (29.81482
         + y * (12.79568 + y * 1.9099744))))
    p6 = -0.07272979 + y * (0.9377051 + y * (4.266322 + y * 1.273316))
    p8 = 0.0005480304 + y * 0.3183291
    den = z0 + xq * (z2 + xq * (z4 + xq * (z6 + xq * (z8 + xq))))
    num = p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8)))
    return _safe_div(1.7724538 * num, den, xp)


def _cpf12(x, xq, abx, y, xlim4, xp):
    """Humlicek CPF12 algorithm, regions I and II (reference voigt.c:150-186)."""
    ypy0 = y + _Y0
    ypy0q = ypy0 * ypy0
    y0q = _Y0 * _Y0
    yf = y + 2.0 * _Y0
    buf1 = xp.zeros_like(x)
    buf2 = xp.zeros_like(x)
    for c_j, s_j, t_j in zip(_CPF12_C, _CPF12_S, _CPF12_T):
        dm = x - t_j
        mq = dm * dm
        mf = 1.0 / (mq + ypy0q)
        xm = mf * dm
        ym = mf * ypy0
        dp = x + t_j
        pq = dp * dp
        pf = 1.0 / (pq + ypy0q)
        xpl = pf * dp
        yp = pf * ypy0
        # Region I accumulation (reference voigt.c:171-174).
        buf1 = buf1 + (c_j * (ym + yp) - s_j * (xm - xpl))
        # Region II accumulation (reference voigt.c:180-184).
        buf2 = buf2 + ((c_j * (mq * mf - _Y0 * ym) + s_j * yf * xm) / (mq + y0q)
                       + (c_j * (pq * pf - _Y0 * yp) - s_j * yf * xpl) / (pq + y0q))
    region2 = y * buf2 + xp.exp(-xq)
    return xp.where(abx <= xlim4, buf1, region2)


def voigt_full(x, y):
    """Full branchless K(x, y), identical in value to the reference's
    per-point region-selected evaluation (reference voigt.c:74-187).

    Args:
        x: (…,) distance from line center in Doppler units,
            ``x = (v - nu) * sqrt(ln2)/alpha``.
        y: per-line damping parameter ``y = gamma * sqrt(ln2)/alpha``,
            broadcastable against x.

    Returns:
        K(x, y) such that the absorption contribution is
        ``sw * rsqrpi * repwid * K``.
    """
    xp = _xp(x, y)
    xlim0, xlim1, xlim2, xlim3, xlim4, yq = region_limits(y, xp)
    abx = xp.abs(x)
    xq = abx * abx

    k0 = voigt_lorentz(x, y)
    k1 = _w4_region1(xq, y, yq, xp)
    k2 = _w4_region2(xq, y, yq, xp)
    k3 = _w4_region3(xq, y, xp)
    k4 = _cpf12(x, xq, abx, y, xlim4, xp)

    # Nested selection in reference order (voigt.c:79-186), with the
    # y >= 70.55 outer branch (voigt.c:17-27) forcing region 0.
    inner = xp.where(abx >= xlim1, k1,
                     xp.where(abx >= xlim2, k2,
                              xp.where(abx < xlim3, k3, k4)))
    out = xp.where(abx >= xlim0, k0, inner)
    return xp.where(y >= 70.55, k0, out)


def voigt_correction_k1(x, y):
    """voigt_correction specialized to y >= 8.425.

    There xlim1 = 0 (region_limits' y >= 8.425 branch, voigt.c:38-40), so
    |x| >= xlim1 always holds and the nested selection collapses to
    region 1.  Identical in value to :func:`voigt_correction` on its
    domain (up to f32 rearrangement rounding).

    Evaluated in combined form with a single division and no sqrt:
    with a0 = y^2+0.5, d0 = a0^2, d2 = 2y^2-1,

        K1 - K0 = (y/sqrt(pi)) * (1.5 x^2 - 0.5 y^2 - 0.25)
                  / ((d0 + x^2 (d2 + x^2)) * (x^2 + y^2))

    (the region-1 and Lorentzian rationals share the numerator identity
    (a0+xq)(xq+yq) - (d0 + xq(d2+xq)) = 1.5 xq - 0.5 yq - 0.25), and the
    |x| < xlim0 test is done on squares.  The denominator is strictly
    positive (d0 >= 0.25), so no safe-division select is needed.
    """
    xp = _xp(x, y)
    xq = x * x
    yq = y * y
    xlim0q = xp.maximum(15100.0 + y * (40.0 - y * 3.6), 0.0)
    a0 = yq + 0.5
    d0 = a0 * a0
    d2 = yq + yq - 1.0
    num = (y * RSQRPI) * (1.5 * xq - (0.5 * yq + 0.25))
    den = (d0 + xq * (d2 + xq)) * (xq + yq)
    needs_corr = (xq < xlim0q) & (y < 70.55)
    return xp.where(needs_corr, num / den, xp.zeros_like(x))


def voigt_correction_k12(x, y):
    """voigt_correction specialized to y >= 6.8.

    There xlim2 = 6.8 - y <= 0 <= |x| and xlim3 >= 16.3 > xlim0 is
    impossible inside the core, so the reference's nested selection
    (voigt.c:79-115) can only ever reach regions 1 and 2; regions 3 and
    CPF12 are dead code for such lines.  Identical in value to
    :func:`voigt_correction` on its domain.
    """
    xp = _xp(x, y)
    xlim0, xlim1, _, _, _, yq = region_limits(y, xp)
    abx = xp.abs(x)
    xq = abx * abx
    k0 = voigt_lorentz(x, y)
    k1 = _w4_region1(xq, y, yq, xp)
    k2 = _w4_region2(xq, y, yq, xp)
    inner = xp.where(abx >= xlim1, k1, k2)
    needs_corr = (abx < xlim0) & (y < 70.55)
    return xp.where(needs_corr, inner - k0, xp.zeros_like(x))


def voigt_correction_k123(x, y):
    """voigt_correction specialized to 2.0 <= y < 6.8.

    There xlim3 = 2.4*y >= 4.8 >= 6.8 - y = xlim2, so every |x| < xlim2
    point satisfies |x| < xlim3 and the CPF12 branch (voigt.c:150-186)
    is unreachable.  Identical in value to :func:`voigt_correction` on
    its domain.
    """
    xp = _xp(x, y)
    xlim0, xlim1, xlim2, _, _, yq = region_limits(y, xp)
    abx = xp.abs(x)
    xq = abx * abx
    k0 = voigt_lorentz(x, y)
    k1 = _w4_region1(xq, y, yq, xp)
    k2 = _w4_region2(xq, y, yq, xp)
    k3 = _w4_region3(xq, y, xp)
    inner = xp.where(abx >= xlim1, k1, xp.where(abx >= xlim2, k2, k3))
    needs_corr = (abx < xlim0) & (y < 70.55)
    return xp.where(needs_corr, inner - k0, xp.zeros_like(x))


def voigt_correction(x, y):
    """K_full(x,y) - K_lorentz(x,y), nonzero only where |x| < xlim0 & y < 70.55.

    The lines engine adds ``voigt_lorentz`` over the whole wing window and
    this correction over a narrow core window; their sum equals
    :func:`voigt_full` exactly.  Outside |x| < xlim0 the correction is
    identically zero, so the core window only needs to cover
    |x| < XLIM0_MAX, i.e. ~123.3 Doppler half-widths.
    """
    xp = _xp(x, y)
    xlim0, xlim1, xlim2, xlim3, xlim4, yq = region_limits(y, xp)
    abx = xp.abs(x)
    xq = abx * abx

    k0 = voigt_lorentz(x, y)
    k1 = _w4_region1(xq, y, yq, xp)
    k2 = _w4_region2(xq, y, yq, xp)
    k3 = _w4_region3(xq, y, xp)
    k4 = _cpf12(x, xq, abx, y, xlim4, xp)

    inner = xp.where(abx >= xlim1, k1,
                     xp.where(abx >= xlim2, k2,
                              xp.where(abx < xlim3, k3, k4)))
    needs_corr = (abx < xlim0) & (y < 70.55)
    return xp.where(needs_corr, inner - k0, xp.zeros_like(x))
