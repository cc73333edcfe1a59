"""MT-CKD 3.5 continua, plain NumPy, for the bands that reach 1-7536 cm-1.

The coefficient tables are ``mt_ckd_tables.npz`` beside this file: the
numeric content of the MT-CKD 3.5 netCDF that the reference pyLBL reads
(mt_ckd/utils.py), as the program ships it.  Each band is evaluated on its
native grid for one layer and interpolated linearly onto the user grid
with zero outside it (numpy.interp), in metres (x 100), as the reference
pyLBL's ``BandedContinuum.spectra`` does.  A grid that reaches a band not
written here (ozone's from 8920 cm-1, oxygen's near-infrared from 7536
cm-1 and above) is refused, so the reference never leaves out a band that
the program adds.
"""
from pathlib import Path

import numpy as np

from .constants import C2, LOSCHMIDT, M_TO_CM, P0, PA_TO_MB, T0, T273

TABLES = Path(__file__).resolve().parent / "mt_ckd_tables.npz"
# The lowest native wavenumber of any band this module leaves out.
FIRST_OMITTED = 7536.0


class Tables:
    """The coefficient tables in ``dtype``: ``data(name)`` and
    ``grid(name)``."""

    def __init__(self, dtype=np.float64, path=TABLES):
        self.dtype = dtype
        with np.load(path) as raw:
            self.raw = {k: raw[k] for k in raw.files}

    def data(self, name):
        return self.raw[f"{name}__data"].astype(self.dtype)

    def grid(self, name):
        lo = float(self.raw[f"{name}__lo"])
        res = float(self.raw[f"{name}__res"])
        return (lo + np.arange(self.data(name).size) * res).astype(self.dtype)

    def index(self, outer, inner):
        """(lower, upper) of table ``inner``'s grid inside ``outer``'s."""
        lo = float(self.raw[f"{outer}__lo"])
        res = float(self.raw[f"{outer}__res"])
        return (int((float(self.raw[f"{inner}__lo"]) - lo) / res),
                int((float(self.raw[f"{inner}__hi"]) - lo) / res))


def radiation(nu, t):
    """nu * tanh(nu c2 / 2T) up to x = nu c2 / T = 10, nu beyond."""
    x = nu * C2 / t
    return np.where(x <= 10.0, nu * (1.0 - np.exp(-x)) / (1.0 + np.exp(-x)),
                    nu)


def h2o_foreign_scale(tab):
    """The foreign continuum's Rhu scale on its native grid."""
    grid = tab.grid("bfh2o")
    scale = np.zeros(grid.size)
    lower, upper = tab.index("bfh2o", "xfac_rhu")
    scale[lower + 1:upper + 1] = tab.data("xfac_rhu")[1:]
    scale[lower] = scale[lower + 1]
    w = grid[upper + 1:]
    lobe = 57600.0 / ((w - 255.67) ** 2 + 57600.0 + ((w - 255.67) / 57.83)
                      ** 8) + 57600.0 / ((w + 255.67) ** 2 + 57600.0
                                         + ((w + 255.67) / 57.83) ** 8)
    scale[upper + 1:] = 1.0 + (0.06 - 0.42 * lobe) / (1.0 + 0.3
                                                      * (w / 630.0) ** 8)
    return scale


def band_spectra(tab, t, p_pa, vmr):
    """[(gas, native grid, native extinction [cm-1])] of every band that
    reaches the grid, for one layer: temperature ``t`` [K], pressure
    ``p_pa`` [Pa], ``vmr`` {gas: mole fraction} of every gas of the
    atmosphere."""
    p = p_pa * PA_TO_MB
    h2o, n2, o2 = vmr.get("H2O", 0.0), vmr.get("N2"), vmr.get("O2")
    dry = LOSCHMIDT * (p / P0) * (T273 / t) * (1.0 - h2o)
    air = sum(dry * x for x in vmr.values())
    out = []
    if "H2O" in vmr:
        nh2o = dry * h2o
        g = tab.grid("bs296")
        b296, b260 = tab.data("bs296"), tab.data("bs260")
        out.append(("H2O", g, nh2o * (nh2o / air) * p / P0 * (T0 / t) * 1e-20
                    * radiation(g, t) * b296
                    * (b260 / b296) ** ((t - T0) / (260.0 - T0))))
        g = tab.grid("bfh2o")
        out.append(("H2O", g, (1.0 - nh2o / air) * p / P0 * (T0 / t) * 1e-20
                    * nh2o * radiation(g, t) * h2o_foreign_scale(tab)
                    * tab.data("bfh2o")))
    if "CO2" in vmr:
        g = tab.grid("bfco2")
        tcorr = np.ones(g.size)
        lower, upper = tab.index("bfco2", "tdep_bandhead")
        tcorr[lower:upper + 1] = tab.data("tdep_bandhead")
        xfac = np.ones(g.size)
        lower, upper = tab.index("bfco2", "x_factor_co2")
        xfac[lower:upper + 1] = tab.data("x_factor_co2")
        out.append(("CO2", g, dry * vmr["CO2"] * 1e-20 * p / P0 * (T0 / t)
                    * radiation(g, t) * xfac * (t / 246.0) ** tcorr
                    * tab.data("bfco2")))
    if o2 is not None:
        g = tab.grid("o2_f")
        tau = dry * o2 * 1e-20 * p / P0 * (T273 / t)
        out.append(("O2", g, tau * radiation(g, t) * (1e20 / LOSCHMIDT)
                    * tab.data("o2_f")
                    * np.exp(tab.data("o2_t") * (1.0 / T0 - 1.0 / t)) / g))
    if n2 is not None:
        tau = (dry * n2 / LOSCHMIDT) * (p / P0) * (T273 / t)
        g = tab.grid("ct_296")
        f = (t - T0) / (220.0 - T0)
        ct = tab.data("ct_296") * (tab.data("ct_220")
                                   / tab.data("ct_296")) ** f
        sf = tab.data("sf_296") * (tab.data("sf_220")
                                   / tab.data("sf_296")) ** f
        out.append(("N2", g, tau * radiation(g, t) * ct
                    * (n2 + (sf - 1.0) * (n2 / o2) * o2 + h2o)))
        g = tab.grid("xn2_272")
        x272, x228 = tab.data("xn2_272"), tab.data("xn2_228")
        c0 = np.zeros(g.size)
        c0[1:-1] = x272[1:-1] * (x228[1:-1] / x272[1:-1]) ** (
            (1.0 / t - 1.0 / 272.0) / (1.0 / 228.0 - 1.0 / 272.0))
        c0 = c0 / g
        out.append(("N2", g, tau * radiation(g, t) * (
            c0 * n2 + o2 * (1.294 - 0.4545 * t / T0) * c0
            + h2o * (9.0 / 7.0) * tab.data("a_h2o") * c0)))
        g = tab.grid("xn2")
        out.append(("N2", g, tau * (n2 + o2 + h2o) * radiation(g, t)
                    * tab.data("xn2") / g))
    return out


def continua(tab, points, t, p_pa, vmr):
    """Continuum extinction [m-1] of one layer at the wavenumbers
    ``points`` [cm-1], summed over the gases and bands, each band computed
    in the tables' dtype."""
    dtype = tab.dtype
    if np.max(points) >= FIRST_OMITTED:
        raise ValueError(f"a point at {np.max(points)} cm-1: bands from "
                         f"{FIRST_OMITTED} cm-1 are not in this reference")
    total = np.zeros(points.size, dtype)
    cast = {k: dtype(v) for k, v in vmr.items()}
    for _, native, values in band_spectra(tab, dtype(t), dtype(p_pa), cast):
        values = np.asarray(values, dtype)
        total += np.interp(points, native, values, left=0.0,
                           right=0.0).astype(dtype) * dtype(M_TO_CM)
    return total
