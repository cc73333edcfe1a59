"""MT-CKD 3.5 continuum bands — all 17, vectorized over layers.

A copy of pylbl_tpu/models/mt_ckd/bands.py (the port cannot import the
JAX package).  The formulas are generic over an array namespace ``xp``:
numpy on the host, :class:`~pylbl_tpu_torch.utils.xp.TorchNamespace` on a
device (models/mt_ckd/__init__.py ``device_spectra``).

Each band evaluates its extinction on its native coarse grid (reference
pyLBL/mt_ckd: water_vapor.py, carbon_dioxide.py, ozone.py, oxygen.py,
nitrogen.py); the molecule-level continua interpolate onto the user grid
with precomputed gather weights (ops/interp.py) instead of per-call
``numpy.interp`` (reference utils.py:157-174).

All formulas and constants match the reference bit-for-bit and are verified
against the 17 golden band sums of the reference test-suite
(tests/test_mt_ckd.py here; reference tests/test_mt_ckd.py:16-25).
Temperature/pressure arguments broadcast: scalars give [n_native] spectra,
[B]-shaped layer batches give [B, n_native].
"""
import numpy as np

from .tables import Table, subgrid_bounds
from ...utils.constants import LOSCHMIDT, P0, C2, T0, T273


def _col(value, xp=np):
    """Shapes a scalar or [B] layer quantity for grid broadcasting.

    float64 on the host path; on a device xp without x64 enabled, ask
    for the default float dtype instead of warning-and-truncating."""
    if xp is np:
        return np.asarray(value, dtype=np.float64)[..., None]
    dtype = xp.float64 if xp.asarray(0.0).dtype == xp.float64 \
        else xp.float32
    return xp.asarray(value, dtype=dtype)[..., None]


def dry_air_number_density(pressure, temperature, vmr):
    """[cm-3] (reference mt_ckd/utils.py:31-42); pressure in mb."""
    return LOSCHMIDT * (pressure / P0) * (T273 / temperature) * \
        (1.0 - vmr["H2O"])


def air_number_density(pressure, temperature, vmr):
    """[cm-3] (reference mt_ckd/utils.py:16-28)."""
    return sum(dry_air_number_density(pressure, temperature, vmr) * x
               for x in vmr.values())


def radiation_term(wavenumber, temperature, xp=np):
    """Radiation term [cm-1] (reference mt_ckd/utils.py:45-59).

    Replicates the reference's ``where`` ordering exactly: the x <= 0.01
    half-angle shortcut is assigned first but immediately shadowed by the
    x <= 10 branch (its condition is a superset), so effectively
    r = nu * tanh(x/2) for x <= 10 and r = nu beyond.
    """
    t = temperature / C2
    x = wavenumber / _col(t, xp)
    r = xp.broadcast_to(wavenumber, x.shape)
    r = xp.where(x <= 0.01, 0.5 * x * wavenumber, r)
    return xp.where(x <= 10.0, wavenumber * (1.0 - xp.exp(-x))
                    / (1.0 + xp.exp(-x)), r)


class _Band:
    """Shared native-grid plumbing for continuum bands."""

    def grid(self):
        raise NotImplementedError

    def spectra(self, temperature, pressure, vmr):
        """Extinction on the native grid [cm-1]; pressure in mb."""
        raise NotImplementedError


# ---------------------------- water vapor -------------------------------

class WaterVaporARMSelfContinuum(_Band):
    """H2O self continuum (reference water_vapor.py:12-34)."""

    def __init__(self, path=None):
        self.b296 = Table("bs296", path)
        self.b260 = Table("bs260", path)
        self._grid = self.b296.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        t_factor = _col((xp.asarray(temperature) - T0) / (260.0 - T0), xp)
        nh2o = _col(dry_air_number_density(pressure, temperature, vmr)
                    * vmr["H2O"], xp)
        n = _col(air_number_density(pressure, temperature, vmr), xp)
        rad = radiation_term(self._grid, temperature, xp)
        return (nh2o * (nh2o / n) * _col(pressure, xp) / P0
                * (T0 / _col(temperature, xp)) * 1.0e-20 * rad
                * self.b296.data
                * xp.power(self.b260.data / self.b296.data, t_factor))

    def grid(self):
        return self._grid


class WaterVaporIASIForeignContinuum(_Band):
    """H2O foreign continuum with Rhu correction and analytic chi factor
    (reference water_vapor.py:42-76)."""

    def __init__(self, path=None):
        self.data = Table("bfh2o", path)
        x = Table("xfac_rhu", path)
        self.scale = np.zeros(self.data.data.size)
        lower, upper = subgrid_bounds(self.data.grid, x.grid)
        self.scale[lower + 1:upper + 1] = x.data[1:]
        self.scale[lower] = self.scale[lower + 1]
        u = upper + 1
        w = self.grid()[u:]
        vdelsq1 = (w - 255.67) ** 2
        vf1 = ((w - 255.67) / 57.83) ** 8
        vdelmsq1 = (w + 255.67) ** 2
        vmf1 = ((w + 255.67) / 57.83) ** 8
        vf2 = (w / 630.0) ** 8
        self.scale[u:] = 1.0 + (
            0.06 - 0.42 * ((57600.0 / (vdelsq1 + 57600.0 + vf1))
                           + (57600.0 / (vdelmsq1 + 57600.0 + vmf1)))
        ) / (1.0 + 0.3 * vf2)

    def spectra(self, temperature, pressure, vmr, xp=np):
        nh2o = _col(dry_air_number_density(pressure, temperature, vmr)
                    * vmr["H2O"], xp)
        n = _col(air_number_density(pressure, temperature, vmr), xp)
        rad = radiation_term(self.grid(), temperature, xp)
        return ((1.0 - (nh2o / n)) * _col(pressure, xp) / P0
                * (T0 / _col(temperature, xp)) * 1.0e-20 * nh2o * rad
                * self.scale * self.data.data)

    def grid(self):
        return self.data.wavenumbers()


# --------------------------- carbon dioxide -----------------------------

class CarbonDioxideHartmannContinuum(_Band):
    """CO2 continuum (reference carbon_dioxide.py:12-42)."""

    def __init__(self, path=None):
        self.data = Table("bfco2", path)
        x = Table("tdep_bandhead", path)
        lower, upper = subgrid_bounds(self.data.grid, x.grid)
        self.t_correction = np.ones(self.data.data.size)
        self.t_correction[lower:upper + 1] = x.data
        x = Table("x_factor_co2", path)
        lower, upper = subgrid_bounds(self.data.grid, x.grid)
        self.xfac_co2 = np.ones(self.data.data.size)
        self.xfac_co2[lower:upper + 1] = x.data

    def spectra(self, temperature, pressure, vmr, xp=np):
        nco2 = _col(dry_air_number_density(pressure, temperature, vmr)
                    * vmr["CO2"], xp)
        rad = radiation_term(self.grid(), temperature, xp)
        return (nco2 * 1.0e-20 * _col(pressure, xp) / P0
                * (T0 / _col(temperature, xp)) * rad * self.xfac_co2
                * xp.power(_col(temperature, xp) / 246.0, self.t_correction)
                * self.data.data)

    def grid(self):
        return self.data.wavenumbers()


# ------------------------------- ozone ----------------------------------

class OzoneChappuisWulfContinuum(_Band):
    """O3 Chappuis/Wulf band (reference ozone.py:12-29)."""

    def __init__(self, path=None):
        self.data = [Table("x_o3", path), Table("y_o3", path),
                     Table("z_o3", path)]
        self._grid = self.data[0].wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no3 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O3"], xp)
        dt = _col(xp.asarray(temperature) - T273, xp)
        rad = radiation_term(self._grid, temperature, xp)
        return 1.0e-20 * no3 * rad * (
            self.data[0].data + self.data[1].data * dt
            + self.data[2].data * dt * dt) / self._grid

    def grid(self):
        return self._grid


class OzoneHartleyHugginsContinuum(_Band):
    """O3 Hartley-Huggins band (reference ozone.py:32-51)."""

    def __init__(self, path=None):
        self.data = [Table("o3_hh0", path), Table("o3_hh1", path),
                     Table("o3_hh2", path)]
        self._grid = self.data[0].wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no3 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O3"], xp)
        dt = _col(xp.asarray(temperature) - T273, xp)
        rad = radiation_term(self._grid, temperature, xp)
        return (1.0e-20 * no3 * rad * (self.data[0].data / self._grid)
                * (1.0 + self.data[1].data * dt
                   + self.data[2].data * dt * dt))

    def grid(self):
        return self._grid


class OzoneUVContinuum(_Band):
    """O3 UV continuum (reference ozone.py:54-69)."""

    def __init__(self, path=None):
        self.data = Table("o3_huv", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no3 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O3"], xp)
        rad = radiation_term(self._grid, temperature, xp)
        return no3 * rad * self.data.data / self._grid

    def grid(self):
        return self._grid


# ------------------------------- oxygen ---------------------------------

class OxygenCIAFundamentalContinuum(_Band):
    """O2 CIA fundamental (reference oxygen.py:18-33)."""

    def __init__(self, path=None):
        self.data = [Table("o2_f", path), Table("o2_t", path)]
        self._grid = self.data[0].wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O2"], xp)
        tau_factor = no2 * 1.0e-20 * _col(pressure, xp) / P0 * \
            (T273 / _col(temperature, xp))
        rad = radiation_term(self._grid, temperature, xp)
        xktfac = (1.0 / T0) - (1.0 / _col(temperature, xp))
        factor = 1.0e20 / LOSCHMIDT
        return (tau_factor * rad * factor * self.data[0].data
                * xp.exp(self.data[1].data * xktfac) / self._grid)

    def grid(self):
        return self._grid


class OxygenCIANIRContinuum(_Band):
    """O2 CIA near-infrared band 1 (reference oxygen.py:36-51)."""

    def __init__(self, path=None):
        self.data = Table("o2_inf1", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = dry_air_number_density(pressure, temperature, vmr) * vmr["O2"]
        ao2 = 1.0 / 0.446
        an2 = 0.3 / 0.446
        tau_factor = _col(
            (no2 / LOSCHMIDT) * (pressure / P0) * (T273 / temperature)
            * (ao2 * vmr["O2"] + an2 * vmr["N2"] + vmr["H2O"]), xp)
        rad = radiation_term(self._grid, temperature, xp)
        return tau_factor * rad * self.data.data / self._grid

    def grid(self):
        return self._grid


class OxygenCIANIR2Continuum(_Band):
    """O2 CIA near-infrared band 2 — analytic Lorentzian-bump coefficients
    (reference oxygen.py:54-77)."""

    def __init__(self, path=None):
        self._grid = np.arange(9100.0, 11002.0, 2.0)
        hw1, hw2 = 58.96, 45.04
        dv1 = self._grid - 9375.0
        dv2 = self._grid - 9439.0
        damp1 = np.where(dv1 < 0.0, np.exp(dv1 / 176.1), 1.0)
        damp2 = np.where(dv2 < 0.0, np.exp(dv2 / 176.1), 1.0)
        o2inf = 0.31831 * (
            ((1.166e-04 * damp1 / hw1) / (1.0 + (dv1 / hw1) ** 2))
            + ((3.086e-05 * damp2 / hw2) / (1.0 + (dv2 / hw2) ** 2))) * 1.054
        self.data = o2inf / self._grid

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = dry_air_number_density(pressure, temperature, vmr) * vmr["O2"]
        n = air_number_density(pressure, temperature, vmr)
        adjwo2 = _col((no2 / n) * (1.0 / vmr["O2"]) * no2 * 1.0e-20
                      * (pressure / P0) * (T0 / temperature), xp)
        rad = radiation_term(self._grid, temperature, xp)
        return adjwo2 * rad * self.data

    def grid(self):
        return self._grid


class OxygenCIANIR3Continuum(_Band):
    """O2 CIA near-infrared band 3 (reference oxygen.py:80-91)."""

    def __init__(self, path=None):
        self.data = Table("o2_inf3", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = dry_air_number_density(pressure, temperature, vmr) * vmr["O2"]
        tau_factor = _col((no2 / LOSCHMIDT) * (pressure / P0)
                          * (T273 / temperature), xp)
        rad = radiation_term(self._grid, temperature, xp)
        return tau_factor * rad * self.data.data / self._grid

    def grid(self):
        return self._grid


class OxygenVisibleContinuum(_Band):
    """O2 visible continuum (reference oxygen.py:94-107)."""

    def __init__(self, path=None):
        self.data = Table("o2_invis", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = dry_air_number_density(pressure, temperature, vmr) * vmr["O2"]
        n = air_number_density(pressure, temperature, vmr)
        adjwo2 = _col((no2 / n) * no2 * 1.0e-20 * (pressure / P0)
                      * (T273 / temperature), xp)
        rad = radiation_term(self._grid, temperature, xp)
        factor = 1.0 / (LOSCHMIDT * 1.0e-20 * (55.0 * T273 / T0) ** 2 * 89.5)
        return adjwo2 * rad * factor * self.data.data / self._grid

    def grid(self):
        return self._grid


class OxygenHerzbergContinuum(_Band):
    """O2 Herzberg continuum — analytic coefficients
    (reference oxygen.py:110-130)."""

    def __init__(self, path=None):
        self._grid = np.arange(36000.0, 100010.0, 10.0)
        yratio = self._grid / 48811.0
        corr = np.where(self._grid <= 40000.0,
                        ((40000.0 - self._grid) / 4000.0) * 7.917e-7, 0.0)
        data = 6.884e-4 * yratio * np.exp(
            -69.738 * np.power(np.log(yratio), 2)) - corr
        self.data = np.where(self._grid <= 36000.0, 0.0, data)

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O2"], xp)
        rad = radiation_term(self._grid, temperature, xp)
        factor = _col(1.0 + 0.83 * (pressure / P0)
                      * (T273 / xp.asarray(temperature, dtype=xp.float64)), xp)
        return 1.0e-20 * no2 * rad * factor * self.data / self._grid

    def grid(self):
        return self._grid


class OxygenUVContinuum(_Band):
    """O2 UV continuum (reference oxygen.py:133-143)."""

    def __init__(self, path=None):
        self.data = Table("o2_infuv", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        no2 = _col(dry_air_number_density(pressure, temperature, vmr)
                   * vmr["O2"], xp)
        rad = radiation_term(self._grid, temperature, xp)
        return 1.0e-20 * no2 * rad * self.data.data / self._grid

    def grid(self):
        return self._grid


# ------------------------------ nitrogen --------------------------------

class NitrogenCIAPureRotationContinuum(_Band):
    """N2 CIA pure rotation band (reference nitrogen.py:14-32)."""

    def __init__(self, path=None):
        self.data = {296: [Table("ct_296", path), Table("sf_296", path)],
                     220: [Table("ct_220", path), Table("sf_220", path)]}
        self._grid = self.data[296][0].wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        nn2 = dry_air_number_density(pressure, temperature, vmr) * vmr["N2"]
        tau_factor = _col((nn2 / LOSCHMIDT) * (pressure / P0)
                          * (T273 / temperature), xp)
        rad = radiation_term(self._grid, temperature, xp)
        factor = _col((xp.asarray(temperature, dtype=xp.float64) - T0)
                      / (220.0 - T0), xp)
        c = self.data[296][0].data * xp.power(
            self.data[220][0].data / self.data[296][0].data, factor)
        s = self.data[296][1].data * xp.power(
            self.data[220][1].data / self.data[296][1].data, factor)
        fo2 = (s - 1.0) * _col(vmr["N2"] / vmr["O2"], xp)
        return tau_factor * rad * c * (_col(vmr["N2"], xp)
                                       + fo2 * _col(vmr["O2"], xp)
                                       + _col(vmr["H2O"], xp))

    def grid(self):
        return self._grid


class NitrogenCIAFundamentalContinuum(_Band):
    """N2 CIA fundamental band (reference nitrogen.py:35-56)."""

    def __init__(self, path=None):
        self.data = [Table("xn2_272", path), Table("xn2_228", path),
                     Table("a_h2o", path)]
        self._grid = self.data[0].wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        nn2 = dry_air_number_density(pressure, temperature, vmr) * vmr["N2"]
        tau_factor = _col((nn2 / LOSCHMIDT) * (pressure / P0)
                          * (T273 / temperature), xp)
        rad = radiation_term(self._grid, temperature, xp)
        t = xp.asarray(temperature, dtype=xp.float64)
        xtfac = _col((1.0 / t - 1.0 / 272.0) / (1.0 / 228.0 - 1.0 / 272.0), xp)
        ao2 = _col(1.294 - 0.4545 * t / T0, xp)
        inner = self.data[0].data[1:-1] * xp.power(
            self.data[1].data[1:-1] / self.data[0].data[1:-1], xtfac)
        # The reference zeroes the first/last native points
        # (nitrogen.py:49-53); pad instead of in-place assignment so the
        # formula also runs on torch tensors.
        width = [(0, 0)] * (inner.ndim - 1) + [(1, 1)]
        c0 = xp.pad(inner, width) / self._grid
        c1 = ao2 * c0
        c2 = (9.0 / 7.0) * self.data[2].data * c0
        return tau_factor * rad * (c0 * _col(vmr["N2"], xp)
                                   + _col(vmr["O2"], xp) * c1
                                   + _col(vmr["H2O"], xp) * c2)

    def grid(self):
        return self._grid


class NitrogenCIAFirstOvertoneContinuum(_Band):
    """N2 CIA first overtone band (reference nitrogen.py:59-71)."""

    def __init__(self, path=None):
        self.data = Table("xn2", path)
        self._grid = self.data.wavenumbers()

    def spectra(self, temperature, pressure, vmr, xp=np):
        nn2 = dry_air_number_density(pressure, temperature, vmr) * vmr["N2"]
        tau_factor = _col((nn2 / LOSCHMIDT) * (pressure / P0)
                          * (T273 / temperature)
                          * (vmr["N2"] + vmr["O2"] + vmr["H2O"]), xp)
        rad = radiation_term(self._grid, temperature, xp)
        return tau_factor * rad * self.data.data / self._grid

    def grid(self):
        return self._grid
