"""arts-crossfit absorption cross sections.

Counterpart of pylbl_tpu/models/arts_crossfit/cross_section.py.
Re-implements the reference backend (reference
pyLBL/arts_crossfit/cross_section.py:8-48 and
xsec_aux_functions.py:14-121): per-band 2-D quadratic fits in (T, P)
evaluated on the band's stored frequency grid, clipped at zero with an
integral-conserving rescale, then linearly interpolated onto the user grid
(converted to Hz) with zero fill, summed over bands.

Differences from the reference are structural, not numeric: band data is
read once at construction (the reference re-opens the netCDF on every call,
reference cross_section.py:30) and interpolation uses precomputed gather
weights (ops/interp.py) so repeated layer evaluations are two gathers and
a multiply-add, on the host or (``device_absorption_fn``) on a device.
"""
import numpy as np
import torch

from ...ops.interp import NonuniformGridInterp
from ...utils.xp import TorchNamespace
from ...utils.xrlite import open_dataset

SPEED_OF_LIGHT = 299792458.0  # [m s-1] (reference cross_section.py:32).


def calculate_xsec(temperature, pressure, coeffs):
    """2-D quadratic fit: xsec = p00 + p10*T + p01*P + p20*T^2
    (reference xsec_aux_functions.py:14-70).

    Args:
        temperature: scalar temperature [K].
        pressure: scalar pressure [Pa].
        coeffs: [4, nfreq] fit coefficients.

    Returns:
        [nfreq] cross sections [m2].
    """
    return (coeffs[0] + coeffs[1] * temperature + coeffs[2] * pressure
            + coeffs[3] * temperature * temperature)


def calculate_xsec_fullmodel(temperature, pressure, coeffs):
    """One layer's fit with the negative clip that conserves the spectral
    integral (reference xsec_aux_functions.py:73-121): where the fit goes
    negative it is set to zero and, if the pre-clip total is non-negative
    and the clipped sum nonzero, rescaled by total / clipped."""
    xsec = calculate_xsec(temperature, pressure, coeffs)
    negative = xsec < 0
    if not negative.any():
        return xsec
    total = np.sum(xsec)
    xsec = np.where(negative, 0.0, xsec)
    clipped = np.sum(xsec)
    if total >= 0 and clipped != 0:
        xsec = xsec * (total / clipped)
    return xsec


def calculate_xsec_fullmodel_batch(temperature, pressure, coeffs, xp=np):
    """Layer-batched 2-D quadratic fit xsec = p00 + p10*T + p01*P + p20*T^2
    (reference xsec_aux_functions.py:14-70) with the integral-conserving
    negative clip (:73-121), as ``where`` selects per layer: rescale by
    total/clipped only when negatives exist AND the pre-clip total is
    non-negative AND the clipped sum is nonzero.

    Args:
        temperature / pressure: [B] arrays.
        coeffs: [4, nfreq].
        xp: numpy or a TorchNamespace.

    Returns:
        [B, nfreq] cross sections [m2].
    """
    t = xp.asarray(temperature)[:, None]
    p = xp.asarray(pressure)[:, None]
    xsec = (coeffs[0] + coeffs[1] * t + coeffs[2] * p
            + coeffs[3] * t * t)
    negative = xsec < 0
    any_neg = xp.any(negative, axis=-1, keepdims=True)
    total = xp.sum(xsec, axis=-1, keepdims=True)
    clipped_xsec = xp.where(negative, 0.0, xsec)
    clipped = xp.sum(clipped_xsec, axis=-1, keepdims=True)
    rescale = any_neg & (total >= 0) & (clipped != 0)
    safe = xp.where(clipped == 0, 1.0, clipped)
    scale = xp.where(rescale, total / safe, 1.0)
    return xp.where(any_neg, clipped_xsec * scale, xsec)


class CrossSection:
    """Cross sections for one molecule (API-compatible with the reference
    ``pyLBL.arts_crossfit.CrossSection``)."""

    def __init__(self, formula, path):
        """Reads all band fits from the coefficient netCDF.

        Args:
            formula: string chemical formula.
            path: path to the per-molecule coefficient file.
        """
        self.formula = formula
        self.path = path
        self.bands = []
        dataset = open_dataset(path)
        band_ids = np.atleast_1d(np.asarray(dataset["bands"].data))
        for m in band_ids:
            fgrid = np.asarray(dataset[f"band{m}_fgrid"].data,
                               dtype=np.float64).reshape(-1)
            coeffs = np.asarray(dataset[f"band{m}_coeffs"].data,
                                dtype=np.float64)
            if coeffs.ndim != 2:
                raise ValueError(f"band{m}_coeffs must be 2-D")
            if coeffs.shape[0] != 4:
                coeffs = coeffs.T  # stored [nfreq, 4]; fits want [4, nfreq].
            self.bands.append((fgrid, coeffs))
        self._interp_cache = {}

    def _interps(self, grid):
        """Per-band gather weights onto the user grid [cm-1], converted to
        Hz (reference cross_section.py:32-33), cached per grid."""
        key = (float(grid[0]), float(grid[-1]), grid.size)
        interps = self._interp_cache.get(key)
        if interps is None:
            freq_user = grid * SPEED_OF_LIGHT * 100.0
            interps = [NonuniformGridInterp(fgrid, freq_user)
                       for fgrid, _ in self.bands]
            self._interp_cache[key] = interps
        return interps

    def absorption_coefficient(self, grid, temperature, pressure):
        """Absorption cross sections [m2] of one layer on the user grid
        (host numpy, float64).

        Args:
            grid: wavenumber grid [cm-1].
            temperature: temperature [K].
            pressure: pressure [Pa].
        """
        grid = np.asarray(grid, dtype=np.float64)
        total = np.zeros(grid.size)
        for (_, coeffs), interp in zip(self.bands, self._interps(grid)):
            total += interp(calculate_xsec_fullmodel(temperature, pressure,
                                                     coeffs))
        return total

    def absorption_coefficient_batch(self, grid, temperature, pressure):
        """Layer-batched absorption cross sections [B, grid.size] [m2]
        (host numpy, float64)."""
        grid = np.asarray(grid, dtype=np.float64)
        interps = self._interps(grid)
        temperature = np.atleast_1d(np.asarray(temperature, np.float64))
        pressure = np.atleast_1d(np.asarray(pressure, np.float64))
        total = np.zeros((temperature.size, grid.size))
        for (fgrid, coeffs), interp in zip(self.bands, interps):
            total += interp(calculate_xsec_fullmodel_batch(
                temperature, pressure, coeffs))
        return total

    def device_absorption_fn(self, grid, device="cuda"):
        """Builds a float64 evaluator for this molecule on ``device`` (the
        card by default).

        Returns:
            fn(temperature[B], pressure[B]) -> [B, grid.size] float64
            tensor of cross sections [m2] (fit, clip-rescale and gather
            interpolation all on the device).
        """
        xp = TorchNamespace(device, torch.float64)
        grid = np.asarray(grid, dtype=np.float64)
        interps = [interp.to(xp.device) for interp in self._interps(grid)]
        coeff_list = [xp.asarray(coeffs) for _, coeffs in self.bands]

        def fn(temperature, pressure):
            temperature = xp.asarray(temperature, dtype=torch.float64)
            pressure = xp.asarray(pressure, dtype=torch.float64)
            total = torch.zeros(temperature.shape + (grid.size,),
                                dtype=torch.float64, device=xp.device)
            for coeffs, interp in zip(coeff_list, interps):
                total = total + interp(calculate_xsec_fullmodel_batch(
                    temperature, pressure, coeffs, xp=xp))
            return total

        return fn
