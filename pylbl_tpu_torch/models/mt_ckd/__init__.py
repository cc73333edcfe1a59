"""MT-CKD 3.5 molecular continua.

Counterpart of pylbl_tpu/models/mt_ckd/__init__.py.  Molecule-level
continuum classes expose the reference backend's duck-typed interface
(reference mt_ckd/utils.py:145-174): ``spectra(T, p_Pa, vmr, grid) -> m-1``
summed over the molecule's bands, each band evaluated on its native grid
and linearly interpolated with zero fill (host numpy, float64).
:meth:`BandedContinuum.device_spectra` runs the same band formulas
(bands.py, generic over ``xp``) on torch tensors of a device.
"""
import copy

import numpy as np
import torch

from .bands import (  # noqa: F401
    CarbonDioxideHartmannContinuum,
    NitrogenCIAFirstOvertoneContinuum,
    NitrogenCIAFundamentalContinuum,
    NitrogenCIAPureRotationContinuum,
    OxygenCIAFundamentalContinuum,
    OxygenCIANIR2Continuum,
    OxygenCIANIR3Continuum,
    OxygenCIANIRContinuum,
    OxygenHerzbergContinuum,
    OxygenUVContinuum,
    OxygenVisibleContinuum,
    OzoneChappuisWulfContinuum,
    OzoneHartleyHugginsContinuum,
    OzoneUVContinuum,
    WaterVaporARMSelfContinuum,
    WaterVaporIASIForeignContinuum,
    radiation_term,
)
from .tables import Table, subgrid_bounds  # noqa: F401
from ...ops.interp import UniformGridInterp
from ...utils.constants import M_TO_CM, PA_TO_MB
from ...utils.xp import TorchNamespace


def _on_device(value, xp):
    """``value`` with every numpy array (also inside Tables, lists and
    dicts) replaced by a tensor from ``xp``."""
    if isinstance(value, np.ndarray):
        return xp.asarray(value)
    if isinstance(value, Table):
        table = copy.copy(value)
        table.data = xp.asarray(value.data)
        return table
    if isinstance(value, list):
        return [_on_device(v, xp) for v in value]
    if isinstance(value, dict):
        return {k: _on_device(v, xp) for k, v in value.items()}
    return value


def band_on_device(band, xp):
    """A copy of a band whose coefficient arrays and native grid are
    tensors of ``xp``'s device, so ``band.spectra(..., xp=xp)`` runs
    there."""
    dev = copy.copy(band)
    for name, value in vars(band).items():
        setattr(dev, name, _on_device(value, xp))
    grid = xp.asarray(band.grid())
    dev.grid = lambda: grid
    return dev


class BandedContinuum:
    """All bands of one molecule's continuum (reference utils.py:145-174)."""

    band_classes = ()

    def __init__(self):
        self.bands = [cls() for cls in self.band_classes]
        self._interp_cache = {}

    def _interp(self, band_index, grid):
        key = (band_index, grid[0], grid[-1] if len(grid) else 0.0,
               len(grid))
        interp = self._interp_cache.get(key)
        if interp is None:
            band = self.bands[band_index]
            native = band.grid()
            res = native[1] - native[0]
            interp = UniformGridInterp(native[0], res, native.size, grid)
            self._interp_cache[key] = interp
        return interp

    def spectra(self, temperature, pressure, vmr, grid):
        """Continuum extinction [m-1] on the user grid [cm-1].

        Args:
            temperature: temperature [K], scalar or [B] layer batch.
            pressure: pressure [Pa] (converted to mb internally, reference
                utils.py:172), scalar or [B].
            vmr: dict of mole fractions (must include every gas the bands
                reference, e.g. "H2O" for the dry-air density); values
                scalar or [B].
            grid: user wavenumber grid [cm-1].

        Returns:
            [grid.size] (scalar inputs) or [B, grid.size] extinction.
        """
        grid = np.asarray(grid, dtype=np.float64)
        shape = np.shape(temperature) + (grid.size,)
        total = np.zeros(shape)
        for i, band in enumerate(self.bands):
            native = band.spectra(temperature, pressure * PA_TO_MB, vmr)
            total += self._interp(i, grid)(native) * M_TO_CM
        return total

    def device_spectra(self, grid, device):
        """Builds a float64 evaluator for this continuum on ``device``.

        Returns:
            fn(temperature[B], pressure_Pa[B], vmr dict of [B])
            -> [B, grid.size] float64 tensor of extinction [m-1].
        """
        grid = np.asarray(grid, dtype=np.float64)
        xp = TorchNamespace(device, torch.float64)
        bands = [band_on_device(band, xp) for band in self.bands]
        interps = [self._interp(i, grid).to(xp.device)
                   for i in range(len(self.bands))]

        def fn(temperature, pressure, vmr):
            temperature = xp.asarray(temperature, dtype=torch.float64)
            pressure = xp.asarray(pressure, dtype=torch.float64)
            vmr = {k: xp.asarray(v, dtype=torch.float64)
                   for k, v in vmr.items()}
            total = torch.zeros(temperature.shape + (grid.size,),
                                dtype=torch.float64, device=xp.device)
            for band, interp in zip(bands, interps):
                native = band.spectra(temperature, pressure * PA_TO_MB,
                                      vmr, xp=xp)
                total = total + interp(native) * M_TO_CM
            return total

        return fn


class WaterVaporSelfContinuum(BandedContinuum):
    band_classes = (WaterVaporARMSelfContinuum,)


class WaterVaporForeignContinuum(BandedContinuum):
    band_classes = (WaterVaporIASIForeignContinuum,)


class CarbonDioxideContinuum(BandedContinuum):
    band_classes = (CarbonDioxideHartmannContinuum,)


class OzoneContinuum(BandedContinuum):
    band_classes = (OzoneChappuisWulfContinuum,
                    OzoneHartleyHugginsContinuum,
                    OzoneUVContinuum)


class OxygenContinuum(BandedContinuum):
    band_classes = (OxygenCIAFundamentalContinuum,
                    OxygenCIANIRContinuum,
                    OxygenCIANIR2Continuum,
                    OxygenCIANIR3Continuum,
                    OxygenVisibleContinuum,
                    OxygenHerzbergContinuum,
                    OxygenUVContinuum)


class NitrogenContinuum(BandedContinuum):
    band_classes = (NitrogenCIAPureRotationContinuum,
                    NitrogenCIAFundamentalContinuum,
                    NitrogenCIAFirstOvertoneContinuum)
