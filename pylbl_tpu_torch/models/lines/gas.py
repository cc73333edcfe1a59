"""Molecular-lines gas optics engine (the "pyLBL" lines backend).

Counterpart of pylbl_tpu/models/lines/gas.py.  The line list is packed
once (:class:`~pylbl_tpu_torch.models.lines.physics.LinePack`); a spectrum
is a one-gas call of the stacked device pipeline
(parallel/lines.py ``make_multigas_batched_fn``, a single layer as a batch
of one) plus the reference-exact pedestal remover.
"""
import numpy as np
import torch

from .physics import LinePack
from ...utils.constants import DEFAULT_CUT_OFF


def internal_grid(grid):
    """Derives the reference's internal-grid convention from a user grid.

    v0 = round(grid[0]), vn = round(grid[-1]) + 1,
    n_per_v = round(1/resolution); the internal grid is
    v[i] = v0 + i / n_per_v with (vn - v0) * n_per_v points and the caller
    truncates to grid.size (reference gas_optics.py:61-65,
    absorption.c:32-41, spectroscopy.py:191).
    """
    grid = np.asarray(grid)
    v0 = int(round(float(grid[0])))
    vn = int(round(float(grid[-1])) + 1)
    n_per_v = int(round(1.0 / (float(grid[1]) - float(grid[0]))))
    num_points = (vn - v0) * n_per_v
    return v0, vn, n_per_v, num_points


class Gas:
    """Gas optics calculation for one molecule.

    Attributes:
        pack: LinePack with the molecule's line list.
        formula: string chemical formula.
    """

    def __init__(self, lines_database, formula, device="cpu",
                 dtype=torch.float32, backend="kernel"):
        """Initializes the engine.

        Args:
            lines_database: a Database-like object exposing
                ``line_pack(formula) -> LinePack``, or a LinePack directly.
            formula: string chemical formula.
            device: torch device of the pipeline.
            dtype: pipeline float dtype (the CUDA kernels take float32).
            backend: "kernel" or "plain" (parallel/lines.py).
        """
        if isinstance(lines_database, LinePack):
            self.pack = lines_database
        else:
            self.pack = lines_database.line_pack(formula)
        self.formula = formula
        self.database = getattr(lines_database, "path", None)
        self.device = device
        self.dtype = dtype
        self.backend = backend
        self._fns = {}

    def _pipeline(self, grid, cut_off, envelope, device, dtype, backend):
        from ...parallel.lines import (make_multigas_batched_fn,
                                       make_stacked_pedestal_remover)
        key = (float(grid[0]), float(grid[-1]), len(grid), cut_off,
               envelope, str(device), dtype, backend)
        cached = self._fns.get(key)
        if cached is None:
            packs = {self.formula: self.pack}
            cached = (make_multigas_batched_fn(
                          packs, grid, cut_off=cut_off, t_max=envelope[0],
                          p_max_atm=envelope[1], backend=backend,
                          device=device, dtype=dtype),
                      make_stacked_pedestal_remover(packs, grid, cut_off))
            self._fns[key] = cached
        return cached

    def absorption_coefficient(self, temperature, pressure,
                               volume_mixing_ratio, grid,
                               remove_pedestal=False,
                               cut_off=DEFAULT_CUT_OFF):
        """Absorption cross sections [m2] for one layer.

        Returns:
            numpy float64 array on the *internal* grid of size
            (vn - v0) * n_per_v; callers truncate to ``grid.size``
            (reference gas_optics.py:61-92).
        """
        return self.absorption_coefficient_batch(
            [temperature], [pressure], [volume_mixing_ratio], grid,
            remove_pedestal=remove_pedestal, cut_off=cut_off)[0]

    def absorption_coefficient_batch(self, temperature, pressure,
                                     volume_mixing_ratio, grid,
                                     remove_pedestal=False,
                                     cut_off=DEFAULT_CUT_OFF,
                                     envelope=None, device=None, dtype=None,
                                     backend=None):
        """Layer-batched absorption cross sections, one pipeline call.

        Args:
            temperature / pressure / volume_mixing_ratio: [B] arrays.
            envelope: optional (t_max [K], p_max_atm [atm]) kernel
                envelope; default: derived from these layers.
            device / dtype / backend: override the engine's settings.

        Returns:
            numpy float64 [B, (vn - v0) * n_per_v].
        """
        from ...parallel.lines import derive_envelope
        temperature = np.atleast_1d(np.asarray(temperature, np.float64))
        pressure = np.atleast_1d(np.asarray(pressure, np.float64))
        vmr = np.atleast_1d(np.asarray(volume_mixing_ratio, np.float64))
        envelope = envelope or derive_envelope(temperature, pressure)
        fn, remover = self._pipeline(grid, cut_off, envelope,
                                     device or self.device,
                                     dtype or self.dtype,
                                     backend or self.backend)
        k = fn(temperature, pressure, vmr[:, None])
        if remove_pedestal:
            k = remover(k, temperature, pressure, vmr[:, None])
        return k[:, 0].cpu().numpy().astype(np.float64)
