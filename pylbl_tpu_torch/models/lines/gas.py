"""Molecular-lines gas optics engine (the "pyLBL" lines backend).

Counterpart of pylbl_tpu/models/lines/gas.py, with its two engines:

- a single layer (:meth:`Gas.absorption_coefficient`) runs the float64
  host physics, then the single-layer device plan with exact per-layer
  windows (ops/lineshape_cuda.py ``accumulate_device``), then the
  reference-exact pedestal (``compute_pedestals`` + ``apply_pedestal``);
- a layer batch (:meth:`Gas.absorption_coefficient_batch`) runs the cached
  single-gas batched pipeline (parallel/lines.py ``make_batched_fn``, wide
  default envelope) and ``compute_pedestals_batch`` +
  ``apply_pedestal_batch``.
"""
import numpy as np
import torch

from .pedestal import (apply_pedestal, apply_pedestal_batch,
                       compute_pedestals, compute_pedestals_batch)
from .physics import LinePack, kernel_inputs, line_profile_params
from ...ops.lineshape import prepare_kernel_arrays
from ...ops.lineshape_cuda import accumulate_device
from ...runtime.device import resolve_device
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

    def __init__(self, lines_database, formula, device="cuda",
                 dtype=torch.float32, backend="kernel"):
        """Initializes the engine.

        Args:
            lines_database: a Database-like object exposing
                ``line_pack(formula) -> LinePack``, or a LinePack directly.
            formula: string chemical formula.
            device: torch device of the kernels and their inputs: the
                card by default (a call without one raises); "cpu" runs
                the plain versions on the host.
            dtype: kernel float dtype (the CUDA kernels take float32).
            backend: "kernel" (the wrappers: CUDA kernels for CUDA tensors,
                plain versions for CPU tensors) or "plain" (plain versions
                on any device).
        """
        if isinstance(lines_database, LinePack):
            self.pack = lines_database
        else:
            self.pack = lines_database.line_pack(formula)
        if backend not in ("kernel", "plain"):
            raise ValueError(f"unknown backend {backend!r}")
        self.formula = formula
        self.database = getattr(lines_database, "path", None)
        self.device = device
        self.dtype = dtype
        self.backend = backend
        self._batched_fns = {}

    def absorption_coefficient(self, temperature, pressure,
                               volume_mixing_ratio, grid,
                               remove_pedestal=False,
                               cut_off=DEFAULT_CUT_OFF):
        """Absorption cross sections [m2] for one layer.

        Args:
            temperature: temperature [K].
            pressure: pressure [Pa].
            volume_mixing_ratio: mole fraction [mol mol-1].
            grid: spectral grid [cm-1] (must start near an integer
                wavenumber with 1/integer resolution, like the reference).
            remove_pedestal: subtract the per-line pedestal with the
                reference's sequential-accumulator semantics
                (reference spectra.c:66-78).
            cut_off: wing cut-off from line center [cm-1].

        Returns:
            numpy float64 array on the *internal* grid of size
            (vn - v0) * n_per_v; callers truncate to ``grid.size``
            (reference gas_optics.py:61-92).
        """
        device = resolve_device(self.device)
        v0, vn, n_per_v, num_points = internal_grid(grid)
        keep = self.pack.compat_break_filter(v0, vn, cut_off)
        if keep == 0:
            return np.zeros(num_points)
        params = line_profile_params(self.pack, temperature, pressure,
                                     volume_mixing_ratio, keep=keep)
        kin = kernel_inputs(params, v0, n_per_v, cut_off)
        arrays = prepare_kernel_arrays(
            kin, n_per_v, np.float64 if self.dtype == torch.float64
            else np.float32)
        k = accumulate_device(arrays, kin, num_points, n_per_v, cut_off,
                              device=device, plain=self.backend == "plain")
        k = k.cpu().numpy().astype(np.float64)
        if remove_pedestal:
            kin_ped = dict(kin)
            kin_ped["nu_raw"] = self.pack.nu[:keep]
            kin_ped["nu_shift"] = params["nu_shift"]
            ped = compute_pedestals(k, kin_ped, num_points, n_per_v, cut_off,
                                    device=device)
            k = apply_pedestal(k, ped, kin["s_idx"], kin["e_idx"],
                               num_points)
        return k

    def absorption_coefficient_batch(self, temperature, pressure,
                                     volume_mixing_ratio, grid,
                                     remove_pedestal=False,
                                     cut_off=DEFAULT_CUT_OFF,
                                     envelope=None, device=None, dtype=None,
                                     backend=None):
        """Layer-batched absorption cross sections, one pipeline call.

        Same semantics as :meth:`absorption_coefficient` per layer
        (reference spectroscopy.py:179-191).

        Args:
            temperature / pressure / volume_mixing_ratio: [B] arrays.
            envelope: optional (t_max [K], p_max_atm [atm]) kernel
                envelope (parallel.lines.derive_envelope); tighter
                envelopes shrink the layer-independent core-instance
                windows.  Default: the pipeline's wide terrestrial bounds
                (350 K, 5 atm).
            device / dtype / backend: override the engine's settings.

        Returns:
            numpy float64 [B, (vn - v0) * n_per_v].
        """
        from ...parallel.lines import make_batched_fn

        device = resolve_device(device or self.device)
        dtype = dtype or self.dtype
        backend = backend or self.backend
        temperature = np.atleast_1d(np.asarray(temperature, np.float64))
        pressure = np.atleast_1d(np.asarray(pressure, np.float64))
        volume_mixing_ratio = np.atleast_1d(
            np.asarray(volume_mixing_ratio, np.float64))
        num_layers = temperature.size
        v0, vn, n_per_v, num_points = internal_grid(grid)
        keep = self.pack.compat_break_filter(v0, vn, cut_off)
        if keep == 0:
            return np.zeros((num_layers, num_points))
        key = (float(grid[0]), float(grid[-1]), len(grid), cut_off,
               envelope, str(device), dtype, backend)
        fn = self._batched_fns.get(key)
        if fn is None:
            kwargs = {} if envelope is None else \
                {"t_max": envelope[0], "p_max_atm": envelope[1]}
            fn = make_batched_fn(self.pack, grid, cut_off=cut_off,
                                 backend=backend, device=device, dtype=dtype,
                                 **kwargs)
            self._batched_fns[key] = fn
        k = fn(temperature, pressure, volume_mixing_ratio)
        k = k.cpu().numpy().astype(np.float64)
        if remove_pedestal:
            params = line_profile_params(self.pack, temperature, pressure,
                                         volume_mixing_ratio, keep=keep)
            kin = kernel_inputs(params, v0, n_per_v, cut_off)
            kin["nu_raw"] = self.pack.nu[:keep]
            kin["nu_shift"] = params["nu_shift"]
            ped = compute_pedestals_batch(k, kin, num_points, n_per_v,
                                          cut_off, device=device)
            k = apply_pedestal_batch(k, ped, kin["s_idx"], kin["e_idx"],
                                     num_points)
        return k
