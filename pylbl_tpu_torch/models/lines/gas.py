"""Molecular-lines gas optics engine (the "pyLBL" lines backend).

Counterpart of pylbl_tpu/models/lines/gas.py, with its engines:

- a single layer (:meth:`Gas.absorption_coefficient`) runs the float64
  host physics, then the single-layer device plan with exact per-layer
  windows (ops/lineshape_cuda.py ``accumulate_device``) or, under
  ``backend="xla"``, the portable two-pass path (ops/lineshape.py
  ``accumulate``), then the reference-exact pedestal
  (``compute_pedestals`` + ``apply_pedestal``);
- a layer batch (:meth:`Gas.absorption_coefficient_batch`) runs the cached
  single-gas batched pipeline (parallel/lines.py ``make_batched_fn``, wide
  default envelope) and ``compute_pedestals_batch`` +
  ``apply_pedestal_batch``; under ``backend="xla"`` it stacks single-layer
  calls, as the JAX engine's portable fallback does.

Both record the JAX engine's timers and counters in
utils/observability.py ``metrics``.
"""
import numpy as np
import torch

from .pedestal import (apply_pedestal, apply_pedestal_batch,
                       compute_pedestals, compute_pedestals_batch)
from .physics import LinePack, kernel_inputs, line_profile_params
from ...ops.lineshape import accumulate, prepare_kernel_arrays
from ...ops.lineshape_cuda import accumulate_device
from ...runtime.device import resolve_backend, resolve_device, resolve_dtype
from ...utils.constants import DEFAULT_CUT_OFF
from ...utils.observability import metrics


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
        dtype: the kernels' float dtype as a ``numpy.dtype`` (as the JAX
            engine reports it); ``torch_dtype`` is the same as a torch
            dtype.
        backend: "kernel", "plain" or "xla".
    """

    def __init__(self, lines_database, formula, dtype=torch.float32,
                 backend="kernel", *, device="cuda"):
        """Initializes the engine (the JAX engine's parameters in its
        order, then the port's ``device``).

        Args:
            lines_database: a Database-like object exposing
                ``line_pack(formula) -> LinePack``, or a LinePack directly.
            formula: string chemical formula.
            dtype: kernel float dtype, a torch or numpy spelling
                (``torch.float64``, ``np.float64``, ``"float64"``; the CUDA
                kernels take float32).
            backend: "kernel" (the wrappers: CUDA kernels for CUDA tensors,
                plain versions for CPU tensors), "plain" (plain versions
                on any device), "xla" (the portable two-pass path) or a
                spelling runtime/device.resolve_backend maps to one of
                them ("pallas"; "auto": "kernel" on the card, else "xla").
            device: torch device of the kernels and their inputs: the
                card by default (a call without one raises); "cpu" runs
                the plain versions on the host.
        """
        if isinstance(lines_database, LinePack):
            self.pack = lines_database
        else:
            self.pack = lines_database.line_pack(formula)
        self.formula = formula
        self.database = getattr(lines_database, "path", None)
        self.device = device
        self.torch_dtype = resolve_dtype(dtype)
        self.backend = resolve_backend(backend, device)
        self._batched_fns = {}

    @property
    def dtype(self):
        return np.dtype(str(self.torch_dtype).removeprefix("torch."))

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
        return self._layer(temperature, pressure, volume_mixing_ratio, grid,
                           remove_pedestal, cut_off, self.device,
                           self.torch_dtype, self.backend)

    def _layer(self, temperature, pressure, volume_mixing_ratio, grid,
               remove_pedestal, cut_off, device, dtype, backend):
        """One layer on ``device`` in ``dtype`` through ``backend`` (all
        resolved but the device)."""
        device = resolve_device(device)
        v0, vn, n_per_v, num_points = internal_grid(grid)
        keep = self.pack.compat_break_filter(v0, vn, cut_off)
        if keep == 0:
            return np.zeros(num_points)
        with metrics.timed("lines.absorption"):
            params = line_profile_params(self.pack, temperature, pressure,
                                         volume_mixing_ratio, keep=keep)
            kin = kernel_inputs(params, v0, n_per_v, cut_off)
            arrays = prepare_kernel_arrays(
                kin, n_per_v,
                np.float64 if dtype == torch.float64 else np.float32)
            if backend == "xla":
                k = accumulate(arrays, num_points, n_per_v, cut_off,
                               device=device)
            else:
                k = accumulate_device(arrays, kin, num_points, n_per_v,
                                      cut_off, device=device,
                                      plain=backend == "plain")
            k = k.cpu().numpy().astype(np.float64)
            if remove_pedestal:
                with metrics.timed("lines.pedestal"):
                    kin_ped = dict(kin)
                    kin_ped["nu_raw"] = self.pack.nu[:keep]
                    kin_ped["nu_shift"] = params["nu_shift"]
                    ped = compute_pedestals(k, kin_ped, num_points, n_per_v,
                                            cut_off, device=device)
                    k = apply_pedestal(k, ped, kin["s_idx"], kin["e_idx"],
                                       num_points)
        metrics.count("lines.processed", int(keep))
        metrics.count("lines.point_evals",
                      int(keep) * ((2 * cut_off + 1) * n_per_v + 1))
        metrics.count("lines.grid_points", int(num_points))
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
                (350 K, 5 atm).  The portable "xla" path, a loop of
                single layers, sizes no windows ahead and ignores it.
            device / dtype / backend: override the engine's settings.

        Returns:
            numpy float64 [B, (vn - v0) * n_per_v].
        """
        from ...parallel.lines import make_batched_fn

        device = self.device if device is None else device
        dtype = self.torch_dtype if dtype is None else resolve_dtype(dtype)
        backend = self.backend if backend is None \
            else resolve_backend(backend, device)
        device = resolve_device(device)
        temperature = np.atleast_1d(np.asarray(temperature, np.float64))
        pressure = np.atleast_1d(np.asarray(pressure, np.float64))
        volume_mixing_ratio = np.atleast_1d(
            np.asarray(volume_mixing_ratio, np.float64))
        num_layers = temperature.size
        v0, vn, n_per_v, num_points = internal_grid(grid)
        keep = self.pack.compat_break_filter(v0, vn, cut_off)
        if keep == 0:
            return np.zeros((num_layers, num_points))
        if backend == "xla":
            return np.stack([
                self._layer(temperature[i], pressure[i],
                            volume_mixing_ratio[i], grid, remove_pedestal,
                            cut_off, device, dtype, backend)
                for i in range(num_layers)])
        with metrics.timed("lines.absorption_batch"):
            key = (float(grid[0]), float(grid[-1]), len(grid), cut_off,
                   envelope, str(device), dtype, backend)
            fn = self._batched_fns.get(key)
            if fn is None:
                kwargs = {} if envelope is None else \
                    {"t_max": envelope[0], "p_max_atm": envelope[1]}
                fn = make_batched_fn(self.pack, grid, cut_off=cut_off,
                                     backend=backend, device=device,
                                     dtype=dtype, **kwargs)
                self._batched_fns[key] = fn
            k = fn(temperature, pressure, volume_mixing_ratio)
            k = k.cpu().numpy().astype(np.float64)
            if remove_pedestal:
                params = line_profile_params(self.pack, temperature,
                                             pressure, volume_mixing_ratio,
                                             keep=keep)
                kin = kernel_inputs(params, v0, n_per_v, cut_off)
                kin["nu_raw"] = self.pack.nu[:keep]
                kin["nu_shift"] = params["nu_shift"]
                with metrics.timed("lines.pedestal"):
                    ped = compute_pedestals_batch(k, kin, num_points,
                                                  n_per_v, cut_off,
                                                  device=device)
                    k = apply_pedestal_batch(k, ped, kin["s_idx"],
                                             kin["e_idx"], num_points)
        metrics.count("lines.processed", int(keep) * num_layers)
        metrics.count("lines.point_evals",
                      int(keep) * num_layers
                      * ((2 * cut_off + 1) * n_per_v + 1))
        return k
