"""High-level spectroscopy API (counterpart of pylbl_tpu/spectroscopy.py).

Drop-in equivalent of the reference ``Spectroscopy``
(reference pyLBL/spectroscopy.py:72-235): per-gas, per-mechanism absorption
assembled into a Dataset with the same dims, units, mechanism ordering and
output formats.  Lines of all gases and all layers run as one stacked
device pipeline (parallel/lines.py) with the pedestal removed on the
device; continua and cross sections evaluate layer-batched, on the device
(``device_mechanisms``) or in host float64.
"""
import inspect
from collections import namedtuple

import numpy as np
import torch

from .atmosphere import Atmosphere
from .database.db import (AliasNotFoundError, CrossSectionNotFoundError,
                          IsotopologuesNotFoundError, TipsDataNotFoundError,
                          TransitionsNotFoundError)
from .plugins import continua, cross_sections, molecular_lines
from .runtime.device import resolve_device
from .utils.constants import KB
from .utils.xrlite import DataArray, Dataset


def number_density(temperature, pressure, volume_mixing_ratio):
    """Ideal-gas number density [m-3] (reference spectroscopy.py:18-29)."""
    return pressure * volume_mixing_ratio / (KB * temperature)


class MoleculeCache:
    """Per-molecule backend objects, loaded once and reused
    (reference spectroscopy.py:32-69)."""

    def __init__(self, name, grid, lines_database, lines_engine,
                 continua_engine, cross_sections_engine):
        try:
            self.gas = lines_engine(lines_database, name)
        except (AliasNotFoundError, IsotopologuesNotFoundError,
                TipsDataNotFoundError, TransitionsNotFoundError):
            self.gas = None
        if name == "H2O":
            names = [f"{name}{x}" for x in ["Foreign", "Self"]]
        else:
            names = [name]
        try:
            self.gas_continua = [continua_engine[x]() for x in names]
        except KeyError:
            self.gas_continua = None
        try:
            self.cross_section = cross_sections_engine(
                name, lines_database.arts_crossfit(name))
        except (AliasNotFoundError, CrossSectionNotFoundError):
            self.cross_section = None


class Spectroscopy:
    """Line-by-line gas optics (API-compatible with the reference)."""

    def __init__(self, atmosphere, grid, database, mapping=None,
                 lines_backend="pyLBL", continua_backend="mt_ckd",
                 cross_sections_backend="arts_crossfit", device="cpu",
                 dtype=torch.float32, device_mechanisms=None,
                 backend="kernel"):
        """Initializes the object.

        Args:
            atmosphere: dataset describing atmospheric conditions
                (xarray.Dataset or pylbl_tpu_torch Dataset).
            grid: wavenumber grid array [cm-1].
            database: Database object.
            mapping: optional dict mapping variable names
                (reference spectroscopy.py:93-103).
            lines_backend / continua_backend / cross_sections_backend:
                string backend names; unknown names raise KeyError.
            device: torch device of the lines pipeline and the device
                mechanisms; "cuda" without a card raises.
            dtype: lines pipeline float dtype (the CUDA kernels take
                float32; float64 runs the plain versions).
            device_mechanisms: evaluate continua and cross sections on
                ``device`` instead of host numpy.  Default: True on CUDA,
                False on the CPU (where the float64 host path is the
                parity anchor).
            backend: "kernel" (CUDA kernels on the card, plain versions on
                the CPU) or "plain" (plain versions on any device).
        """
        self.device = resolve_device(device)
        self.dtype = dtype
        self.backend = backend
        self.atmosphere = Atmosphere(atmosphere, mapping=mapping)
        self.grid = np.asarray(grid)
        self.lines_database = database
        self.lines_backend = lines_backend
        self.lines_engine = molecular_lines[lines_backend]
        self.continua_backend = continua_backend
        self.continua_engine = continua[continua_backend]
        self.cross_sections_backend = cross_sections_backend
        self.cross_sections_engine = cross_sections[cross_sections_backend]
        self.cache = {}
        self._multigas_fns = {}
        if device_mechanisms is None:
            device_mechanisms = self.device.type == "cuda"
        self.device_mechanisms = device_mechanisms
        self._mechanism_fns = {}
        # Tight kernel envelope from this atmosphere's actual conditions.
        from .parallel.lines import derive_envelope
        self._envelope = derive_envelope(
            np.asarray(self.atmosphere.temperature.data),
            np.asarray(self.atmosphere.pressure.data))

        Output = namedtuple("Output",
                            ["dims", "dim_sizes", "mechanisms", "units"])
        mechanisms = ["lines", "continuum", "cross_section"]
        dims = list(self.atmosphere.temperature.dims) + \
            ["mechanism", "wavenumber"]
        dim_sizes = [x for x in self.atmosphere.temperature.sizes.values()] \
            + [len(mechanisms), self.grid.size]
        self.output = Output(dims=dims, dim_sizes=dim_sizes,
                             mechanisms=mechanisms, units={"units": "m-1"})

    def _batch_kwargs(self, gas):
        """Extra kwargs for a lines engine's batched entry point (the
        atmosphere's envelope, device, dtype and backend) when the engine
        accepts them (third-party engines may not)."""
        try:
            params = inspect.signature(
                gas.absorption_coefficient_batch).parameters
        except (TypeError, ValueError):
            return {}
        offered = {"envelope": self._envelope, "device": self.device,
                   "dtype": self.dtype, "backend": self.backend}
        return {k: v for k, v in offered.items() if k in params}

    def _device_mechanism_fns(self, name):
        """On-device continuum/xsec evaluators for one gas, built lazily
        and cached: (continua_fns or None, xsec_fn or None)."""
        fns = self._mechanism_fns.get(name)
        if fns is not None:
            return fns
        data = self.cache[name]
        cont_fns = None
        if data.gas_continua is not None:
            cont_fns = [cont.device_spectra(self.grid, self.device)
                        for cont in data.gas_continua]
        xsec_fn = None
        if data.cross_section is not None:
            xsec_fn = data.cross_section.device_absorption_fn(self.grid,
                                                              self.device)
        self._mechanism_fns[name] = (cont_fns, xsec_fn)
        return cont_fns, xsec_fn

    def _continua_batch(self, name, temperature, pressure, vmr_by_gas):
        """[B, grid] continuum extinction [m-1] for one gas, summed over
        its continuum components; device path when enabled."""
        data = self.cache[name]
        if data.gas_continua is None:
            return None
        if self.device_mechanisms:
            cont_fns, _ = self._device_mechanism_fns(name)
            total = sum(fn(temperature, pressure, vmr_by_gas)
                        for fn in cont_fns)
            return total.cpu().numpy()
        return sum(continuum.spectra(temperature, pressure, vmr_by_gas,
                                     self.grid)
                   for continuum in data.gas_continua)

    def _xsec_batch(self, name, temperature, pressure):
        """[B, grid] cross sections [m2] for one gas; device path when
        enabled."""
        data = self.cache[name]
        if data.cross_section is None:
            return None
        if self.device_mechanisms:
            _, xsec_fn = self._device_mechanism_fns(name)
            return xsec_fn(temperature, pressure).cpu().numpy()
        return data.cross_section.absorption_coefficient_batch(
            self.grid, temperature, pressure)

    def _lines_device_stacked(self, temperature, pressure, vmr_by_gas,
                              remove_pedestal, backend=None):
        """One stacked pipeline call for every gas's lines, device-resident.

        All molecules' line lists are concatenated with per-line gas
        indices over a flat [G * num_points] grid, so the layer batch x gas
        product is one wings pass plus one core pass; the pedestal is
        removed on the device (only [B, N] endpoint values visit the host).

        Args:
            vmr_by_gas: dict name -> [B] mole fractions (insertion order
                fixes the gas order).
            backend: override of the pipeline backend ("kernel"/"plain").

        Returns:
            (names, k) with ``names`` the stacked gas order and ``k`` a
            [B, G, num_points] tensor of cross sections [m2] on the
            internal grid, or None when the gases cannot be stacked
            (:class:`~pylbl_tpu_torch.parallel.lines.UnstackableError`) or
            some engine has no packed lines.
        """
        from .parallel.lines import (UnstackableError,
                                     make_multigas_batched_fn,
                                     make_stacked_pedestal_remover)

        packs = {}
        for name in vmr_by_gas:
            gas = self.cache[name].gas
            if gas is None:
                continue
            if not hasattr(gas, "pack"):
                return None
            packs[name] = gas.pack
        if not packs:
            return None
        backend = backend or self.backend
        key = (float(self.grid[0]), float(self.grid[-1]), self.grid.size,
               tuple(packs), backend, self._envelope, bool(remove_pedestal))
        cached = self._multigas_fns.get(key)
        if cached == "unstackable":
            return None
        if cached is None:
            try:
                fn = make_multigas_batched_fn(
                    packs, self.grid, t_max=self._envelope[0],
                    p_max_atm=self._envelope[1], backend=backend,
                    device=self.device, dtype=self.dtype)
            except UnstackableError:
                self._multigas_fns[key] = "unstackable"
                return None
            remover = make_stacked_pedestal_remover(packs, self.grid) \
                if remove_pedestal else None
            cached = (fn, remover, list(packs))
            self._multigas_fns[key] = cached
        fn, remover, names = cached
        vmr_mat = np.stack([np.asarray(vmr_by_gas[n], np.float64)
                            for n in names], axis=1)
        k = fn(temperature, pressure, vmr_mat)
        if remover is not None:
            k = remover(k, temperature, pressure, vmr_mat)
        return names, k

    def _compute_lines_stacked(self, temperature, pressure, vmr_by_gas,
                               remove_pedestal, backend=None):
        """Host-materialized view of :meth:`_lines_device_stacked`.

        Returns:
            dict name -> [B, num_points] float64 cross sections [m2] on
            the internal grid, or {} when the stacked path does not apply.
        """
        out = self._lines_device_stacked(temperature, pressure, vmr_by_gas,
                                         remove_pedestal, backend=backend)
        if out is None:
            return {}
        names, k_dev = out
        k = k_dev.cpu().numpy().astype(np.float64)
        return {name: k[:, g] for g, name in enumerate(names)}

    def _compute_absorption_reduced(self, output_format, temperature,
                                    pressure, vmr_by_gas, remove_pedestal,
                                    shape):
        """Device-reduced "gas"/"total" output formats.

        Per-gas mechanism sums (lines x density + continuum + xsec x
        density) combine on the device and only [B, grid] arrays reach the
        host; the per-gas [B, 3, grid] mechanism arrays of the "all"
        format are never materialized.

        Returns:
            Dataset, or None when some gas's lines cannot take the
            stacked path (the caller falls back to the host path).
        """
        names = list(self.atmosphere.gases)
        has_lines = [n for n in names if self.cache[n].gas is not None]
        stacked = self._lines_device_stacked(temperature, pressure,
                                             vmr_by_gas, remove_pedestal)
        stacked_names, k_dev = stacked if stacked is not None else ([], None)
        if any(n not in stacked_names for n in has_lines):
            return None
        ngrid = self.grid.size
        per_gas = {}
        for name in names:
            nd = number_density(temperature, pressure, vmr_by_gas[name])
            parts = []
            if name in stacked_names:
                g = stacked_names.index(name)
                parts.append(torch.as_tensor(nd[:, None], dtype=k_dev.dtype,
                                             device=self.device)
                             * k_dev[:, g, :ngrid])
            cont_fns, xsec_fn = self._device_mechanism_fns(name)
            if cont_fns is not None:
                for fn in cont_fns:
                    parts.append(fn(temperature, pressure, vmr_by_gas))
            if xsec_fn is not None:
                parts.append(torch.as_tensor(nd[:, None], device=self.device)
                             * xsec_fn(temperature, pressure))
            total = parts[0] if parts else torch.zeros(
                (temperature.size, ngrid), dtype=torch.float64,
                device=self.device)
            for part in parts[1:]:
                total = total + part
            per_gas[name] = total

        wavenumber = DataArray(self.grid, dims=("wavenumber",),
                               attrs={"units": "cm-1"})
        data_vars = {"wavenumber": wavenumber}
        dims = list(self.output.dims)
        dims.pop(-2)
        out_shape = shape + (ngrid,)

        def host(t):
            return t.cpu().numpy().astype(np.float64).reshape(out_shape)

        if output_format == "gas":
            for name, total in per_gas.items():
                data_vars[f"{name}_absorption"] = DataArray(
                    host(total), dims=dims, attrs=self.output.units)
        else:
            total = None
            for part in per_gas.values():
                total = part if total is None else total + part
            data_vars["absorption"] = DataArray(
                host(total), dims=dims, attrs=self.output.units)
        return Dataset(data_vars=data_vars)

    def compute_absorption(self, output_format="all", remove_pedestal=None):
        """Computes absorption [m-1] for every gas/layer/mechanism.

        Args:
            output_format: "all" (per gas, per mechanism), "gas" (per gas,
                mechanism-summed), anything else = single total
                "absorption" variable (reference spectroscopy.py:144-235).
            remove_pedestal: override the default (True iff the continuum
                backend is mt_ckd, reference spectroscopy.py:163-164).

        Returns:
            Dataset of absorption coefficients [m-1].
        """
        pressure = np.asarray(self.atmosphere.pressure.data,
                              dtype=np.float64).ravel()
        temperature = np.asarray(self.atmosphere.temperature.data,
                                 dtype=np.float64).ravel()
        if remove_pedestal is None:
            remove_pedestal = self.continua_backend == "mt_ckd"
        beta = {}
        num_states = temperature.size
        shape = np.asarray(self.atmosphere.temperature.data).shape
        for name in self.atmosphere.gases:
            if name not in self.cache:
                self.cache[name] = MoleculeCache(
                    name, self.grid, self.lines_database,
                    self.lines_engine, self.continua_engine,
                    self.cross_sections_engine)
        vmr_by_gas = {
            name: np.asarray(mf.data, dtype=np.float64).ravel()
            for name, mf in self.atmosphere.gases.items()}
        if output_format != "all" and self.device_mechanisms:
            reduced = self._compute_absorption_reduced(
                output_format, temperature, pressure, vmr_by_gas,
                remove_pedestal, shape)
            if reduced is not None:
                return reduced
        lines_stacked = self._compute_lines_stacked(
            temperature, pressure, vmr_by_gas, remove_pedestal)
        for name, mole_fraction in self.atmosphere.gases.items():
            varname = f"{name}_absorption"
            beta[varname] = DataArray(np.zeros(self.output.dim_sizes),
                                      dims=self.output.dims,
                                      attrs=self.output.units)
            data = self.cache[name]
            fraction = vmr_by_gas[name]

            # Per-gas fallback (gases that cannot share one stacked call):
            # one pipeline call per gas over all layers.
            lines_batch = lines_stacked.get(name)
            if lines_batch is None and data.gas is not None and \
                    num_states > 1 and \
                    hasattr(data.gas, "absorption_coefficient_batch"):
                lines_batch = data.gas.absorption_coefficient_batch(
                    temperature, pressure, fraction, self.grid,
                    remove_pedestal=remove_pedestal,
                    **self._batch_kwargs(data.gas))

            continua_batch = self._continua_batch(name, temperature,
                                                  pressure, vmr_by_gas)
            xsec_batch = self._xsec_batch(name, temperature, pressure)

            for i in range(num_states):
                n = number_density(temperature[i], pressure[i], fraction[i])
                j = np.unravel_index(i, shape)

                if data.gas is not None:
                    if lines_batch is not None:
                        k = lines_batch[i]
                    else:
                        k = data.gas.absorption_coefficient(
                            temperature[i], pressure[i], fraction[i],
                            self.grid, remove_pedestal=remove_pedestal)
                    indices = tuple(list(j) + [0, slice(None)])
                    beta[varname].values[indices] = n * k[:self.grid.size]

                if continua_batch is not None:
                    indices = tuple(list(j) + [1, slice(None)])
                    beta[varname].values[indices] += continua_batch[i]

                if xsec_batch is not None:
                    indices = tuple(list(j) + [2, slice(None)])
                    beta[varname].values[indices] = n * xsec_batch[i]
        return self._create_output_dataset(beta, output_format)

    def _create_output_dataset(self, absorption, output_format):
        """Assembles the output Dataset (reference spectroscopy.py:208-235)."""
        wavenumber = DataArray(self.grid, dims=("wavenumber",),
                               attrs={"units": "cm-1"})
        data_vars = {"wavenumber": wavenumber}
        dims = list(self.output.dims)
        units = self.output.units
        if output_format == "all":
            data_vars["mechanism"] = DataArray(
                np.asarray(self.output.mechanisms), dims=("mechanism",))
            data_vars.update(absorption)
        elif output_format == "gas":
            dims.pop(-2)
            data_vars.update({
                x: DataArray(np.sum(y.values, axis=-2), dims=dims,
                             attrs=units)
                for x, y in absorption.items()})
        else:
            dims.pop(-2)
            data = [np.sum(x.values, axis=-2) for x in absorption.values()]
            data_vars["absorption"] = DataArray(sum(data), dims=dims,
                                                attrs=units)
        return Dataset(data_vars=data_vars)
