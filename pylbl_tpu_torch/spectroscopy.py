"""High-level spectroscopy API (counterpart of pylbl_tpu/spectroscopy.py).

Drop-in equivalent of the reference ``Spectroscopy``
(reference pyLBL/spectroscopy.py:72-235): per-gas, per-mechanism absorption
assembled into a Dataset with the same dims, units, mechanism ordering and
output formats.  Lines of all gases and all layers run as one stacked
device pipeline (parallel/lines.py) with the pedestal removed on the
device; continua and cross sections evaluate layer-batched, on the device
(``device_mechanisms``) or in host float64.  The device-reduced formats
run a layer batch larger than the device in blocks of layers
(``plan_blocks``).  Under a ``mesh`` of ranks
(parallel/mesh.py) the lines run line-sharded (parallel/sharded.py) and
every rank returns the same result.
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
from .runtime.device import resolve_backend, resolve_device, resolve_dtype
from .runtime.reuse import reuse_of
from .utils.constants import KB
from .utils.observability import metrics
from .utils.xrlite import DataArray, Dataset


def number_density(temperature, pressure, volume_mixing_ratio):
    """Ideal-gas number density [m-3] (reference spectroscopy.py:18-29)."""
    return pressure * volume_mixing_ratio / (KB * temperature)


# The memory model of the reduced path's blocks on the device: bytes a
# state of a block holds at its peak.  The stacked lines stage peaks while
# it assembles the kernel inputs: LINE_STATE_BYTES per stacked line or
# core instance (their kernel arrays, the wings rows, the core
# parameters) and FLAT_STATE_BYTES per point of the stacked [gases x
# points] grid (the wings and core passes' fields and their sum, the
# pedestal's float64 field where it is taken out), in 4-byte floats.  The
# sums stage holds the stacked field and GRID_STATE_BYTES per output point
# (the running float64 total, a gas's parts, the continua's temporaries).
# Fitted on an H100 to torch.cuda.max_memory_allocated at 60-480 states
# at 0.1 and 0.01 cm-1 (PERF.md section 3): 2.7% and 17% above the peaks.
LINE_STATE_BYTES = 84
FLAT_STATE_BYTES = 16
GRID_STATE_BYTES = 80
# Device bytes a call holds whatever its blocks, per output point (the
# continua tables a new object uploads).
GRID_FIXED_BYTES = 512
# Share of the device memory the allocator can hand out that the blocks
# plan on; the rest is left for fragmentation.
BLOCK_MEMORY_SHARE = 0.85


def block_bytes(lines, flat_points, grid_points, outputs, itemsize):
    """(bytes a state, fixed bytes) of a block of the reduced path: the
    larger of the stacked lines stage (``lines`` lines and core instances
    and ``flat_points`` points of the stacked grid in ``itemsize``-byte
    floats) and the sums stage (the stacked field kept, the per-gas sums
    of ``outputs`` output variables), plus the ``outputs`` float64 results
    of the block before, which wait for their copy to the host."""
    lines_stage = itemsize / 4 * (LINE_STATE_BYTES * lines
                                  + FLAT_STATE_BYTES * flat_points)
    sums_stage = itemsize * flat_points + GRID_STATE_BYTES * grid_points \
        + 8 * grid_points * (outputs - 1)
    state = max(lines_stage, sums_stage) + 8 * grid_points * outputs
    return int(state), GRID_FIXED_BYTES * grid_points


def block_budget(device):
    """Bytes the blocks may plan on: ``BLOCK_MEMORY_SHARE`` of what the
    caching allocator can hand out on ``device`` (CUDA's free
    memory and what the allocator holds unused), or None off CUDA."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    spare = torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return BLOCK_MEMORY_SHARE * (free + spare)


def plan_blocks(num_states, state_bytes, fixed_bytes, budget):
    """[(lo, hi)] bounds of the blocks that ``num_states`` states run in,
    each block's ``state_bytes`` a state and the call's ``fixed_bytes``
    within ``budget`` bytes: one block where all fit (or ``budget`` is
    None), else the fewest blocks of near-equal size (one state at
    least)."""
    fit = num_states if budget is None \
        else int((budget - fixed_bytes) // max(state_bytes, 1))
    if fit >= num_states:
        return [(0, num_states)]
    count = -(-num_states // max(fit, 1))
    size = -(-num_states // count)
    return [(lo, min(lo + size, num_states))
            for lo in range(0, num_states, size)]


class MoleculeCache:
    """Per-molecule backend objects, loaded once and reused
    (reference spectroscopy.py:32-69)."""

    def __init__(self, name, grid, lines_database, lines_engine,
                 continua_engine, cross_sections_engine, lines_kwargs=None):
        try:
            self.gas = lines_engine(lines_database, name,
                                    **(lines_kwargs or {}))
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
                 cross_sections_backend="arts_crossfit", mesh=None,
                 sharding_mode="balanced", device_mechanisms=None, *,
                 device="cuda", dtype=torch.float32, backend="kernel"):
        """Initializes the object (the JAX package's parameters in its
        order, then the port's ``device``, ``dtype`` and ``backend``).

        Args:
            atmosphere: dataset describing atmospheric conditions
                (xarray.Dataset or pylbl_tpu_torch Dataset).
            grid: wavenumber grid array [cm-1].
            database: Database object.
            mapping: optional dict mapping variable names
                (reference spectroscopy.py:93-103).
            lines_backend / continua_backend / cross_sections_backend:
                string backend names; unknown names raise KeyError.
            mesh: optional (batch, spec) rank mesh (parallel/mesh.py
                ``make_mesh``, parallel/distributed.py ``global_mesh``):
                every rank of the mesh constructs this object with the same
                inputs and calls the same methods; lines then compute with
                the line list sharded over "spec" and the layers over
                "batch" (parallel/sharded.py), each rank's batch rows on its
                own device.  Every rank returns the same result.
            sharding_mode: line decomposition under ``mesh``: "balanced"
                (default), "halo" or "ring"
                (parallel/shard_plans.py ``shard_line_pack``).
            device_mechanisms: evaluate continua and cross sections on
                ``device`` instead of host numpy.  Default: True on CUDA,
                False on the CPU (where the float64 host path is the
                parity anchor).
            device: torch device of the lines pipeline and the device
                mechanisms; "cuda" without a card raises.  Under a mesh the
                mesh's device (the rank's card, or the CPU) is used.
            dtype: lines pipeline float dtype, a torch or numpy spelling
                (the CUDA kernels take float32; float64 runs the plain
                versions).
            backend: "kernel" (CUDA kernels on the card, plain versions on
                the CPU), "plain" (plain versions on any device), "xla"
                (the portable path, computed by the per-gas engines) or a
                spelling runtime/device.resolve_backend maps to one of
                them.
        """
        with metrics.timed("spectroscopy.init"):
            self.mesh = mesh
            self.sharding_mode = sharding_mode
            self._sharded_fns = {}
            self.device = mesh.device if mesh is not None \
                else resolve_device(device)
            self.dtype = resolve_dtype(dtype)
            self.backend = resolve_backend(backend, self.device)
            self.atmosphere = Atmosphere(atmosphere, mapping=mapping)
            self.grid = np.asarray(grid)
            self.lines_database = database
            # What single-device objects on this database reuse across
            # requests; under a mesh the pipelines stay per object.
            self._reuse = reuse_of(database) if mesh is None else None
            self.lines_backend = lines_backend
            self.lines_engine = molecular_lines[lines_backend]
            self.continua_backend = continua_backend
            self.continua_engine = continua[continua_backend]
            self.cross_sections_backend = cross_sections_backend
            self.cross_sections_engine = \
                cross_sections[cross_sections_backend]
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
            dim_sizes = list(self.atmosphere.temperature.sizes.values()) \
                + [len(mechanisms), self.grid.size]
            self.output = Output(dims=dims, dim_sizes=dim_sizes,
                                 mechanisms=mechanisms,
                                 units={"units": "m-1"})

    def list_molecules(self):
        """Molecules available in the spectral database."""
        return self.lines_database.molecules()

    def _load_molecules(self):
        """Loads each atmosphere gas's backend objects once."""
        with metrics.timed("molecules.load"):
            for name in self.atmosphere.gases:
                if name not in self.cache:
                    self.cache[name] = MoleculeCache(
                        name, self.grid, self.lines_database,
                        self.lines_engine, self.continua_engine,
                        self.cross_sections_engine,
                        self._accepted(self.lines_engine))
                    metrics.count("molecules.loaded")

    def _accepted(self, fn, envelope=False):
        """This object's device, dtype and backend (and the atmosphere's
        envelope) as the keyword arguments ``fn`` accepts (third-party
        lines engines may take none)."""
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return {}
        offered = {"device": self.device, "dtype": self.dtype,
                   "backend": self.backend}
        if envelope:
            offered["envelope"] = self._envelope
        return {k: v for k, v in offered.items() if k in params}

    def _batch_kwargs(self, gas):
        """Extra kwargs for a lines engine's batched entry point."""
        return self._accepted(gas.absorption_coefficient_batch, True)

    def _device_mechanism_fns(self, name):
        """On-device continuum/xsec evaluators for one gas, built lazily
        and cached: (continua_fns or None, xsec_fn or None)."""
        fns = self._mechanism_fns.get(name)
        if fns is not None:
            return fns
        data = self.cache[name]
        if data.gas_continua is None and data.cross_section is None:
            fns = self._mechanism_fns[name] = (None, None)
            return fns
        with metrics.timed("continua.build"):
            cont_fns = None
            if data.gas_continua is not None:
                cont_fns = [cont.device_spectra(self.grid, self.device)
                            for cont in data.gas_continua]
            xsec_fn = None
            if data.cross_section is not None:
                xsec_fn = data.cross_section.device_absorption_fn(
                    self.grid, self.device)
        metrics.count("continua.builds")
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
            with metrics.timed("continua.run"):
                total = sum(fn(temperature, pressure, vmr_by_gas)
                            for fn in cont_fns)
                return total.cpu().numpy()
        with metrics.timed("continua.run"):
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
            with metrics.timed("continua.run"):
                return xsec_fn(temperature, pressure).cpu().numpy()
        with metrics.timed("continua.run"):
            return data.cross_section.absorption_coefficient_batch(
                self.grid, temperature, pressure)

    def _pad_mesh_batch(self, temperature, pressure, vmr):
        """Pads a layer batch to a multiple of the mesh batch axis with
        copies of the last layer (each batch row of ranks takes an equal
        share); callers slice the result back to the true size."""
        from .parallel.mesh import BATCH_AXIS

        pad = -temperature.size % self.mesh.shape[BATCH_AXIS]
        if not pad:
            return temperature, pressure, vmr
        temperature = np.concatenate(
            [temperature, np.repeat(temperature[-1:], pad)])
        pressure = np.concatenate(
            [pressure, np.repeat(pressure[-1:], pad)])
        if isinstance(vmr, dict):
            vmr = {x: np.concatenate([v, np.repeat(v[-1:], pad)])
                   for x, v in vmr.items()}
        else:
            vmr = np.concatenate(
                [vmr, np.repeat(vmr[-1:], pad, axis=0)], axis=0)
        return temperature, pressure, vmr

    def _compute_lines_sharded_pergas(self, temperature, pressure,
                                      vmr_by_gas, remove_pedestal):
        """Per-gas sharded line absorption over ``self.mesh``: the fallback
        when gases cannot share one stacked launch (each gas's line list
        sharded over "spec", the layers over "batch",
        parallel/sharded.py ``make_sharded_pipeline`` with the pedestal).

        Returns:
            dict name -> [B, num_points] float64 cross sections [m2].
        """
        from .parallel.sharded import make_sharded_pipeline

        num = temperature.size
        temperature, pressure, vmr_by_gas = self._pad_mesh_batch(
            temperature, pressure, vmr_by_gas)
        out = {}
        for name, vmr in vmr_by_gas.items():
            gas = self.cache[name].gas
            if gas is None or not hasattr(gas, "pack"):
                continue
            gkey = (name, float(self.grid[0]), float(self.grid[-1]),
                    self.grid.size, bool(remove_pedestal))
            gfn = self._sharded_fns.get(gkey)
            if gfn is None:
                gfn = make_sharded_pipeline(
                    gas.pack, self.grid, self.mesh, mode=self.sharding_mode,
                    remove_pedestal=remove_pedestal, weight_density=False,
                    backend=self.backend, dtype=self.dtype)
                self._sharded_fns[gkey] = gfn
            out[name] = gfn(temperature, pressure, vmr)[:num]
        return out

    def _stacked_pipeline(self, vmr_by_gas, remove_pedestal, backend=None):
        """The built stacked pipeline over the gases of ``vmr_by_gas``:
        (fn, remover or None, names), built on a miss.

        A built single-device pipeline lives on this object and, shared
        with every object on the same database, in the pipelines of its
        :func:`~pylbl_tpu_torch.runtime.reuse.reuse_of`: a new object over
        another atmosphere in the same quantized envelope reuses it (the
        counter ``lines.shared_hits``) and builds nothing.

        Args:
            backend: override of the pipeline backend; default this
                object's, except that under "xla" the stacked path is left
                to the per-gas engines (None result) unless asked for
                here, as the JAX package does (under a mesh the sharded
                pipeline runs this object's backend).

        Returns:
            The pipeline, or None when the gases cannot be stacked
            (:class:`~pylbl_tpu_torch.parallel.lines.UnstackableError`),
            some engine has no packed lines or the backend is "xla".
        """
        if backend is None and self.backend == "xla" and self.mesh is None:
            return None
        packs = {}
        for name in vmr_by_gas:
            gas = self.cache[name].gas
            if gas is None:
                continue
            if not hasattr(gas, "pack"):
                # Under a mesh the stackable gases stack (the per-gas paths
                # take the rest); on one device the per-gas dispatch does.
                if self.mesh is None:
                    return None
                continue
            packs[name] = gas.pack
        if not packs:
            return None
        backend = resolve_backend(backend or self.backend, self.device)
        # The grid enters the build through its ends, size and spacing
        # (grid[1]); the packs by identity, since another object of the
        # same name (a re-read, another engine's) may hold other lines.
        key = (float(self.grid[0]), float(self.grid[1]),
               float(self.grid[-1]), self.grid.size, tuple(packs), backend,
               self._envelope, bool(remove_pedestal), self.device,
               self.dtype, tuple(map(id, packs.values())))
        shared = None if self._reuse is None else self._reuse.pipelines
        cached = self._multigas_fns.get(key)
        if cached is None and shared is not None:
            cached = shared.get(key)
            if cached is not None:
                metrics.count("lines.shared_hits")
                self._multigas_fns[key] = cached
        if cached is None:
            cached = self._build_lines_stacked(packs, backend,
                                               remove_pedestal)
            self._multigas_fns[key] = cached
            if shared is not None:
                shared.put(key, packs.values(), cached)
        return None if cached == "unstackable" else cached

    def _run_stacked(self, built, temperature, pressure, vmr_by_gas,
                     local=False):
        """(names, k): the :meth:`_stacked_pipeline` ``built`` over these
        layers, one call for every gas's lines.

        ``names`` is the stacked gas order and ``k`` a [B, G, num_points]
        tensor of cross sections [m2] on the internal grid, on the device
        with the pedestal removed there.  Under a mesh the batch is padded
        to the mesh's batch axis and ``k`` is the full batch on every rank
        (or, with ``local``, this rank's batch group's rows as a Slab of the
        padded batch).
        """
        fn, remover, names = built
        with metrics.timed("lines.run"):
            vmr_mat = np.stack([np.asarray(vmr_by_gas[n], np.float64)
                                for n in names], axis=1)
            if self.mesh is not None:
                num = temperature.size
                t, p, x = self._pad_mesh_batch(temperature, pressure,
                                               vmr_mat)
                if local:
                    return names, fn.rows(t, p, x, False)
                return names, fn.full(t, p, x, False)[:num]
            k = fn(temperature, pressure, vmr_mat)
            if remover is not None:
                k = remover(k, temperature, pressure, vmr_mat)
            return names, k

    def _build_lines_stacked(self, packs, backend, remove_pedestal):
        """Builds the stacked pipeline over ``packs``: (fn, remover or
        None, names), or "unstackable"."""
        from .parallel.lines import (UnstackableError,
                                     make_multigas_batched_fn,
                                     make_stacked_pedestal_remover)

        with metrics.timed("lines.build"):
            try:
                if self.mesh is not None:
                    from .parallel.sharded import \
                        make_multigas_sharded_pipeline
                    fn = make_multigas_sharded_pipeline(
                        packs, self.grid, self.mesh, mode=self.sharding_mode,
                        remove_pedestal=remove_pedestal,
                        weight_density=False, backend=backend,
                        dtype=self.dtype)
                else:
                    fn = make_multigas_batched_fn(
                        packs, self.grid, t_max=self._envelope[0],
                        p_max_atm=self._envelope[1], backend=backend,
                        device=self.device, dtype=self.dtype)
            except UnstackableError:
                return "unstackable"
            remover = make_stacked_pedestal_remover(packs, self.grid) \
                if remove_pedestal and self.mesh is None else None
        metrics.count("lines.builds")
        return fn, remover, list(packs)

    def _compute_lines_stacked(self, temperature, pressure, vmr_by_gas,
                               remove_pedestal, backend=None):
        """Every gas's stacked lines on the host (``backend`` as
        :meth:`_stacked_pipeline` takes it).

        Returns:
            dict name -> [B, num_points] float64 cross sections [m2] on
            the internal grid, or {} when the stacked path does not apply.
        """
        built = self._stacked_pipeline(vmr_by_gas, remove_pedestal, backend)
        if built is None:
            return {}
        return self._fetch_lines(
            self._run_stacked(built, temperature, pressure, vmr_by_gas))

    @staticmethod
    def _fetch_lines(stacked):
        """:meth:`_run_stacked`'s (names, k) on the host: dict name ->
        [B, num_points] float64."""
        names, k_dev = stacked
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

        On one device the states run in the blocks of
        :meth:`_plan_blocks`, one block wherever the whole batch fits the
        device: each block's results start back to the host while the
        next block runs (:meth:`_reduced_blocks`).  A state's values do
        not depend on the other states of its block, so the output equals
        one unblocked call bit for bit.  Under a mesh the batch runs whole,
        each rank's rows gathered over "batch" (:meth:`_reduced_mesh`).

        Returns:
            Dataset, or None when some gas's lines cannot take the
            stacked path (the caller falls back to the host path).
        """
        names = list(self.atmosphere.gases)
        has_lines = [n for n in names if self.cache[n].gas is not None]
        built = self._stacked_pipeline(vmr_by_gas, remove_pedestal)
        stacked_names = built[2] if built is not None else []
        if any(n not in stacked_names for n in has_lines):
            return None
        reduce = self._reduced_mesh if self.mesh is not None \
            else self._reduced_blocks
        results = reduce(built, output_format, temperature, pressure,
                         vmr_by_gas)
        data_vars = {"wavenumber": DataArray(self.grid, dims=("wavenumber",),
                                             attrs={"units": "cm-1"})}
        dims = list(self.output.dims)
        dims.pop(-2)
        out_shape = shape + (self.grid.size,)
        for key, values in results.items():
            data_vars[key] = DataArray(values.reshape(out_shape), dims=dims,
                                       attrs=self.output.units)
        return Dataset(data_vars=data_vars)

    def _block_sums(self, built, output_format, temperature, pressure,
                    vmr_by_gas, k):
        """Per-gas mechanism sums of one block of states on the device:
        {output variable: [b, grid] tensor}, one a gas for "gas", else the
        total of the gases in their order.  ``k`` is the block's stacked
        lines (None without a pipeline ``built``)."""
        names = list(self.atmosphere.gases)
        stacked_names = built[2] if built is not None else []
        ngrid = self.grid.size
        mechanism_fns = {name: self._device_mechanism_fns(name)
                         for name in names}
        sums, total = {}, None
        with metrics.timed("continua.run"):
            for name in names:
                nd = number_density(temperature, pressure, vmr_by_gas[name])
                parts = []
                if name in stacked_names:
                    g = stacked_names.index(name)
                    parts.append(torch.as_tensor(
                        nd[:, None], dtype=k.dtype, device=self.device)
                        * k[:, g, :ngrid])
                cont_fns, xsec_fn = mechanism_fns[name]
                if cont_fns is not None:
                    for fn in cont_fns:
                        parts.append(fn(temperature, pressure, vmr_by_gas))
                if xsec_fn is not None:
                    parts.append(torch.as_tensor(nd[:, None],
                                                 device=self.device)
                                 * xsec_fn(temperature, pressure))
                gas_total = parts[0] if parts else torch.zeros(
                    (temperature.size, ngrid), dtype=torch.float64,
                    device=self.device)
                for part in parts[1:]:
                    gas_total = gas_total + part
                if output_format == "gas":
                    sums[f"{name}_absorption"] = gas_total
                else:
                    # The running total frees each gas's sum once added.
                    total = gas_total if total is None \
                        else total + gas_total
        return sums if output_format == "gas" else {"absorption": total}

    def _reduced_mesh(self, built, output_format, temperature, pressure,
                      vmr_by_gas):
        """The reduced sums under a mesh, in one call: this rank's batch
        rows of the padded batch, gathered over "batch" on the host side.
        Returns {output variable: [B, grid] float64 numpy array}."""
        from .parallel import collectives
        from .parallel.mesh import BATCH_AXIS
        from .parallel.sharded import row_slice

        num = temperature.size
        k = None
        if built is not None:
            k = self._run_stacked(built, temperature, pressure, vmr_by_gas,
                                  local=True)[1].data
        temperature, pressure, vmr_by_gas = self._pad_mesh_batch(
            temperature, pressure, vmr_by_gas)
        rows = row_slice(temperature.size, self.mesh)
        sums = self._block_sums(built, output_format, temperature[rows],
                                pressure[rows],
                                {n: v[rows] for n, v in vmr_by_gas.items()},
                                k)
        out = {}
        for key, total in sums.items():
            with metrics.timed("output"):
                total = collectives.all_gather(total, self.mesh,
                                               BATCH_AXIS)[:num]
                out[key] = total.cpu().numpy().astype(np.float64)
        return out

    def _plan_blocks(self, built, output_format, num_states):
        """[(lo, hi)] state blocks of the reduced path on one device, by
        :func:`block_bytes`'s model against :func:`block_budget`."""
        stage = None if built is None else getattr(built[0], "stage", None)
        lines = flat = 0
        if stage is not None:
            lines = stage.static["num_lines"] + stage.pad \
                + stage.core_plan.num_instances
            flat = stage.static["flat_points"]
        outputs = len(self.atmosphere.gases) if output_format == "gas" \
            else 1
        state, fixed = block_bytes(lines, flat, self.grid.size, outputs,
                                   self.dtype.itemsize)
        return plan_blocks(num_states, state, fixed,
                           block_budget(self.device))

    def _reduced_blocks(self, built, output_format, temperature, pressure,
                        vmr_by_gas):
        """The reduced sums on one device, block by block: block i's
        results go back to the host (:meth:`_start_copy`) while block i + 1
        runs, and land in one float64 array a variable once block i + 1's
        lines are under way.  Returns {output variable: [B, grid] float64
        numpy array}.

        Each block opens the span ``absorption.block``; the counter
        ``absorption.blocks`` counts a call's blocks; the host's wait for
        a block's copy is the span ``output.wait`` inside ``output``."""
        num = temperature.size
        blocks = self._plan_blocks(built, output_format, num)
        metrics.count("absorption.blocks", len(blocks))
        out = {}

        def land(lo, hi, fetch):
            with metrics.timed("output"):
                with metrics.timed("output.wait"):
                    arrays = fetch()
                for key, values in arrays.items():
                    if key not in out:
                        out[key] = np.empty((num, self.grid.size))
                    # torch's copy takes the host's threads.
                    torch.from_numpy(out[key][lo:hi]).copy_(values)

        with self._reuse.staging.lease() as buffers:
            landing = None
            for i, (lo, hi) in enumerate(blocks):
                with metrics.timed("absorption.block"):
                    t, p = temperature[lo:hi], pressure[lo:hi]
                    vmr = {n: v[lo:hi] for n, v in vmr_by_gas.items()}
                    k = None if built is None \
                        else self._run_stacked(built, t, p, vmr)[1]
                    if landing is not None:
                        # While this block's lines kernels run.
                        land(*landing)
                    sums = self._block_sums(built, output_format, t, p, vmr,
                                            k)
                    del k
                    with metrics.timed("output"):
                        fetch = self._start_copy(sums, buffers, i % 2)
                    del sums
                landing = (lo, hi, fetch)
            land(*landing)
        return out

    def _start_copy(self, sums, buffers, slot):
        """Starts a block's ``sums`` back to the host and returns a
        function that waits for them and gives {variable: host tensor}.

        On the card each tensor is copied on ``buffers``' side stream,
        after the block's kernels, into its pinned buffer of ``slot``
        (:class:`~pylbl_tpu_torch.runtime.reuse.HostStaging`), and its
        device memory is kept from reuse until the copy lands
        (``record_stream``)."""
        if self.device.type != "cuda":
            return lambda: sums
        stream = buffers.stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        hosts = {}
        with torch.cuda.stream(stream):
            for j, (key, t) in enumerate(sums.items()):
                host = buffers.get((slot, j), t.shape, t.dtype)
                host.copy_(t, non_blocking=True)
                t.record_stream(stream)
                hosts[key] = host
            done = torch.cuda.Event()
            done.record(stream)

        def fetch():
            done.synchronize()
            return hosts
        return fetch

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
        with metrics.timed("absorption"):
            return self._compute_absorption(output_format, remove_pedestal)

    def _compute_absorption(self, output_format, remove_pedestal):
        pressure, temperature, vmr_by_gas = self.atmosphere.packed()
        if remove_pedestal is None:
            remove_pedestal = self.continua_backend == "mt_ckd"
        shape = self.atmosphere.shape
        self._load_molecules()
        if output_format != "all" and self.device_mechanisms:
            reduced = self._compute_absorption_reduced(
                output_format, temperature, pressure, vmr_by_gas,
                remove_pedestal, shape)
            if reduced is not None:
                return reduced
        lines_stacked = self._compute_lines_stacked(
            temperature, pressure, vmr_by_gas, remove_pedestal)
        # One state takes the engines' single-layer call, as the JAX
        # package's compute_absorption does.
        arrays = self._host_absorption(temperature, pressure, vmr_by_gas,
                                       remove_pedestal, lines_stacked,
                                       batch_from=2)
        beta = {key: DataArray(values.reshape(shape + values.shape[1:]),
                               dims=self.output.dims, attrs=self.output.units)
                for key, values in arrays.items()}
        return self._create_output_dataset(beta, output_format)

    def _host_absorption(self, temperature, pressure, vmr_by_gas,
                         remove_pedestal, lines_stacked, *, batch_from):
        """Every gas's mechanisms on the host, in float64:
        {f"{name}_absorption": [B, mechanism, grid]}, the lines and cross
        sections weighted by the gas's number density.

        A gas's lines come from ``lines_stacked`` (name -> [B, num_points]
        float64, as :meth:`_compute_lines_stacked` gives them, empty when
        nothing stacked), else under a mesh from the per-gas sharded
        pipelines, else from its engine: ``absorption_coefficient_batch``
        from ``batch_from`` states up, one ``absorption_coefficient`` call
        a state below that or without it.
        """
        if not lines_stacked and self.mesh is not None:
            lines_stacked = self._compute_lines_sharded_pergas(
                temperature, pressure, vmr_by_gas, remove_pedestal)
        num, ngrid = temperature.size, self.grid.size
        out = {}
        for name in self.atmosphere.gases:
            gas = self.cache[name].gas
            fraction = vmr_by_gas[name]
            block = np.zeros((num, len(self.output.mechanisms), ngrid))
            n = number_density(temperature, pressure, fraction)
            lines = lines_stacked.get(name)
            if lines is None and gas is not None and num > 0:
                if num >= batch_from and \
                        hasattr(gas, "absorption_coefficient_batch"):
                    lines = gas.absorption_coefficient_batch(
                        temperature, pressure, fraction, self.grid,
                        remove_pedestal=remove_pedestal,
                        **self._batch_kwargs(gas))
                else:
                    lines = np.stack([gas.absorption_coefficient(
                        temperature[j], pressure[j], fraction[j], self.grid,
                        remove_pedestal=remove_pedestal)
                        for j in range(num)])
            if lines is not None:
                block[:, 0] = n[:, None] * lines[:, :ngrid]
            continua = self._continua_batch(name, temperature, pressure,
                                            vmr_by_gas)
            if continua is not None:
                block[:, 1] += continua
            xsec = self._xsec_batch(name, temperature, pressure)
            if xsec is not None:
                block[:, 2] = n[:, None] * xsec
            out[f"{name}_absorption"] = block
        return out

    def compute_absorption_streamed(self, path, remove_pedestal=None,
                                    resume=True, block_layers=8):
        """Streams per-gas, per-mechanism absorption to a chunked netCDF.

        For grids/batches too large for an in-memory Dataset (the
        BASELINE's RFMIP-scale configs).  States are computed in layer
        blocks of ``block_layers`` (each block one stacked all-gases
        pipeline call plus batched continua/xsec) and flushed per state;
        an interrupted run resumes from the unwritten states.  The file is
        the JAX package's layout (utils/streaming.py).  Under a mesh every
        rank runs the loop and rank 0 alone opens and writes the file.

        Returns:
            The output path.
        """
        from .utils.streaming import StreamingWriter

        if self.mesh is not None and self.mesh.rank != 0:
            self._stream_blocks(None, remove_pedestal, block_layers)
            return path
        writer = StreamingWriter(
            path, self.atmosphere.temperature.size, self.grid,
            [f"{n}_absorption" for n in self.atmosphere.gases],
            extra_dims={"mechanism": len(self.output.mechanisms)},
            mode="auto" if resume else "w")
        with writer:
            self._stream_blocks(writer, remove_pedestal, block_layers)
        return path

    def _stream_blocks(self, writer, remove_pedestal=None, block_layers=8):
        """The streamed block loop into ``writer``: any object with
        ``pending_states()`` (state indices) and ``write_state(i, values)``
        (``values``: name -> [mechanism, grid] float64).

        The pending states, possibly non-contiguous after a resume, go in
        blocks of ``block_layers``; block i+1's lines are dispatched before
        block i's are fetched, the JAX package's order.  The port's
        pedestal removal runs on the lines' device inside the dispatch,
        without a wait for it; the fetch waits.  The
        ``metrics`` timers ``stream.lines`` (stacked lines and pedestal),
        ``stream.fetch`` (device-to-host copy of the lines),
        ``stream.mechanisms`` (per-gas fallback lines, continua and cross
        sections) and ``stream.write`` take each block's host time.

        Under a mesh, rank 0 alone reads the pending states (broadcast to
        every rank) and writes; the other ranks' ``writer`` is ignored
        (None will do).  A barrier closes the pass.
        """
        pressure, temperature, vmr_full = self.atmosphere.packed()
        if remove_pedestal is None:
            remove_pedestal = self.continua_backend == "mt_ckd"
        self._load_molecules()
        writes = self.mesh is None or self.mesh.rank == 0
        pending = writer.pending_states() if writes else None
        if self.mesh is not None:
            from .parallel import collectives
            pending = collectives.broadcast_array(pending, self.mesh)
        blocks_idx = [pending[lo:lo + block_layers]
                      for lo in range(0, pending.size, block_layers)]

        def dispatch(idx):
            """Starts one block's stacked lines."""
            t_blk = temperature[idx]
            p_blk = pressure[idx]
            vmr_blk = {x: v[idx] for x, v in vmr_full.items()}
            with metrics.timed("stream.lines"):
                built = self._stacked_pipeline(vmr_blk, remove_pedestal)
                dev = None if built is None else self._run_stacked(
                    built, t_blk, p_blk, vmr_blk)
            return t_blk, p_blk, vmr_blk, dev

        prev = dispatch(blocks_idx[0]) if blocks_idx else None
        for bi, idx in enumerate(blocks_idx):
            t_blk, p_blk, vmr_blk, dev = prev
            prev = dispatch(blocks_idx[bi + 1]) \
                if bi + 1 < len(blocks_idx) else None
            lines_stacked = {}
            if dev is not None:
                with metrics.timed("stream.fetch"):
                    lines_stacked = self._fetch_lines(dev)
            with metrics.timed("stream.mechanisms"):
                # A block takes the engines' batch call at any size, as
                # the JAX package's streamed loop does.
                blocks = self._host_absorption(t_blk, p_blk, vmr_blk,
                                               remove_pedestal, lines_stacked,
                                               batch_from=1)
            with metrics.timed("stream.write"):
                for j, i in enumerate(idx):
                    if writes:
                        writer.write_state(int(i), {
                            key: value[j] for key, value in blocks.items()})
        if self.mesh is not None:
            collectives.barrier(self.mesh)

    def _create_output_dataset(self, absorption, output_format):
        """Assembles the output Dataset (reference spectroscopy.py:208-235)."""
        with metrics.timed("output"):
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
