"""Shard-resumable streamed output writing.

A copy of pylbl_tpu/utils/streaming.py.  RFMIP-scale configurations (100
columns x 0.01 cm-1 grids -> hundreds of GB of spectra) cannot be
assembled as one in-memory Dataset the way the reference does (reference
spectroscopy.py:166-206 allocates [layers, mechanisms, points] up front).
This writer appends layer/column blocks directly into a chunked netCDF4
(HDF5) file, tracks which blocks are complete, and lets an interrupted run
resume from the last finished block.  The file layout and its
``pylbl_tpu_stream`` metadata attribute are the JAX package's, so a file
written by either package resumes in the other.

h5py is imported only where a file is opened: importing this module needs
no h5py.
"""
import json

import numpy as np


class StreamingWriter:
    """Chunked, resumable writer for [state, ..., wavenumber] variables."""

    def __init__(self, path, num_states, grid, variables, extra_dims=(),
                 mode="auto"):
        """Creates (or reopens) the output file.

        Args:
            path: output netCDF4 path.
            num_states: size of the leading layer/column axis.
            grid: wavenumber grid [cm-1] (written once).
            variables: list of variable names (e.g. per-gas absorption).
            extra_dims: optional dict name->size of middle dims
                (e.g. {"mechanism": 3}).
            mode: "auto" resumes an existing file, "w" truncates.
        """
        import h5py
        self.path = str(path)
        self.num_states = int(num_states)
        self.grid = np.asarray(grid)
        self.variables = list(variables)
        self.extra_dims = dict(extra_dims)
        exists = mode == "auto" and self._compatible()
        self._h5 = h5py.File(self.path, "r+" if exists else "w")
        if not exists:
            self._h5.attrs["pylbl_tpu_stream"] = json.dumps({
                "num_states": self.num_states,
                "variables": self.variables,
                "extra_dims": self.extra_dims,
            })
            grid_var = self._h5.create_dataset("wavenumber", data=self.grid)
            grid_var.attrs["units"] = "cm-1"
            # netCDF-4 dimension scales (same convention as
            # xrlite.Dataset.to_netcdf): the wavenumber coordinate IS its
            # dimension's scale; state/extra dims get hidden placeholder
            # scales so xarray/netCDF-C reconstruct dims.
            grid_var.make_scale("wavenumber")
            dims = ["state"] + list(self.extra_dims) + ["wavenumber"]
            sizes = {"state": self.num_states, **self.extra_dims,
                     "wavenumber": self.grid.size}
            for dim in dims[:-1]:
                scale = self._h5.create_dataset(dim, shape=(sizes[dim],),
                                                dtype=np.float32)
                scale.make_scale(dim)
                scale.attrs["NAME"] = np.bytes_(
                    "This is a netCDF dimension but not a netCDF "
                    "variable.%10d" % sizes[dim])
            shape = (self.num_states,) + tuple(self.extra_dims.values()) + \
                (self.grid.size,)
            chunk = (1,) + tuple(self.extra_dims.values()) + \
                (min(self.grid.size, 65536),)
            for name in self.variables:
                dset = self._h5.create_dataset(name, shape=shape,
                                               chunks=chunk,
                                               dtype=np.float64)
                dset.attrs["units"] = "m-1"
                dset.attrs["_pylbl_dims"] = ",".join(dims)
                for axis, dim in enumerate(dims):
                    dset.dims[axis].attach_scale(self._h5[dim])
            self._h5.create_dataset("_complete",
                                    data=np.zeros(self.num_states, np.int8))
        self._complete = self._h5["_complete"]

    def _compatible(self):
        import h5py
        try:
            with h5py.File(self.path, "r") as handle:
                meta = json.loads(handle.attrs["pylbl_tpu_stream"])
                return (meta["num_states"] == self.num_states
                        and meta["variables"] == self.variables
                        and meta["extra_dims"] == self.extra_dims)
        except (OSError, KeyError, ValueError):
            return False

    def pending_states(self):
        """Indices of layer/column states not yet written (resume point)."""
        return np.where(np.asarray(self._complete[()]) == 0)[0]

    def write_state(self, index, values):
        """Writes one state's block for every variable and marks it done.

        Args:
            index: state index.
            values: dict name -> array matching the per-state shape.
        """
        for name in self.variables:
            self._h5[name][index, ...] = values[name]
        self._complete[index] = 1
        self._h5.flush()

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
