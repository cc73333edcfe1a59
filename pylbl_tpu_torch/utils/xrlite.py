"""Minimal xarray-compatible data structures.

A copy of pylbl_tpu/utils/xrlite.py.

The reference framework (pyLBL) consumes and produces ``xarray.Dataset``
objects (reference pyLBL/spectroscopy.py:208-235, pyLBL/atmosphere.py:21-47).
This environment does not ship xarray, so this module provides a small,
dependency-free ``DataArray``/``Dataset`` pair that covers the same duck-typed
surface the framework needs:

- ``Dataset.data_vars`` mapping and ``dataset[name]`` item access,
- ``DataArray.data`` / ``.values`` / ``.dims`` / ``.sizes`` / ``.attrs``,
- construction from ``{name: (dims, data, attrs)}`` dicts (the xarray
  shorthand used by the reference test-suite, reference tests/conftest.py:14-25),
- ``equals`` comparison and netCDF4 (HDF5) round-trip via h5py.

If the real xarray package is importable, user-supplied xarray objects are
accepted transparently everywhere (everything is duck-typed); these classes are
only the fallback/default container.
"""
from collections import OrderedDict

import numpy as np


class DataArray:
    """A named, dimensioned ndarray with attributes (xarray.DataArray-like)."""

    def __init__(self, data, dims=None, attrs=None, name=None, coords=None):
        self.data = np.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.data.ndim))
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"dims {self.dims} do not match data of rank {self.data.ndim}")
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        self.coords = coords if coords is not None else {}

    @property
    def values(self):
        return self.data

    @values.setter
    def values(self, value):
        self.data[...] = value

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return self.data.size

    @property
    def sizes(self):
        return OrderedDict(zip(self.dims, self.data.shape))

    def equals(self, other):
        try:
            other_data = other.data
            other_dims = tuple(other.dims)
        except AttributeError:
            return False
        if self.dims != other_dims:
            return False
        if self.data.shape != np.asarray(other_data).shape:
            return False
        return bool(np.array_equal(self.data, other_data))

    def sum(self, axis=None):
        return DataArray(np.sum(self.data, axis=axis), attrs=self.attrs)

    def __getitem__(self, key):
        return self.data[key]

    def __array__(self, dtype=None):
        return np.asarray(self.data, dtype=dtype)

    def __repr__(self):
        return (f"<pylbl_tpu_torch.DataArray {self.name or ''}{self.dims} "
                f"shape={self.data.shape} dtype={self.data.dtype}>")


def _as_dataarray(value, name=None):
    """Coerces xarray-style shorthand into a DataArray."""
    if isinstance(value, DataArray):
        value.name = value.name or name
        return value
    if hasattr(value, "dims") and hasattr(value, "data"):
        # Real xarray (or compatible) object: wrap without copying.
        return DataArray(value.data, dims=tuple(value.dims),
                         attrs=dict(getattr(value, "attrs", {})), name=name)
    if isinstance(value, tuple):
        if len(value) == 2:
            dims, data = value
            attrs = None
        elif len(value) == 3:
            dims, data, attrs = value
        else:
            raise ValueError("variable tuples must be (dims, data[, attrs])")
        return DataArray(data, dims=dims, attrs=attrs, name=name)
    return DataArray(value, name=name)


class Dataset:
    """A mapping of named DataArrays (xarray.Dataset-like)."""

    def __init__(self, data_vars=None, attrs=None):
        self.attrs = dict(attrs) if attrs else {}
        self._variables = OrderedDict()
        if data_vars:
            for name, value in data_vars.items():
                self._variables[name] = _as_dataarray(value, name=name)

    @property
    def data_vars(self):
        return self._variables

    def __getitem__(self, name):
        return self._variables[name]

    def __setitem__(self, name, value):
        self._variables[name] = _as_dataarray(value, name=name)

    def __contains__(self, name):
        return name in self._variables

    def __iter__(self):
        return iter(self._variables)

    def keys(self):
        return self._variables.keys()

    def values(self):
        return self._variables.values()

    def items(self):
        return self._variables.items()

    def equals(self, other):
        try:
            other_vars = dict(other.data_vars)
        except (AttributeError, TypeError):
            return False
        if set(self._variables) != set(other_vars):
            return False
        return all(v.equals(other_vars[k]) for k, v in self._variables.items())

    def _dim_sizes(self):
        """Name -> size for every dimension used, consistency-checked."""
        sizes = OrderedDict()
        for name, var in self._variables.items():
            for dim, size in zip(var.dims, var.data.shape):
                if sizes.setdefault(dim, size) != size:
                    raise ValueError(
                        f"dimension {dim!r} has conflicting sizes "
                        f"{sizes[dim]} and {size} (variable {name!r})")
        return sizes

    def to_netcdf(self, path):
        """Writes the dataset as a netCDF4-classic (HDF5) file via h5py.

        Dimensions are written as real HDF5 dimension scales attached to
        every variable (the netCDF-4 convention: CLASS=DIMENSION_SCALE +
        DIMENSION_LIST references), so ``xarray.open_dataset`` / the
        netCDF-C library reconstruct dims and coordinates — the reference
        output contract (reference spectroscopy.py:208-235,
        docs/source/absorption_output.rst:15-124).  A variable named like
        one of its own dimensions becomes that dimension's coordinate
        variable; other dimensions get the standard hidden placeholder
        scale ("This is a netCDF dimension but not a netCDF variable.").
        The private ``_pylbl_dims`` attribute is kept for
        :func:`open_dataset`'s engine-free reader path.
        """
        import h5py
        dim_sizes = self._dim_sizes()
        with h5py.File(path, "w") as handle:
            handle.attrs["_NCProperties"] = np.bytes_(
                "version=2,pylbl_tpu=1")
            coords = {name for name, var in self._variables.items()
                      if var.dims == (name,)}

            def write_var(name, var):
                data = var.data
                if data.dtype.kind in "US":
                    data = np.asarray(
                        [s.encode() if isinstance(s, str) else s for s in
                         data.ravel()], dtype="S").reshape(data.shape)
                dset = handle.create_dataset(name, data=data)
                dset.attrs["_pylbl_dims"] = ",".join(var.dims)
                for key, value in var.attrs.items():
                    dset.attrs[key] = value
                return dset

            # Scales first (coordinate variables, then hidden placeholder
            # dimensions), so data variables can attach to them.
            for name in coords:
                write_var(name, self._variables[name]).make_scale(name)
            for dim, size in dim_sizes.items():
                if dim in coords:
                    continue  # the coordinate variable IS the scale
                scale = handle.create_dataset(dim, shape=(size,),
                                              dtype=np.float32)
                scale.make_scale(dim)
                scale.attrs["NAME"] = np.bytes_(
                    "This is a netCDF dimension but not a netCDF "
                    "variable.%10d" % size)
            for name, var in self._variables.items():
                if name in coords:
                    continue
                dset = write_var(name, var)
                for axis, dim in enumerate(var.dims):
                    dset.dims[axis].attach_scale(handle[dim])
            for key, value in self.attrs.items():
                handle.attrs[key] = value

    def __repr__(self):
        names = ", ".join(self._variables)
        return f"<pylbl_tpu_torch.Dataset vars=[{names}]>"


def open_dataset(path):
    """Reads a netCDF4 (HDF5) file into a Dataset via h5py.

    Handles both files written by :meth:`Dataset.to_netcdf` and generic
    netCDF4 files (e.g. arts-crossfit coefficient files, whose variables carry
    netCDF dimension metadata instead of ``_pylbl_dims``).
    """
    import h5py
    data_vars = OrderedDict()
    attrs = {}
    with h5py.File(path, "r") as handle:
        for key, value in handle.attrs.items():
            if key == "_NCProperties":
                continue  # file-format metadata, not a user attribute
            attrs[key] = value
        for name, dset in handle.items():
            if not isinstance(dset, h5py.Dataset):
                continue
            raw_attrs = dict(dset.attrs)
            nc_name = raw_attrs.get("NAME")
            if isinstance(nc_name, bytes) and nc_name.startswith(
                    b"This is a netCDF dimension but not a netCDF"):
                continue  # hidden dimension placeholder, not a variable
            if "_pylbl_dims" in raw_attrs:
                dims_attr = raw_attrs.pop("_pylbl_dims")
                if isinstance(dims_attr, bytes):
                    dims_attr = dims_attr.decode()
                dims = tuple(d for d in dims_attr.split(",") if d)
            else:
                # netCDF4 stores dimension scales; fall back to generic names.
                dimlist = raw_attrs.pop("DIMENSION_LIST", None)
                dims = None
                if dimlist is not None:
                    try:
                        dims = tuple(
                            handle[ref[0]].name.lstrip("/") for ref in dimlist)
                    except (KeyError, IndexError, TypeError):
                        dims = None
            data = dset[()]
            var_attrs = {k: v for k, v in raw_attrs.items()
                         if not k.startswith(("DIMENSION_", "_Netcdf", "CLASS",
                                              "NAME", "REFERENCE_LIST"))}
            data_vars[name] = DataArray(data, dims=dims, attrs=var_attrs,
                                        name=name)
    dataset = Dataset(attrs=attrs)
    dataset._variables = data_vars
    return dataset
