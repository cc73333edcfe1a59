"""MT-CKD coefficient table access.

The tables are the npz that the JAX package ships
(pylbl_tpu/models/mt_ckd/mt_ckd_tables.npz, produced by
tools/convert_mtckd.py with the numeric content of the netCDF the reference
reads at pyLBL/mt_ckd/utils.py:114-142).  The file is located through the
import system's finder without importing ``pylbl_tpu`` (whose ``__init__``
pulls in jax), so both packages read one copy.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np


def _table_path():
    spec = importlib.util.find_spec("pylbl_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise FileNotFoundError(
            "pylbl_tpu package directory not found; the MT-CKD tables are "
            "read from pylbl_tpu/models/mt_ckd/mt_ckd_tables.npz")
    return (Path(list(spec.submodule_search_locations)[0]) / "models"
            / "mt_ckd" / "mt_ckd_tables.npz")


@functools.lru_cache(maxsize=1)
def _load(path=None):
    return dict(np.load(path or _table_path()))


class Table:
    """One coefficient table with its uniform wavenumber grid
    (equivalent of the reference's Spectrum, mt_ckd/utils.py:114-142)."""

    def __init__(self, name, path=None):
        raw = _load(path)
        self.data = raw[f"{name}__data"]
        self.grid = {
            "lower_bound": float(raw[f"{name}__lo"]),
            "upper_bound": float(raw[f"{name}__hi"]),
            "resolution": float(raw[f"{name}__res"]),
        }

    def wavenumbers(self):
        """Native wavenumber grid [cm-1] (reference utils.py:135-142)."""
        return self.grid["lower_bound"] + \
            np.arange(self.data.size) * self.grid["resolution"]


def subgrid_bounds(grid, subgrid):
    """Start/end indices of a subgrid within a grid
    (reference mt_ckd/utils.py:62-79)."""
    if grid["resolution"] != subgrid["resolution"]:
        raise ValueError("grid and subgrid have different resolutions.")
    if grid["lower_bound"] > subgrid["lower_bound"] or \
            grid["upper_bound"] < subgrid["upper_bound"]:
        raise ValueError("subgrid not contained in grid.")
    lower = int((subgrid["lower_bound"] - grid["lower_bound"])
                / grid["resolution"])
    upper = int((subgrid["upper_bound"] - grid["lower_bound"])
                / grid["resolution"])
    return lower, upper
