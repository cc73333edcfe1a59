"""MT-CKD coefficient table access.

The tables are ``mt_ckd_tables.npz`` beside this module, a copy of the JAX
package's file (pylbl_tpu/models/mt_ckd/mt_ckd_tables.npz, produced by
tools/convert_mtckd.py with the numeric content of the netCDF the reference
reads at pyLBL/mt_ckd/utils.py:114-142), held byte-identical to it by
tests/test_torch_selfcontained.py.
"""
import functools
from pathlib import Path

import numpy as np

TABLES = Path(__file__).resolve().parent / "mt_ckd_tables.npz"


@functools.lru_cache(maxsize=1)
def _load(path=None):
    return dict(np.load(path or TABLES))


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
