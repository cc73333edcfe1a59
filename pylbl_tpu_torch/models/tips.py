"""Total internal partition sums (TIPS 2017), host numpy.

Counterpart of pylbl_tpu/models/tips.py.  The reference ships two variants
of the partition-function interpolation with subtly different indexing:

- the Python variant using ``searchsorted`` (reference pyLBL/tips.py:26-39),
- the C variant used by the production lines path, which assumes the TIPS
  table is sampled on a uniform 1 K grid and indexes with
  ``floor(T) - T[0]`` (reference pyLBL/c_lib/spectral_database.c:97-104).

Both are provided here (vectorized over lines/layers, numpy); the lines
engine uses the C variant for parity with the reference's production
results.  The device path interpolates its own float32 table
(parallel/lines.py ``_q_interp``).
"""
import numpy as np

TIPS_REFERENCE_TEMPERATURE = 296.0  # [K] (reference pyLBL/tips.py:6).


def interp_uniform(temperature_table, data, temperature):
    """C-variant interpolation: uniform-grid floor indexing.

    Args:
        temperature_table: [nT] array of table temperatures (uniform 1 K grid,
            typically 1..5000 K).
        data: [..., nT] array of partition-function values (leading axes are
            isotopologue or line axes).
        temperature: scalar or array of temperatures to evaluate at.

    Returns:
        Q(temperature) with shape broadcast(data[..., 0], temperature).

    Mirrors reference spectral_database.c:97-104:
    ``i = floor(T) - t[0]; Q = d[i] + (d[i+1]-d[i])*(T - t[i])/(t[i+1]-t[i])``.
    """
    t0 = temperature_table[0]
    i = np.floor(temperature).astype("int32") - int(t0)
    i = np.clip(i, 0, data.shape[-1] - 2)
    di, dip1 = _gather_pair(data, i)
    ti = temperature_table[i]
    tip1 = temperature_table[i + 1]
    return di + (dip1 - di) * (temperature - ti) / (tip1 - ti)


def interp_searchsorted(temperature_table, data, temperature):
    """Python-variant interpolation (reference pyLBL/tips.py:37-39)."""
    j = np.searchsorted(temperature_table, temperature, side="left") - 1
    j = np.clip(j, 0, data.shape[-1] - 2)
    dj, djp1 = _gather_pair(data, j)
    tj = temperature_table[j]
    tjp1 = temperature_table[j + 1]
    return dj + (djp1 - dj) * (temperature - tj) / (tjp1 - tj)


def _gather_pair(data, i):
    """Gathers data[..., i] and data[..., i+1] with full broadcasting of the
    index array against data's leading axes."""
    if np.ndim(i) == 0:
        return data[..., i], data[..., i + 1]
    bshape = np.broadcast_shapes(data.shape[:-1], np.shape(i))
    data_b = np.broadcast_to(data, bshape + (data.shape[-1],))
    i_b = np.broadcast_to(i, bshape)[..., None]
    lo = np.take_along_axis(data_b, i_b, axis=-1)[..., 0]
    hi = np.take_along_axis(data_b, i_b + 1, axis=-1)[..., 0]
    return lo, hi


class TotalPartitionFunction:
    """Partition-function table for one molecule (API-compatible with the
    reference ``pyLBL.tips.TotalPartitionFunction``).

    Attributes:
        molecule: string chemical formula.
        temperature: [nT] array of temperatures [K].
        data: [n_iso, nT] array of partition-function values.
    """

    def __init__(self, molecule, temperature, data):
        self.molecule = molecule
        self.temperature = np.asarray(temperature)
        self.data = np.asarray(data)

    @property
    def isotopologue(self):
        return list(range(self.data.shape[0]))

    def total_partition_function(self, temperature, isotopologue,
                                 variant="searchsorted"):
        """Interpolates Q(T) for one isotopologue.

        Args:
            temperature: temperature [K] (scalar or array).
            isotopologue: 1-based isotopologue id (reference pyLBL/tips.py:36).
            variant: "searchsorted" (reference Python behavior, default) or
                "uniform" (reference C behavior used by the lines path).
        """
        row = self.data[isotopologue - 1]
        if variant == "uniform":
            return interp_uniform(self.temperature, row, temperature)
        return interp_searchsorted(self.temperature, row, temperature)
