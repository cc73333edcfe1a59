"""Gather-based linear interpolation (counterpart of pylbl_tpu/ops/interp.py).

The reference interpolates each continuum band from its native coarse grid
to the user grid with ``numpy.interp`` per call (reference
mt_ckd/utils.py:157-174) and each cross-section band with
``scipy.interpolate.interp1d`` (reference arts_crossfit/cross_section.py:45).
Interpolation onto a fixed target grid is a static gather: the indices and
fractional weights depend only on the two grids, so they are precomputed
once on the host and every evaluation is two gathers and a multiply-add.
:meth:`_GatherInterp.to` moves the weights to a torch device, where the
same call evaluates a whole layer batch.
"""
import numpy as np
import torch


class _GatherInterp:
    """Shared evaluation: ``values[..., idx] * w0 + values[..., idx+1] * w1``
    on numpy arrays, or on torch tensors after :meth:`to`."""

    def __call__(self, values):
        """Interpolates values [..., size] onto the target grid [..., n]."""
        lo = values[..., self.idx]
        hi = values[..., self.idx + 1]
        return lo * self.w0 + hi * self.w1

    def to(self, device):
        """A copy whose indices and float64 weights are tensors on
        ``device``."""
        out = object.__new__(type(self))
        out.idx = torch.as_tensor(self.idx, dtype=torch.int64, device=device)
        out.w0 = torch.as_tensor(self.w0, dtype=torch.float64, device=device)
        out.w1 = torch.as_tensor(self.w1, dtype=torch.float64, device=device)
        return out


class UniformGridInterp(_GatherInterp):
    """Precomputed linear interpolation source->target with 0 fill.

    Matches ``numpy.interp(target, source, values, left=0, right=0)`` for a
    uniform ascending source grid.
    """

    def __init__(self, lower_bound, resolution, size, target):
        target = np.asarray(target, dtype=np.float64)
        pos = (target - lower_bound) / resolution
        idx = np.floor(pos).astype(np.int64)
        frac = pos - idx
        # Points exactly on the last node interpolate with weight 0 on the
        # (clamped) right neighbor; points outside [0, size-1] get 0.
        inside = (pos >= 0.0) & (pos <= size - 1.0)
        idx_c = np.clip(idx, 0, size - 2)
        frac = np.where(inside, pos - idx_c, 0.0)
        self.idx = idx_c
        self.w1 = np.where(inside, frac, 0.0)
        self.w0 = np.where(inside, 1.0 - frac, 0.0)


class NonuniformGridInterp(_GatherInterp):
    """Linear interpolation from an arbitrary ascending grid with 0 fill.

    Precomputes bracketing indices/weights via searchsorted; evaluation is
    again two gathers + fma (used by the cross-section backend where band
    frequency grids are stored explicitly).
    """

    def __init__(self, source, target):
        source = np.asarray(source, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        idx = np.searchsorted(source, target, side="right") - 1
        idx_c = np.clip(idx, 0, source.size - 2)
        x0 = source[idx_c]
        x1 = source[idx_c + 1]
        frac = (target - x0) / (x1 - x0)
        inside = (target >= source[0]) & (target <= source[-1])
        self.idx = idx_c
        self.w1 = np.where(inside, frac, 0.0)
        self.w0 = np.where(inside, 1.0 - frac, 0.0)
