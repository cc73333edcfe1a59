"""Kernel-array preparation for the line passes (host numpy).

Counterpart of pylbl_tpu/ops/lineshape.py:32-117: the float64 physics
outputs become kernel arrays with split line centers, so float32 kernels
see no catastrophic cancellation: x = ((t - c_int) - c_frac) * (repwid /
n_per_v) subtracts small same-scale numbers.  The portable two-pass
scatter-add ``accumulate`` of that module is not ported; the plain kernel
versions in ops/lineshape_cuda.py take its place on the CPU.
"""
import numpy as np

from .lineshape_cuda import core_halfwidths  # noqa: F401  (re-export)
from .voigt import XLIM0_MAX


def _pad_lines(arrays, multiple):
    """Pads the line axis so it divides evenly into chunks.

    Padded entries get prefactor 0 and a window placed at [-1, -2] so every
    candidate point is dropped by masking.
    """
    n = arrays["prefactor"].shape[-1]
    padded = -n % multiple
    if padded == 0:
        return arrays, n

    def pad(name, value):
        a = arrays[name]
        width = [(0, 0)] * (a.ndim - 1) + [(0, padded)]
        return np.pad(a, width, constant_values=value)
    out = {
        "c_int": pad("c_int", 0),
        "c_frac": pad("c_frac", 0.0),
        "scaled_repwid": pad("scaled_repwid", 1.0),
        "y": pad("y", 1.0),
        "prefactor": pad("prefactor", 0.0),
        "s_idx": pad("s_idx", -1),
        "e_idx": pad("e_idx", -2),
    }
    return out, n


def prepare_kernel_arrays(kin, n_per_v, dtype):
    """Converts float64 physics outputs to kernel dtype with split centers.

    Args:
        kin: dict from physics.kernel_inputs (float64, [N] or [B, N]).
        n_per_v: grid points per wavenumber.
        dtype: kernel dtype (np.float32 or np.float64).

    Returns:
        dict of host arrays for ops/lineshape_cuda.py.
    """
    center = kin["center"]
    c_int = np.rint(center).astype(np.int32)
    c_frac = (center - c_int).astype(dtype)
    return {
        "c_int": c_int,
        "c_frac": c_frac,
        "scaled_repwid": (kin["repwid"] / n_per_v).astype(dtype),
        "y": kin["y"].astype(dtype),
        "prefactor": kin["prefactor"].astype(dtype),
        "s_idx": kin["s_idx"].astype(np.int32),
        "e_idx": kin["e_idx"].astype(np.int32),
    }


def core_halfwidth(kin, n_per_v, cut_off):
    """Core-window half width in grid points, one for all lines.

    Covers |x| < XLIM0_MAX for every line with y < 70.55 (lines with larger
    y are pure Lorentzian everywhere, reference voigt.c:17-27), clipped to
    the wing window, and rounded up to a power of two as the JAX package
    does (there it is a jit-static shape).
    """
    y = np.asarray(kin["y"], dtype=np.float64)
    repwid = np.asarray(kin["repwid"], dtype=np.float64)
    needs = y < 70.55
    if not needs.any():
        return 1
    width = XLIM0_MAX / repwid[needs].min() * n_per_v
    width = int(min(np.ceil(width) + 1, (cut_off + 1) * n_per_v))
    return int(min(2 ** int(np.ceil(np.log2(max(width, 1)))),
                   (cut_off + 1) * n_per_v))
