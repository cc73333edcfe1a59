"""A numpy-shaped namespace over torch tensors.

The host formulas of this package (ops/voigt.py, models/mt_ckd/bands.py,
models/arts_crossfit/cross_section.py) are written against a small
numpy-like namespace ``xp``.  :class:`TorchNamespace` supplies that surface
for torch tensors on one device, so the same formulas run on the card
without being rewritten: where numpy and torch differ (scalar operands of
``maximum``, ``pad`` widths, ``axis``/``keepdims`` keywords, default float
type) the namespace bridges it.
"""
import numpy as np
import torch


class TorchNamespace:
    """numpy-like functions on torch tensors of one device.

    Args:
        device: torch device every created tensor lives on.
        float_dtype: dtype given to Python and numpy floats that arrive
            without one (``asarray(0.0)``).
    """

    float32 = torch.float32
    float64 = torch.float64

    def __init__(self, device="cpu", float_dtype=torch.float64):
        self.device = torch.device(device)
        self.float_dtype = float_dtype

    def __repr__(self):
        return f"TorchNamespace({self.device}, {self.float_dtype})"

    def asarray(self, value, dtype=None):
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=dtype or value.dtype)
        array = np.asarray(value)
        if dtype is None and array.dtype.kind == "f":
            dtype = self.float_dtype
        return torch.as_tensor(array, dtype=dtype, device=self.device)

    def maximum(self, a, b):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)    # no scalar tensor, no host sync

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def exp(self, a):
        return torch.exp(a)

    def sqrt(self, a):
        return torch.sqrt(a)

    def abs(self, a):
        return torch.abs(a)

    def power(self, a, b):
        return torch.pow(a, b)

    def zeros_like(self, a, dtype=None):
        return torch.zeros_like(a, dtype=dtype)

    def broadcast_to(self, a, shape):
        return torch.broadcast_to(self.asarray(a), tuple(shape))

    def any(self, a, axis=None, keepdims=False):
        if axis is None:
            return torch.any(a)
        return torch.any(a, dim=axis, keepdim=keepdims)

    def sum(self, a, axis=None, keepdims=False):
        if axis is None:
            return torch.sum(a)
        return torch.sum(a, dim=axis, keepdim=keepdims)

    def pad(self, a, pad_width, constant_values=0.0):
        """numpy-style ``pad`` (per-axis (before, after) pairs, constant)."""
        flat = []
        for before, after in reversed(list(pad_width)):
            flat += [int(before), int(after)]
        return torch.nn.functional.pad(a, flat, value=constant_values)


def namespace_of(*arrays):
    """numpy for host arrays; a :class:`TorchNamespace` on the device of
    the first torch tensor among ``arrays``."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return TorchNamespace(a.device)
    return np
