"""Device, dtype and backend selection for the port's compute entry
points."""
import numpy as np
import torch

# The float dtypes the entry points take, by numpy dtype.
_FLOAT_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def resolve_device(device):
    """Returns ``torch.device(device)``, raising when CUDA is asked for and
    absent (the port never falls back to the CPU on its own).  On CUDA it
    also turns TF32 off for float32 matrix products and convolutions, so
    no float32 path of the port rounds through TF32."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def resolve_dtype(dtype):
    """The torch float dtype of ``dtype``: ``torch.float32`` and
    ``torch.float64`` as they are, and any spelling ``np.dtype`` maps to
    float32 or float64 (``np.float64``, ``np.dtype("float32")``,
    ``"float64"``, the JAX package's spellings).  Anything else raises
    ``TypeError``."""
    if isinstance(dtype, torch.dtype):
        if dtype in _FLOAT_DTYPES.values():
            return dtype
    elif dtype is not None:
        try:
            return _FLOAT_DTYPES[np.dtype(dtype)]
        except (TypeError, KeyError):
            pass
    raise TypeError(f"dtype {dtype!r} is neither float32 nor float64")


def resolve_backend(backend, device, interpret=False):
    """The lines backend ``backend`` names on ``device``.

    "kernel" (the wrappers: CUDA kernels for CUDA tensors, plain versions
    for CPU tensors), "plain" (plain versions anywhere) and "xla" (the
    portable two-pass path, ops/lineshape.py ``accumulate``) stay as they
    are; "pallas", the JAX package's name of its kernels, is "kernel";
    "auto" (or None) is "kernel" on a CUDA device and "xla" elsewhere, as
    the JAX ``Gas`` picks its kernels on a TPU only.  ``interpret``, the
    JAX package's Pallas interpret mode (the kernels' bodies run without
    the chip), selects the plain versions on ``device`` for every name but
    "xla", which launches no kernel.  Unknown names raise ``ValueError``.
    """
    if backend is None:
        backend = "auto"
    if interpret and backend in ("pallas", "auto", "kernel", "plain"):
        return "plain"
    if backend == "pallas":
        return "kernel"
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "xla"
    if backend not in ("kernel", "plain", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend
