"""ctypes binding of the host pedestal scan (csrc/pylbl_native.cpp).

The port compiles the repository's existing C++ source with g++ into
``build/pylbl_tpu_torch/`` (runtime/build.py); the tracked
``csrc/libpylbl_native.so`` belongs to the JAX package and is never
rebuilt here.  The scan is the order-dependent remainder of reference
pedestal removal (models/lines/pedestal.py); its pure-Python form is
orders of magnitude slower, so a missing compiler is an error, not a
fallback.
"""
import ctypes

import numpy as np

from .build import REPO_DIR, BuildError, load_library

SOURCE = REPO_DIR / "csrc" / "pylbl_native.cpp"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def _command(sources, out):
    return ["g++", *CXXFLAGS, *map(str, sources), "-o", str(out)]


def _dp(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def load():
    """The loaded library (built on first use); raises BuildError."""
    lib = load_library("libpylbl_native.so", [SOURCE], _command)
    if not getattr(lib, "_pylbl_bound", False):
        i64, u8, f64 = _dp(np.int64), _dp(np.uint8), _dp(np.float64)
        lib.pedestal_scan.restype = None
        lib.pedestal_scan.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64, u8, u8, u8, u8, u8,
            f64, f64, f64, f64, f64, f64]
        lib._pylbl_bound = True
    return lib


def available():
    """Whether the library builds (when stale) and loads on this host."""
    try:
        load()
    except BuildError:
        return False
    return True


def pedestal_scan(bucket_rel, skip, left_clamp, right_clamp, cover0, coverN,
                  k_s_contrib, pre_contrib_e, cum0_incl, cumN_incl,
                  window, num_buckets):
    """Runs the sequential pedestal scan natively; returns ped [N]."""
    lib = load()
    num = bucket_rel.size
    ped = np.zeros(num)
    scratch = np.zeros(int(num_buckets))
    lib.pedestal_scan(
        num, int(window), int(num_buckets),
        np.ascontiguousarray(bucket_rel, np.int64),
        np.ascontiguousarray(skip, np.uint8),
        np.ascontiguousarray(left_clamp, np.uint8),
        np.ascontiguousarray(right_clamp, np.uint8),
        np.ascontiguousarray(cover0, np.uint8),
        np.ascontiguousarray(coverN, np.uint8),
        np.ascontiguousarray(k_s_contrib, np.float64),
        np.ascontiguousarray(pre_contrib_e, np.float64),
        np.ascontiguousarray(cum0_incl, np.float64),
        np.ascontiguousarray(cumN_incl, np.float64),
        scratch, ped)
    return ped
