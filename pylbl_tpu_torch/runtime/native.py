"""ctypes bindings of the host native library (csrc/pylbl_native.cpp).

The port compiles its own copy of the JAX package's C++ source
(``pylbl_tpu_torch/csrc/pylbl_native.cpp``, held byte-identical to
``csrc/pylbl_native.cpp`` by tests/test_torch_selfcontained.py) with g++
into runtime/build.py's ``build_dir()``; the tracked
``csrc/libpylbl_native.so`` belongs to the JAX package and is never loaded
here.  Two entry points: the HITRAN CSV parser of the ingest path
(database/db.py ``Database.create``) and the pedestal scan, the
order-dependent remainder of reference pedestal removal
(models/lines/pedestal.py).  Their pure-Python forms are orders of
magnitude slower, so a missing compiler is an error, not a fallback.
"""
import ctypes

import numpy as np

from .build import PACKAGE_DIR, BuildError, load_library

SOURCE = PACKAGE_DIR / "csrc" / "pylbl_native.cpp"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
# The parser's columns in the ingestion parameter order (reference
# database.py:89-90) with their dtypes.
CSV_COLUMNS = (("global_iso_id", np.int64), ("molec_id", np.int64),
               ("local_iso_id", np.int64), ("nu", np.float64),
               ("sw", np.float64), ("gamma_air", np.float64),
               ("gamma_self", np.float64), ("n_air", np.float64),
               ("delta_air", np.float64), ("elower", np.float64))


def _command(sources, out):
    return ["g++", *CXXFLAGS, *map(str, sources), "-o", str(out)]


def _dp(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


def load(build=True):
    """The loaded library, built on first use; raises BuildError.  With
    ``build=False`` it compiles nothing: it loads an up-to-date library
    or raises BuildError (it never returns None, as the JAX loader does
    for a missing library)."""
    lib = load_library("libpylbl_native.so", [SOURCE], _command, build)
    if not getattr(lib, "_pylbl_bound", False):
        i64, u8, f64 = _dp(np.int64), _dp(np.uint8), _dp(np.float64)
        lib.parse_transitions_csv.restype = ctypes.c_int64
        lib.parse_transitions_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            i64, i64, i64, f64, f64, f64, f64, f64, f64, f64,
            ctypes.c_int64]
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


def parse_transitions_csv(text):
    """Parses a HITRAN CSV results buffer into structure-of-arrays.

    Args:
        text: str or bytes CSV content, one transition per line in the
            ingestion parameter order (``CSV_COLUMNS``).

    Returns:
        dict of arrays keyed by ``CSV_COLUMNS`` names, one entry per row
        that parses (malformed rows are skipped).
    """
    lib = load()
    if isinstance(text, str):
        text = text.encode("utf-8")
    capacity = text.count(b"\n") + 2
    out = {name: np.empty(capacity, dtype) for name, dtype in CSV_COLUMNS}
    rows = lib.parse_transitions_csv(text, len(text), *out.values(), capacity)
    return {name: column[:rows] for name, column in out.items()}


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
