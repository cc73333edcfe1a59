"""Builds the port's native libraries into ``build/`` and loads them.

Two libraries, both plain C interfaces bound with ctypes:

- ``libpylbl_native.so`` from ``pylbl_tpu_torch/csrc/pylbl_native.cpp``
  (g++), for the HITRAN CSV parser and the host pedestal scan
  (runtime/native.py);
- ``liblineshape_cuda.so`` from ``pylbl_tpu_torch/csrc/lineshape.cu``
  (nvcc, ``sm_90a``), the hand-written wings and core kernels
  (ops/lineshape_cuda.py).

Libraries are built at first use into ``<repo>/build/pylbl_tpu_torch/``
(listed in .gitignore) and rebuilt when a source is newer.  Each build
writes a private temporary file and renames it into place, so concurrent
test workers never load a half-written library; each library has its own
lock, so two libraries build concurrently from two threads.  A failed
build raises: nothing in the port falls back to a slower path.
"""
import ctypes
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = PACKAGE_DIR.parent
BUILD_DIR = REPO_DIR / "build" / "pylbl_tpu_torch"

_lock = threading.Lock()
_locks = {}
_loaded = {}
# Compiler output of the builds made by this process, by library name.
BUILD_LOGS = {}


class BuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


def is_built(name, sources):
    """Whether ``BUILD_DIR/name`` exists and is newer than every source
    (checks only: builds nothing)."""
    out = BUILD_DIR / name
    return out.exists() and out.stat().st_mtime >= max(
        src.stat().st_mtime for src in sources)


def build_library(name, sources, command):
    """Compiles ``sources`` with ``command(sources, out_path)`` into
    ``BUILD_DIR/name`` unless an up-to-date copy exists; returns its path.

    Args:
        name: library file name.
        sources: list of source Paths (their mtimes decide staleness).
        command: callable (sources, out_path) -> argv list.
    """
    for src in sources:
        if not src.exists():
            raise BuildError(f"missing source {src}")
    out = BUILD_DIR / name
    if is_built(name, sources):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{name}.{os.getpid()}.{threading.get_ident()}.tmp"
    argv = command(sources, tmp)
    try:
        proc = subprocess.run(argv, capture_output=True, text=True)
    except OSError as exc:
        raise BuildError(f"cannot run {argv[0]}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(map(str, argv))} failed:\n"
                         f"{proc.stdout}\n{proc.stderr}")
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load_library(name, sources, command):
    """Builds (when stale) and loads a library once per process."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_library(name, sources, command)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise BuildError(f"cannot load {path}: {exc}") from exc
            _loaded[name] = lib
        return lib
