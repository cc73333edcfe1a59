"""Builds the port's native libraries into ``build/`` and loads them.

Two libraries, both plain C interfaces bound with ctypes:

- ``libpylbl_native.so`` from ``pylbl_tpu_torch/csrc/pylbl_native.cpp``
  (g++), for the HITRAN CSV parser and the host pedestal scan
  (runtime/native.py);
- ``liblineshape_cuda.so`` from ``pylbl_tpu_torch/csrc/lineshape.cu``
  and ``csrc/pedestal.cu`` (nvcc, ``sm_90a``), the hand-written wings and
  core kernels (ops/lineshape_cuda.py) and the pedestal remover's
  (ops/pedestal_cuda.py).

Libraries are built at first use into :func:`build_dir` and rebuilt when
a source is newer: ``build/pylbl_tpu_torch/`` beside the package (in a
checkout, ``<repo>/build/``, listed in .gitignore) when the process may
write there, else the per-user cache ``$XDG_CACHE_HOME/pylbl_tpu_torch``
(default ``~/.cache/pylbl_tpu_torch``), as for an installed package whose
``site-packages`` it does not own.  ``BUILD_DIR`` reads
:func:`build_dir`.  Each build writes a private temporary file and renames
it into place, so concurrent test workers never load a half-written
library; each library has its own lock, so two libraries build
concurrently from two threads.  A failed build raises, in either place:
nothing in the port falls back to a slower path.
"""
import ctypes
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
LOCAL_BUILD_DIR = PACKAGE_DIR.parent / "build" / "pylbl_tpu_torch"

_lock = threading.Lock()
_locks = {}
_loaded = {}
# Compiler output of the builds made by this process, by library name.
BUILD_LOGS = {}


class BuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


def can_write(path):
    """Whether this process may create and write the directory ``path``:
    its nearest existing ancestor is a writable directory."""
    path = Path(path)
    while not path.exists():
        if path.parent == path:
            return False
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def cache_dir():
    """The per-user build cache: ``$XDG_CACHE_HOME/pylbl_tpu_torch``, or
    ``~/.cache/pylbl_tpu_torch`` where that variable is unset or not an
    absolute path (the XDG base directory rule)."""
    base = os.environ.get("XDG_CACHE_HOME", "")
    root = Path(base) if os.path.isabs(base) else Path.home() / ".cache"
    return root / "pylbl_tpu_torch"


def build_dir():
    """Where the libraries build: ``LOCAL_BUILD_DIR`` beside the package
    when :func:`can_write` says it may, else :func:`cache_dir`."""
    if can_write(LOCAL_BUILD_DIR):
        return LOCAL_BUILD_DIR
    return cache_dir()


def __getattr__(name):
    if name == "BUILD_DIR":
        return build_dir()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_built(name, sources):
    """Whether ``build_dir()/name`` exists and is newer than every source
    (checks only: builds nothing)."""
    out = build_dir() / name
    return out.exists() and out.stat().st_mtime >= max(
        src.stat().st_mtime for src in sources)


def build_library(name, sources, command, build=True):
    """Compiles ``sources`` with ``command(sources, out_path)`` into
    ``build_dir()/name`` unless an up-to-date copy exists; returns its
    path.

    Args:
        name: library file name.
        sources: list of source Paths (their mtimes decide staleness).
        command: callable (sources, out_path) -> argv list.
        build: False compiles nothing: without an up-to-date copy it
            raises ``BuildError``.
    """
    for src in sources:
        if not src.exists():
            raise BuildError(f"missing source {src}")
    where = build_dir()
    out = where / name
    if is_built(name, sources):
        return out
    if not build:
        raise BuildError(f"{out} is missing or older than its sources and "
                         "build=False")
    where.mkdir(parents=True, exist_ok=True)
    tmp = where / f".{name}.{os.getpid()}.{threading.get_ident()}.tmp"
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


def load_library(name, sources, command, build=True):
    """Builds (when stale; with ``build=False`` it raises instead) and
    loads a library once per process."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_library(name, sources, command, build)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise BuildError(f"cannot load {path}: {exc}") from exc
            _loaded[name] = lib
        return lib
