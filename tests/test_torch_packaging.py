"""The port as an installed package (counterpart of tests/test_packaging.py).

- ``pyproject.toml`` declares the port's console script, its ``torch``
  extra and its eight built-in backends in the entry-point group
  ``pylbl_tpu_torch`` (the JAX package's eight names), each loadable as the
  port's own class; the package data covers every file the port reads at
  run time.
- An installed distribution (a ``*.dist-info`` written from that table
  onto ``sys.path``) is discovered by ``plugins.discover_entry_points``.
- The build directory: beside the package when the process may write
  there, else ``$XDG_CACHE_HOME/pylbl_tpu_torch``; the decision function
  (``runtime/build.py`` ``can_write``) is patched, not permission bits
  (root may write anywhere).  The g++ native library really builds into
  the cache, and a failed build there still raises.
"""
import importlib
import importlib.metadata
import tomllib
from pathlib import Path

import pytest

import pylbl_tpu_torch
from pylbl_tpu_torch import plugins
from pylbl_tpu_torch.models import mt_ckd
from pylbl_tpu_torch.models.arts_crossfit import CrossSection
from pylbl_tpu_torch.models.lines import Gas
from pylbl_tpu_torch.models.mt_ckd import tables
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.runtime import build, native

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pylbl_tpu_torch"
GROUP = "pylbl_tpu_torch"
CSV = b"1,1,1,1.5,2e-20,0.07,0.3,0.7,-0.001,100.0\n"


@pytest.fixture(scope="module")
def pyproject():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


@pytest.fixture
def registries(monkeypatch):
    """Copies of the registry dicts, so discovery leaves the module's
    own untouched."""
    monkeypatch.setattr(plugins, "molecular_lines",
                        dict(plugins.molecular_lines))
    monkeypatch.setattr(plugins, "cross_sections",
                        dict(plugins.cross_sections))
    monkeypatch.setattr(plugins, "continua",
                        {k: dict(v) for k, v in plugins.continua.items()})
    monkeypatch.setattr(plugins, "models", list(plugins.models))


def test_pyproject_declares_the_port(pyproject):
    """tests/test_packaging.py:21-28 for the port: its script and its
    extra."""
    project = pyproject["project"]
    assert project["scripts"]["pylbl-tpu-torch"] == \
        "pylbl_tpu_torch.__main__:main"
    assert project["optional-dependencies"]["torch"] == ["torch"]
    assert pyproject["tool"]["setuptools"]["packages"]["find"][
        "include"] == ["pylbl_tpu*"]


def test_builtin_entry_points_declared_and_loadable(pyproject):
    """tests/test_packaging.py:31-43 for the port's group: the JAX group's
    eight names, each loading the port's own class (the registry's)."""
    eps = pyproject["project"]["entry-points"]
    assert set(eps[GROUP]) == set(eps["pylbl_tpu"])
    want = {"Gas": Gas, "CrossSection": CrossSection,
            **{f"{key}Continuum": cls
               for key, cls in plugins.continua["mt_ckd"].items()}}
    assert set(want) == set(eps[GROUP])
    for name, value in eps[GROUP].items():
        module, _, attr = value.partition(":")
        assert module.split(".")[0] == "pylbl_tpu_torch"
        obj = getattr(importlib.import_module(module), attr)
        assert isinstance(obj, type) and obj is want[name], name


def test_package_data_covers_runtime_files(pyproject):
    """Every data file in the package, and each one the port reads at run
    time (the two sources it compiles, the MT-CKD tables), is in the
    port's package data."""
    patterns = pyproject["tool"]["setuptools"]["package-data"][GROUP]
    covered = {p for pattern in patterns for p in PORT.glob(pattern)}
    data = {p for p in PORT.rglob("*") if p.is_file()
            and p.suffix not in (".py", ".pyc")
            and "__pycache__" not in p.parts}
    assert data and data <= covered
    assert {native.SOURCE, lc.CUDA_SOURCE, tables.TABLES} <= covered


def test_installed_distribution_entry_points():
    """tests/test_packaging.py:95-110: where the project is pip-installed,
    the port's group is discoverable through importlib.metadata."""
    try:
        importlib.metadata.distribution("pylbl_tpu")
    except importlib.metadata.PackageNotFoundError:
        pytest.skip("pylbl_tpu not pip-installed in this environment")
    eps = importlib.metadata.entry_points(group=GROUP)
    assert {"Gas", "CrossSection", "H2OSelfContinuum"} <= \
        {ep.name for ep in eps}
    assert next(ep for ep in eps if ep.name == "Gas").load() is Gas


def write_dist_info(root, pyproject):
    """A distribution's metadata as an installer writes it, with the
    ``entry_points.txt`` of the pyproject's port group."""
    info = root / "pylbl_tpu-1.0.0.dist-info"
    info.mkdir()
    (info / "METADATA").write_text(
        "Metadata-Version: 2.1\nName: pylbl_tpu\nVersion: 1.0.0\n")
    lines = [f"[{GROUP}]"] + [
        f"{name} = {value}"
        for name, value in pyproject["project"]["entry-points"][
            GROUP].items()]
    (info / "entry_points.txt").write_text("\n".join(lines) + "\n")


def test_installed_group_registers_the_builtins(tmp_path, monkeypatch,
                                                 pyproject, registries):
    """An installed distribution's entry points, found on ``sys.path``,
    register the port's eight built-ins under its module root."""
    write_dist_info(tmp_path, pyproject)
    monkeypatch.syspath_prepend(str(tmp_path))
    names = {ep.name for ep in importlib.metadata.entry_points(group=GROUP)}
    assert len(names) == 8
    plugins.discover_entry_points()
    assert plugins.molecular_lines[GROUP] is Gas
    assert plugins.cross_sections[GROUP] is CrossSection
    assert plugins.continua[GROUP] == plugins.continua["mt_ckd"]
    assert plugins.continua[GROUP]["H2OSelf"] is \
        mt_ckd.WaterVaporSelfContinuum
    assert GROUP in plugins.models


def test_build_dir_beside_the_package():
    """In a checkout the libraries build into ``build/`` beside the
    package (the tests and the lone copies rely on it)."""
    assert build.LOCAL_BUILD_DIR == ROOT / "build" / "pylbl_tpu_torch"
    assert build.can_write(build.LOCAL_BUILD_DIR)
    assert build.build_dir() == build.BUILD_DIR == build.LOCAL_BUILD_DIR


def test_can_write(tmp_path):
    assert build.can_write(tmp_path / "a" / "b")
    (tmp_path / "file").write_text("")
    assert not build.can_write(tmp_path / "file" / "sub")


@pytest.mark.parametrize("xdg,want", [("cache", "cache"), (None, "home"),
                                      ("relative", "home")])
def test_cache_dir(tmp_path, monkeypatch, xdg, want):
    """``$XDG_CACHE_HOME/pylbl_tpu_torch``, else ``~/.cache``; a relative
    ``XDG_CACHE_HOME`` is ignored (the XDG base directory rule)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg is None:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    else:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache")
                           if xdg == "cache" else "relative")
    root = tmp_path / "cache" if want == "cache" \
        else tmp_path / "home" / ".cache"
    assert build.cache_dir() == root / "pylbl_tpu_torch"


@pytest.fixture
def unwritable(tmp_path, monkeypatch):
    """The package's parent reported unwritable, the cache in tmp_path;
    no library loaded yet."""
    monkeypatch.setattr(build, "can_write", lambda path: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(build, "_loaded", {})
    return tmp_path / "cache" / "pylbl_tpu_torch"


def test_build_dir_falls_back_to_the_cache(unwritable):
    """The native library really builds (g++) into the cache; ``BUILD_DIR``
    and ``is_built`` follow the decision."""
    assert build.build_dir() == build.BUILD_DIR == unwritable
    assert not build.is_built("libpylbl_native.so", [native.SOURCE])
    lib = native.load()
    assert Path(lib._name) == unwritable / "libpylbl_native.so"
    assert build.is_built("libpylbl_native.so", [native.SOURCE])
    assert native.parse_transitions_csv(CSV)["nu"].tolist() == [1.5]
    assert pylbl_tpu_torch.__file__.startswith(str(PORT))


def test_failed_build_in_the_cache_raises(unwritable, monkeypatch):
    monkeypatch.setattr(native, "_command", lambda sources, out: [
        str(unwritable / "no-such-compiler"), *map(str, sources), str(out)])
    with pytest.raises(build.BuildError, match="no-such-compiler"):
        native.load()
    assert not native.available()
    assert not (unwritable / "libpylbl_native.so").exists()
