"""The port's public API against the JAX package's.

A JAX caller's code runs on the port: for every public function, class
and method of ``pylbl_tpu`` whose counterpart exists in
``pylbl_tpu_torch`` (at the same module path, or where the port moved it:
``MOVED``), the port's positional parameters start with JAX's, in order,
every JAX keyword is accepted, and every parameter the port requires JAX
requires too (read with ``ast``, so the JAX package is not imported for
it).  The port's own parameters (``device``, ``dtype``, ``backend``)
follow as keywords.  Every name a JAX ``__init__.py`` imports resolves in
the port's counterpart.  ``DEVIATIONS`` holds the two signatures that
differ on purpose, each with its reason.

Then the behaviour behind the repaired signatures, against the JAX
functions (Pallas in interpret mode, rel 5e-6 of the maximum as
tests/test_lineshape_pallas.py:31-33): ``wings_chunk`` and ``interpret``
on the stacked pipeline, ``make_batched_tpu_fn``, the positional ``Gas``
dtype and its ``numpy.dtype``, ``Spectroscopy``'s positional mesh
arguments, ``native.load(build=False)`` and the command line's
``--platform``.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.models.lines import Gas as JGas
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.__main__ import main
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.models.lines import Gas, LinePack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel import lines as tlines
from pylbl_tpu_torch.runtime import build, native
from pylbl_tpu_torch.runtime.device import resolve_backend

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "pylbl_tpu"
PORT_PKG = REPO / "pylbl_tpu_torch"
# JAX (module, name) -> the port module it moved to.
MOVED = {
    ("parallel.lines", "shard_line_pack"): "parallel.shard_plans",
    ("parallel.lines", "shard_stacked_packs"): "parallel.shard_plans",
    ("parallel.lines", "make_lines_sharded_step"): "parallel.sharded",
    ("parallel.lines", "make_multigas_sharded_pipeline"): "parallel.sharded",
    ("parallel.lines", "make_sharded_pipeline"): "parallel.sharded",
    ("parallel.lines", "make_sharded_step"): "parallel.sharded",
    ("ops.lineshape", "core_halfwidths"): "ops.lineshape_cuda",
}
# Signatures that differ on purpose.
DEVIATIONS = {
    ("parallel.mesh", "make_mesh"):
        "JAX's leading `devices` is a list of jax devices; a torch mesh "
        "is this process's rank in a process group, on its own device, so "
        "the port takes batch, spec and the rank's device",
    ("parallel.distributed", "initialize"):
        "JAX's coordinator address, process count and id and local device "
        "ids are jax.distributed's names; the port takes torch's "
        "rendezvous: init_method, world_size, rank, local_rank, backend",
}


def module_name(path, root):
    parts = path.relative_to(root).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def public(name):
    return not name.startswith("_") or name in ("__init__", "__call__")


def accessor(node):
    """Whether a def is a property's setter or deleter (the getter stands
    for the property)."""
    return any(isinstance(d, ast.Attribute) and d.attr in ("setter",
                                                            "deleter")
               for d in node.decorator_list)


def definitions(root):
    """{module: {qualified name: def or class node}} of a package, public
    module-level functions and classes and their public methods."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = module_name(path, root)
        if any(part.startswith("_") for part in mod.split(".")
               if part != "__main__"):
            continue
        defs = out.setdefault(mod, {})
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                defs[node.name] = node
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) \
                            and not accessor(sub):
                        defs[f"{node.name}.{sub.name}"] = sub
    return out


def all_definitions(root):
    """definitions() with private names too (for base-class lookups)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        defs = out.setdefault(module_name(path, root), {})
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                defs[node.name] = node
    return out


JAX_DEFS = definitions(JAX_PKG)
PORT_ALL = all_definitions(PORT_PKG)


def port_counterpart(mod, name):
    """The port's def node of JAX ``mod.name`` (methods through the
    class's bases in its module), or None."""
    defs = PORT_ALL.get(MOVED.get((mod, name), mod), {})
    head, _, method = name.partition(".")
    node = defs.get(head)
    if not method:
        return node
    while isinstance(node, ast.ClassDef):
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == method \
                    and not accessor(sub):
                return sub
        bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
        node = defs.get(bases[0]) if bases else None
    return None


def params(fn):
    """(positional names, keyword-only names, required names, *args,
    **kwargs) of a def."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    kw = [x.arg for x in a.kwonlyargs]
    required = set(pos[:len(pos) - len(a.defaults)])
    required |= {x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is None}
    return pos, kw, required, a.vararg is not None, a.kwarg is not None


def mismatches(jax_fn, port_fn):
    """How a JAX call could fail to bind, or bind wrongly, on the port."""
    jpos, jkw, jreq, jvar, jkwarg = params(jax_fn)
    tpos, tkw, treq, tvar, tkwarg = params(port_fn)
    out = []
    if tpos[:len(jpos)] != jpos:
        out.append(f"positional {jpos} is not a prefix of {tpos}")
    if not tkwarg:
        missing = [k for k in jpos + jkw if k not in tpos + tkw]
        if missing:
            out.append(f"keywords {missing} not accepted")
    if treq - jreq:
        out.append(f"the port requires {sorted(treq - jreq)}")
    if jvar and not tvar:
        out.append("no *args")
    if jkwarg and not tkwarg:
        out.append("no **kwargs")
    return out


CASES = [(mod, name) for mod, defs in JAX_DEFS.items()
         for name, node in defs.items()
         if isinstance(node, ast.FunctionDef)
         and all(public(part) for part in name.split("."))
         and port_counterpart(mod, name) is not None]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m}:{n}" for m, n in CASES])
def test_signature_starts_with_jax(mod, name):
    problems = mismatches(JAX_DEFS[mod][name], port_counterpart(mod, name))
    if (mod, name) in DEVIATIONS:
        assert problems, f"{mod}.{name} now matches: drop its deviation"
    else:
        assert not problems, f"{mod}.{name}: {problems}"


# The JAX module the port has under another name: the Pallas kernels'
# module, whose planners and launchers are ops/lineshape_cuda.py's (which
# take ``plain`` for ``interpret`` and no ``xp`` array namespace).
RENAMED_MODULES = {"ops.lineshape_pallas": "ops.lineshape_cuda"}


def test_every_public_name_has_a_counterpart():
    """Every public JAX function, class and method has its port
    counterpart, but in the module the port renamed."""
    missing = [(mod, name) for mod, defs in JAX_DEFS.items()
               if mod not in RENAMED_MODULES
               for name in defs
               if all(public(part) for part in name.split("."))
               and port_counterpart(mod, name) is None]
    assert not missing
    for mod, port in RENAMED_MODULES.items():
        assert mod not in PORT_ALL and port in PORT_ALL


def test_deviations_are_exactly_the_recorded_two():
    assert set(DEVIATIONS) == {("parallel.mesh", "make_mesh"),
                               ("parallel.distributed", "initialize")}
    assert all(len(reason) > 40 for reason in DEVIATIONS.values())
    assert set(DEVIATIONS) <= set(CASES)


def test_the_repaired_signatures_are_cases():
    """The faults this suite repairs stay under the test."""
    assert {("models.lines.gas", "Gas.__init__"),
            ("models.lines.gas", "Gas.dtype"),
            ("spectroscopy", "Spectroscopy.__init__"),
            ("parallel.lines", "make_multigas_batched_fn"),
            ("parallel.lines", "make_batched_tpu_fn"),
            ("parallel.lines", "make_lines_sharded_step"),
            ("parallel.lines", "make_sharded_pipeline"),
            ("parallel.lines", "make_multigas_sharded_pipeline"),
            ("runtime.native", "load"),
            ("ops.interp", "UniformGridInterp.__call__")} <= set(CASES)


def init_imports(path):
    """The names a package's ``__init__.py`` imports (also inside try)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


INITS = sorted(module_name(p, JAX_PKG) for p in JAX_PKG.rglob("__init__.py"))


@pytest.mark.parametrize("package", INITS, ids=[p or "." for p in INITS])
def test_init_imports_resolve(package):
    names = init_imports(JAX_PKG.joinpath(*package.split("."),
                                          "__init__.py"))
    port = importlib.import_module(
        "pylbl_tpu_torch" + (f".{package}" if package else ""))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"pylbl_tpu_torch.{package} lacks {missing}"


# --------------------------------------------------------------------------
# Behaviour behind the repaired signatures.
# --------------------------------------------------------------------------

T = np.asarray([288.99, 227.74], np.float32)
P = np.asarray([98388.0, 1032.0], np.float32)
VMR = np.asarray([[6.637074e-03, 3.9e-04], [4.2e-06, 3.9e-04]], np.float32)


def port_pack(pack):
    return LinePack(formula=pack.formula,
                    **{f: getattr(pack, f) for f in LinePack._ARRAY_FIELDS})


@pytest.fixture(scope="module")
def packs():
    jp = {"H2O": synthetic_line_pack("H2O", num_lines=300, nu_min=0.6,
                                     nu_max=90.0, seed=41,
                                     band_centers=(40.0,)),
          "CO2": synthetic_line_pack("CO2", num_lines=200, nu_min=0.6,
                                     nu_max=90.0, seed=42,
                                     band_centers=(20.0, 70.0))}
    return jp, {name: port_pack(p) for name, p in jp.items()}


def rel_points(got, want, floor=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    return np.abs(got - want) / np.maximum(np.abs(want), scale * floor)


def rel(got, want, floor=1e-7):
    return float(rel_points(got, want, floor).max())


def assert_matches_jax(got, want, jax64):
    """The port's float32 spectra within 5e-6 of JAX's (interpret mode),
    but where JAX's float32 window placement moves a line near an integer
    wavenumber by one cell (a reference-side fault the port does not
    inherit, ROADMAP): wherever the two differ by more, the port lies
    within 5e-6 of JAX's float64 engine ``jax64`` and JAX's float32 does
    not.  Each gas within 5e-4 of ``jax64`` (floor 1e-6,
    tests/test_multigas.py)."""
    off = rel_points(got, want) >= 5e-6
    assert (rel_points(got, jax64)[off] < 5e-6).all()
    assert (rel_points(want, jax64)[off] >= 5e-6).all()
    for g in range(got.shape[1]):
        assert rel(got[:, g], jax64[:, g], 1e-6) < 5e-4


def jax_float64(packs, grid):
    """[B, G, points] per-gas float64 "xla" cross sections of JAX's Gas."""
    return np.stack([np.stack([
        JGas(pack, name, dtype=np.float64, backend="xla")
        .absorption_coefficient(T[i], P[i], VMR[i, g], grid)
        for g, (name, pack) in enumerate(packs.items())])
        for i in range(T.size)])


@pytest.mark.parametrize("step,strided", [(0.1, True), (0.01, False)])
def test_wings_chunk_matches_jax(packs, step, strided):
    """``wings_chunk=128``: the strided plan with the tail class at 0.1
    cm-1, the splat CSR at 0.01 cm-1; the layout byte-identical to JAX's,
    the spectra within 5e-6, ``fn.wings_chunk`` JAX's."""
    grid = np.arange(1.0, 80.0 if strided else 30.0, step)
    tfn = tlines.make_multigas_batched_fn(packs[1], grid, wings_chunk=128,
                                          device="cpu")
    jfn = jlines.make_multigas_batched_fn(packs[0], grid, wings_chunk=128,
                                          interpret=True)
    assert (tfn.wings_stride is not None) == strided
    assert tfn.wings_stride == jfn.wings_stride
    assert tfn.wings_chunk == jfn.wings_chunk == 128
    if strided:
        assert tfn.wings_tail_csr is not None
        pairs = [*zip(tfn.wings_csr, jfn.wings_csr),
                 *zip(tfn.wings_tail_csr, jfn.wings_tail_csr)]
    else:
        assert tfn.wings_tail_csr is None and jfn.wings_tail_csr is None
        pairs = list(zip(tfn.wings_csr, jfn.wings_csr))
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = tfn(T, P, VMR).numpy()
    want = np.asarray(jfn(T, P, VMR))
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert_matches_jax(got, want, jax_float64(packs[0], grid))
    # The default chunk plans another layout; the spectra agree to the
    # same tolerance.
    default = tlines.make_multigas_batched_fn(packs[1], grid, device="cpu")
    assert default.wings_chunk == (256 if strided else 512)
    assert rel(got, default(T, P, VMR).numpy()) < 5e-6


@pytest.mark.parametrize("wings_chunk", [0, 1024])
def test_wings_chunk_out_of_range_raises(packs, wings_chunk):
    with pytest.raises(ValueError, match="wings_chunk"):
        tlines.make_multigas_batched_fn(packs[1], np.arange(1.0, 80.0, 0.1),
                                        wings_chunk=wings_chunk,
                                        device="cpu")


@pytest.mark.parametrize("backend", ["kernel", "plain", "xla"])
def test_interpret_selects_the_plain_versions(packs, backend):
    """``interpret=True`` is ``backend="plain"`` on the given device; the
    portable "xla" path, which launches no kernel, is unchanged."""
    grid = np.arange(1.0, 80.0, 0.1)
    fn = tlines.make_multigas_batched_fn(packs[1], grid, backend=backend,
                                         interpret=True, device="cpu")
    want_backend = "xla" if backend == "xla" else "plain"
    ref = tlines.make_multigas_batched_fn(packs[1], grid,
                                          backend=want_backend, device="cpu")
    if backend != "xla":
        assert fn.stage.plain and ref.stage.plain
    assert torch.equal(fn(T, P, VMR), ref(T, P, VMR))


@pytest.mark.parametrize("backend", [None, "auto", "pallas", "kernel",
                                     "plain", "xla"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_backend_interpret(backend, device):
    """``interpret=True`` is the plain versions for every backend name but
    "xla"; ``interpret=False`` changes nothing."""
    want = "xla" if backend == "xla" else "plain"
    assert resolve_backend(backend, device, interpret=True) == want
    assert resolve_backend(backend, device, interpret=False) == \
        resolve_backend(backend or "auto", device)


def test_sharded_step_needs_its_blocks_at_build():
    """JAX's step takes the blocks at call time; the port's keeps them from
    the build and says so when they are missing."""
    from pylbl_tpu_torch.parallel.sharded import make_lines_sharded_step
    with pytest.raises(ValueError, match="blocks= and q_table="):
        make_lines_sharded_step({}, {}, None, interpret=True)


def test_make_batched_tpu_fn_positional(packs):
    """JAX's positional order, ``interpret`` in its place: the port's
    ``make_batched_fn`` with the plain versions, and JAX's function in
    interpret mode within 5e-6."""
    grid = np.arange(1.0, 80.0, 0.1)
    args = (grid, 25, None, None, 350.0, 5.0, True, "rows", 128)
    got = tlines.make_batched_tpu_fn(packs[1]["H2O"], *args, device="cpu")
    ref = tlines.make_batched_fn(packs[1]["H2O"], grid, core_mode="rows",
                                 wings_tail=128, backend="plain",
                                 device="cpu")
    assert got.stage.plain and got.core_plan.mode == "rows"
    assert got.wings_tail_csr is not None
    x = VMR[:, 0]
    out = got(T, P, x)
    assert torch.equal(out, ref(T, P, x))
    want = np.asarray(jlines.make_batched_tpu_fn(packs[0]["H2O"], *args)(
        T, P, x))
    assert_matches_jax(out.numpy()[:, None], want[:, None],
                       jax_float64({"H2O": packs[0]["H2O"]}, grid))
    assert not tlines.make_batched_tpu_fn(packs[1]["H2O"], grid,
                                          device="cpu").stage.plain


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gas_positional_dtype(packs, dtype):
    """``Gas(pack, formula, dtype)`` by position (JAX's order): the dtype,
    not the device; ``Gas.dtype`` is a ``numpy.dtype`` equal to JAX's."""
    gas = Gas(packs[1]["H2O"], "H2O", dtype, device="cpu")
    jgas = JGas(packs[0]["H2O"], "H2O", dtype)
    assert isinstance(gas.dtype, np.dtype) and gas.dtype == jgas.dtype
    assert gas.torch_dtype == (torch.float64 if dtype is np.float64
                               else torch.float32)
    assert np.zeros(3, gas.dtype).dtype == np.dtype(dtype)
    grid = np.arange(1.0, 80.0, 0.1)
    keyword = Gas(packs[1]["H2O"], "H2O", dtype=dtype, device="cpu")
    np.testing.assert_array_equal(
        gas.absorption_coefficient(T[0], P[0], VMR[0, 0], grid),
        keyword.absorption_coefficient(T[0], P[0], VMR[0, 0], grid))


def test_spectroscopy_positional_mesh_arguments(packs, tmp_path):
    """``mesh``, ``sharding_mode`` and ``device_mechanisms`` by position
    land in their own parameters (JAX's order), not in ``device``."""
    db = Database(tmp_path / "d.db")
    db.ingest_line_pack(packs[1]["H2O"])
    atm = Dataset(data_vars={
        "p": (("z",), P.astype(np.float64),
              {"standard_name": "air_pressure", "units": "Pa"}),
        "t": (("z",), T.astype(np.float64),
              {"standard_name": "air_temperature", "units": "K"}),
        "h2o": (("z",), VMR[:, 0].astype(np.float64),
                {"standard_name": "mole_fraction_of_water_vapor_in_air",
                 "units": "mol mol-1"})})
    grid = np.arange(1.0, 80.0, 0.1)
    spec = Spectroscopy(atm, grid, db, None, "pyLBL", "mt_ckd",
                        "arts_crossfit", None, "halo", False, device="cpu")
    assert spec.mesh is None and spec.sharding_mode == "halo"
    assert spec.device_mechanisms is False
    assert spec.device == torch.device("cpu")
    keyword = Spectroscopy(atm, grid, db, sharding_mode="halo",
                           device_mechanisms=False, device="cpu")
    got = spec.compute_absorption(output_format="total")
    want = keyword.compute_absorption(output_format="total")
    np.testing.assert_array_equal(np.asarray(got["absorption"].data),
                                  np.asarray(want["absorption"].data))


def test_native_load_without_building(monkeypatch, tmp_path):
    """``load(build=False)`` loads an up-to-date library and compiles
    nothing; with none it raises ``BuildError`` (never None)."""
    native.load()
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_command", lambda sources, out: pytest.fail(
        "load(build=False) compiled"))
    lib = native.load(build=False)
    assert Path(lib._name).parent == build.BUILD_DIR
    assert lib.parse_transitions_csv.restype is not None

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "none")
    with pytest.raises(build.BuildError, match="build=False"):
        native.load(build=False)
    assert not (tmp_path / "none").exists()


def test_cli_platform_cpu_info(capsys):
    assert main(["--platform", "cpu", "info"]) == 0
    out = capsys.readouterr().out
    assert "device cpu: cpu" in out and "lines backends" in out


@pytest.mark.parametrize("argv,message", [
    (["--platform", "tpu", "info"], "not a TPU"),
    (["--platform", "gpu", "--device", "cpu", "info"], "disagree"),
    (["--platform", "cpu", "--device", "cuda", "info"], "disagree"),
    (["--platform", "cpu", "bench"], "CUDA card only")])
def test_cli_platform_refused(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("platform", ["gpu", "cuda"])
def test_cli_platform_gpu_is_the_card(platform, capsys):
    """``--platform gpu`` (or ``cuda``) asks for the card: here, with none,
    it exits non-zero naming CUDA, as ``--device cuda`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as exc:
        main(["--platform", platform, "info"])
    assert exc.value.code != 0
    assert "CUDA" in capsys.readouterr().err


def test_max_chunk_is_the_kernels():
    """The wings chunk limit equals csrc/lineshape.cu's kMaxChunk."""
    source = (PORT_PKG / "csrc" / "lineshape.cu").read_text()
    assert f"constexpr int kMaxChunk = {lc.MAX_CHUNK};" in source
