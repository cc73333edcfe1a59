"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program; modules are compared by their
whole top-level name (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys

from lblbench.harness import main
from lblbench.tests.tiny import ROOT

JAX = {"jax", "jaxlib", "flax", "pylbl_tpu"}


def imported(path):
    """Top-level names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in (ROOT / "lblbench").rglob("*.py"):
        if "tests" not in path.parts:
            assert not imported(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "lblbench" / "reference").rglob("*.py"):
        assert not imported(path) & (JAX | {"pylbl_tpu_torch", "lblbench"}), \
            path


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def run_blocked(blocked, body):
    code = BLOCK.format(blocked=set(blocked), root=str(ROOT)) + body
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_a_run_loads_no_jax():
    """A whole run on the CPU with JAX and the JAX package refused: it
    completes, and the process holds none of them."""
    out = run_blocked(JAX, """
from lblbench.harness import main
from lblbench.tests.tiny import run, tiny_cell
r = run(tiny_cell("col60-0p1.column"), traced=True)
assert r["correct"], r
print(main.forbidden_modules())
""")
    assert out.strip().splitlines()[-1] == "[]"


def test_reference_runs_without_the_program():
    """The harness with the control in the program's place: the reference
    and the check run with the program refused."""
    run_blocked(JAX | {"pylbl_tpu_torch"}, """
from lblbench.harness.control import Control
from lblbench.tests.tiny import run, tiny_cell
r = run(tiny_cell("col60-0p1.column"), factory=Control)
assert r["checks"]["rel_err"]["value"] > 0, r
""")


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pylbl_tpu_torch_like", sys)
    assert "pylbl_tpu_torch_like" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pylbl_tpu.ops", sys)
    assert "pylbl_tpu.ops" in main.forbidden_modules()
