"""What the benchmark may import: nothing of JAX or the JAX package
(``hygrid_tpu``, compared by whole top-level name, since the port's name
begins with it), and in the reference nothing of the port."""
import ast
import subprocess
import sys

import pytest

from perfbench.harness import FORBIDDEN
from perfbench.tests import tiny

PKG = tiny.ROOT / "perfbench"
SOURCES = sorted(PKG.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert "hygrid_tpu_torch" not in tops and "chip_smoke" not in tops


def _strings(path):
    """The string constants of a module, its docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_harness_reads_no_file_outside_its_folder():
    """No path the harness runs with names the JAX benchmarks, ``bench.py``
    or ``chip_smoke.py``."""
    for path in SOURCES:
        if "tests" in path.relative_to(PKG).parts:
            continue
        for text in _strings(path):
            for name in ("benchmarks", "bench.py", "chip_smoke"):
                assert name not in text, (path, name)


def test_a_run_loads_no_jax():
    """The modules a run imports, the port's among them, bring no JAX in."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from perfbench import harness, programs, calibrate; "
            "from perfbench.loops import train, serve_closed; "
            "import hygrid_tpu_torch.models; "
            "print(harness.forbidden_modules())" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
