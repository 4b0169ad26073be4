"""No file of the benchmark imports JAX or the JAX package (compared by the
whole top-level name: the port's name begins with the JAX package's), the
reference imports nothing of the program, and nothing reads ``benchmarks/``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "calitas_tpu"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def path_strings(source: str) -> list:
    """String constants that name ``benchmarks/``, docstrings left out."""
    tree = ast.parse(source)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs
            and "benchmarks" in n.value.replace("perfbench", "")]


def test_the_scan_compares_whole_names():
    src = "import jax.numpy\nfrom calitas_tpu.io import x\nimport calitas_tpu_torch\n"
    assert top_level_imports(src) & FORBIDDEN == {"jax", "calitas_tpu"}
    assert path_strings('"""reads benchmarks/ never"""\nROOT / "benchmarks" / "x.py"\n') == [
        "benchmarks"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path.read_text()) & FORBIDDEN
    if path.name != Path(__file__).name:  # this file holds the scan's own test data
        assert not path_strings(path.read_text())


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path.read_text())
    assert names <= {"__future__", "dataclasses", "collections", "numpy", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("perfbench"):
            assert node.module.startswith("perfbench.reference")
