"""The port stands alone: no module of ``calitas_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``calitas_tpu``, nor
loads a file of ``benchmarks/`` by path.  An AST scan, one case per file;
``tests/test_torch_no_jax.py`` runs the port where neither can be
imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "calitas_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
)
FORBIDDEN = ("jax", "jaxlib", "calitas_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def offences(source: str) -> list:
    """``(line, what)`` of every forbidden import in ``source``: an
    ``import``/``from`` of jax or calitas_tpu, an ``importlib.import_module`` or
    ``__import__`` of one by a literal name, and a
    ``spec_from_file_location`` whose arguments mention ``benchmarks``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            args = [ast.unparse(a) for a in [*node.args, *(k.value for k in node.keywords)]]
            if name in ("import_module", "__import__") and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and _forbidden(str(first.value)):
                    out.append((node.lineno, first.value))
            if name == "spec_from_file_location" and any("benchmarks" in a for a in args):
                out.append((node.lineno, "spec_from_file_location(benchmarks/...)"))
    return out


def test_the_scan_finds_what_it_forbids():
    bad = (
        "import jax\nimport jax.numpy as jnp\nfrom calitas_tpu.core import x\n"
        "from calitas_tpu import native\nimport calitas_tpu\n"
        "def f():\n    from jaxlib import y\n"
        "    importlib.import_module('calitas_tpu.io')\n"
        "    importlib.util.spec_from_file_location('c', ROOT / 'benchmarks' / 'c.py')\n"
    )
    assert [line for line, _ in offences(bad)] == [1, 2, 3, 4, 5, 7, 8, 9]
    good = (
        "import calitas_tpu_torch\nfrom calitas_tpu_torch.core import cigar\n"
        "from . import x\nimport numpy\n# import jax\ns = 'calitas_tpu/ops'\n"
    )
    assert offences(good) == []


@pytest.mark.parametrize("path", FILES)
def test_imports_neither_jax_nor_the_jax_package(path):
    assert offences((ROOT / path).read_text()) == []
