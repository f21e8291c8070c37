"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program under test.  Names are compared by
their top level, whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks", "benchmarks_torch"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_the_scan_sees_what_it_must():
    assert top_level_imports(HERE / "drivers" / "serve.py") >= {"numpy", "perfbench"}
    assert "repro_torch" in {n for p in FILES for n in top_level_imports(p)}
