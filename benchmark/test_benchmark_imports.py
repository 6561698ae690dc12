"""No module under benchmark/ imports JAX, Flax, Optax, Orbax or the JAX
package, and the reference imports nothing of the program. Top-level
module names are compared whole: ``blurry_edges_tpu_torch`` begins with
``blurry_edges_tpu`` and is the program."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import FORBIDDEN

BENCH = Path(__file__).resolve().parent
PROGRAM = "blurry_edges_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)    # only its own folder, relatively


def test_whole_names_are_compared():
    assert "blurry_edges_tpu" in FORBIDDEN
    assert PROGRAM.split(".")[0] not in FORBIDDEN
