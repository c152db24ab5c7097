"""No module the benchmark runs imports JAX or the JAX package, top-level
names compared whole (the port's name begins with the JAX package's); the
reference imports nothing of the program either."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ladder_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"ladder_tpu_torch"})
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ladder_tpu_torch_x", sys)
    assert "ladder_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]
