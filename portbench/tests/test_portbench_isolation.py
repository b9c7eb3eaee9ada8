"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the program. Names are compared by their
top-level part, the name before the first dot, whole."""

import ast

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "shwd_tpu"}
SOURCES = sorted(p for p in harness.PKG.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = [p for p in SOURCES if p.parent.name == "reference"]


def imported(path):
    """(top-level names of absolute imports, levels of relative imports)."""
    names, levels = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.add(node.level)
            else:
                names.add(node.module.split(".")[0])
    return names, levels


def test_the_check_compares_whole_top_level_names():
    assert "shwd_torch".split(".")[0] not in FORBIDDEN
    assert imported.__doc__


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names, _ = imported(path)
    assert not names & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    names, levels = imported(path)
    assert names <= {"__future__", "contextlib", "math", "numpy", "scipy", "torch"}
    assert levels <= {1}
