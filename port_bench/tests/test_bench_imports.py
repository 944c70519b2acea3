"""What the benchmark's modules import: no JAX and no JAX package anywhere
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the reference and the
generator."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dwpa_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "gen.py"])
def test_reference_is_independent(name):
    assert "dwpa_tpu_torch" not in top_imports(HERE / name)


def test_the_whole_name_is_compared():
    assert "dwpa_tpu_torch" not in FORBIDDEN
    from port_bench import run

    assert set(run.FORBIDDEN) == FORBIDDEN
