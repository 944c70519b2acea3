"""The copy rule: the port and its smoke script import neither ``jax`` nor
``dwpa_tpu``, at any depth and inside any function — the port keeps its
own copy of every host module it needs."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dwpa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "dwpa_tpu")


def imported_modules(path: Path):
    """(line, absolute module name) of every import statement in the file;
    a relative import resolves against the file's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = path.relative_to(ROOT).parent.parts
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                name = ".".join(base + ((node.module,) if node.module else ()))
            else:
                name = node.module
            yield node.lineno, name


def test_the_walk_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "dwpa_tpu_torch/pmkstore/store.py",
            "dwpa_tpu_torch/gen/mask.py", "dwpa_tpu_torch/client/main.py"} <= names
    mods = {m for p in FILES for _, m in imported_modules(p)}
    assert "dwpa_tpu_torch.pmkstore.stage" in mods and "torch" in mods


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_dwpa_tpu_import(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if mod.split(".")[0] in BANNED]
    assert bad == []
