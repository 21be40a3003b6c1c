"""No module of the benchmark imports the JAX side, and the reference
imports nothing of the program: each ``import`` and ``from`` of every
file, its top-level name (before the first dot) compared whole."""
import ast
import os

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "salt_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(directory):
    for dirpath, _, files in os.walk(directory):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_side(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(sources(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_no_program(path):
    assert "salt_tpu_torch" not in top_level_imports(path)


def test_loaded_modules_compared_whole(monkeypatch):
    """The harness's look into ``sys.modules`` after the window: the
    port's name begins with the JAX package's and passes."""
    import sys
    assert set(harness.FORBIDDEN) == FORBIDDEN
    for name in ("salt_tpu_torch", "salt_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "salt_tpu.core", sys)
    assert harness.forbidden_modules() == ["salt_tpu.core"]
