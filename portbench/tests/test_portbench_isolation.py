"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Names are
compared whole, by their top-level part: the port's package name begins
with the JAX package's."""

import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rocalphago_tpu"}


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    bad = set(_top_names(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize(
    "path", sorted(p for p in _modules()
                   if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_no_program(path):
    names = set(_top_names(path))
    assert "rocalphago_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_names_compared_whole():
    # the port's name starts with the JAX package's: a prefix test
    # would flag it, the whole-name test must not
    assert "rocalphago_tpu_torch" not in FORBIDDEN
    assert "rocalphago_tpu_torch".split(".", 1)[0] != "rocalphago_tpu"
