"""The harness and the reference import neither JAX nor the JAX package;
the reference imports nothing of the port.  Module names are compared by
their top-level name, whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAXISH = {"jax", "jaxlib", "flax", "differential_projection_voxel_renderer_tpu"}
PORT = "differential_projection_voxel_renderer_tpu_torch"


def _sources(folder):
    for base, _, files in os.walk(os.path.join(HERE, folder)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


ALL = sorted(_sources(""))


@pytest.mark.parametrize("path", ALL, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_tops(path)) & JAXISH


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_tops(path))
    assert "benchmark" not in set(_tops(path))


def test_forbidden_modules_compares_whole_names():
    import sys

    from benchmark import harness

    sys.modules.setdefault(PORT + "_probe_only", None)
    try:
        assert harness.forbidden_modules() == []
    finally:
        sys.modules.pop(PORT + "_probe_only", None)
