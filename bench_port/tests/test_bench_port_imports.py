"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``mmrag_tpu_torch`` begins with ``mmrag_tpu``), and
the reference imports nothing of the system under test."""

import ast
import os

import pytest

from .tiny_root import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "mmrag_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(_imports(path)), path


def test_reference_stands_alone():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "mmrag_tpu_torch" not in set(_imports(path)), path
        assert "bench_port" not in set(_imports(path)), path
        src = open(path).read()
        assert "from .." not in src, path


def test_loadgen_imports_only_the_standard_library():
    import sys

    mods = set(_imports(os.path.join(BENCH, "harness", "loadgen.py")))
    assert mods <= set(sys.stdlib_module_names) | {"__future__"}, mods
