"""What the benchmark imports, by the top-level name of each module (the
part before the first dot, compared whole): no JAX and no JAX package
anywhere under ``benchmark/``, and the plain reference imports nothing of
the program either."""

import ast
import glob
import os

import pytest

from benchmark.harness import common

FILES = sorted(glob.glob(os.path.join(common.BENCH, "**", "*.py"),
                         recursive=True))
NEVER = {"jax", "jaxlib", "flax", "uwcv_tpu"}


def top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_files_found():
    assert any(p.endswith("run.py") for p in FILES)
    assert any("/reference/" in p for p in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, common.BENCH))
def test_no_jax(path):
    assert not set(top_levels(path)) & NEVER


@pytest.mark.parametrize("path", [p for p in FILES if "/reference/" in p],
                         ids=os.path.basename)
def test_reference_imports_no_program(path):
    assert "uwcv_tpu_torch" not in set(top_levels(path))
    # the reference's own imports stay inside it
    for name in top_levels(path):
        assert name in {"__future__", "contextlib", "math", "typing",
                        "numpy", "torch", "benchmark"}, name
    with open(path) as f:
        src = f.read()
    assert "benchmark.harness" not in src


def test_the_prefix_rule():
    """The port's name begins with the JAX package's: compared whole, it
    is another module."""
    assert "uwcv_tpu_torch".split(".")[0] not in NEVER
    assert "uwcv_tpu.ops".split(".")[0] in NEVER
