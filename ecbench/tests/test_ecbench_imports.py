"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``seaweedfs_tpu_torch`` is the port, allowed), and
the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "seaweedfs_tpu"}


def modules():
    for root, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not set(top_names(path)) & BANNED


def test_the_port_passes_and_the_jax_package_does_not():
    assert "seaweedfs_tpu_torch".partition(".")[0] not in BANNED
    src = "import seaweedfs_tpu.ops\nfrom jax import numpy\n"
    tree = ast.parse(src)
    names = {n.names[0].name.partition(".")[0] if isinstance(n, ast.Import)
             else n.module.partition(".")[0]
             for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert names == {"seaweedfs_tpu", "jax"}


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    assert "seaweedfs_tpu_torch" not in set(top_names(path))
