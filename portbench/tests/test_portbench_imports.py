"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level names compared whole."""

import ast
import os

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "apex_tpu"}


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]


def _sources(root):
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_the_scan_tells_the_port_from_the_jax_package():
    assert "apex_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "apex_tpu.ops".split(".", 1)[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(spec.HERE)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(spec.HERE,
                                                              "reference"))))
def test_the_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert "apex_tpu_torch" not in names and not names & FORBIDDEN, path
