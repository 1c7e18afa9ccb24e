"""No module under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port or of torch.  Names are compared
by the whole of their top-level part, so the port, whose name begins with
the JAX package's, passes."""

import ast
import os

import pytest

from portbench.tests.tiny import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "bulletproofs_plus_tpu"}


def _modules(top):
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_portbench_the_comparison_is_by_whole_top_level_names():
    assert "bulletproofs_plus_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_portbench_module_imports_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_portbench_reference_imports_nothing_of_the_port(path):
    assert not set(_top_names(path)) & (FORBIDDEN | {"bulletproofs_plus_tpu_torch", "torch"})


def test_portbench_reads_neither_bench_py_nor_benches():
    for path in _modules(BENCH):
        if os.path.samefile(path, __file__):
            continue
        with open(path) as f:
            text = f.read()
        assert "bench.py" not in text and "benches/" not in text and "BENCH_r0" not in text, path
