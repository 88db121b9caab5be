"""No module of the benchmark imports JAX or the JAX package (``repro``,
compared by whole top-level names: the port is ``repro_torch``), and the
plain references import nothing of the program."""

import ast
import os

import pytest

from lbench_cells import ROOT

BENCH_DIR = os.path.join(ROOT, "lightning_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p),
    ids=os.path.basename)
def test_reference_imports_none_of_the_program(path):
    assert not {"repro_torch", "repro", "lightning_bench"} & set(
        imported(path))


def test_a_name_that_begins_with_the_packages_is_not_it():
    from lightning_bench.harness import session

    assert "repro_torch" not in FORBIDDEN
    before = set(session.forbidden_modules())
    import repro_torch  # noqa: F401

    assert set(session.forbidden_modules()) == before
