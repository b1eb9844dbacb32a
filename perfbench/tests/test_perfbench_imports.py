"""Nothing under ``perfbench/`` imports JAX, Flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port),
and the reference imports nothing of the program."""

import ast

import pytest

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec.HERE.rglob("*.py"))


def imported_top_levels(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_the_comparison_is_whole_names():
    import perfbench.run as run

    assert "repro" in run.FORBIDDEN and "repro_torch" not in run.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = imported_top_levels(spec.HERE / "reference.py")
    assert names <= {"__future__", "contextlib", "math", "torch"}


def test_the_benchmark_reads_nothing_under_benchmarks():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text(), path
