"""Nothing under bench/ imports JAX, Flax, the JAX package (``repro``) or
the JAX benchmarks (``benchmarks``), and the reference imports nothing of
the program: top-level module names compared whole, so ``repro_torch`` is
not ``repro``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py") if p.name != Path(__file__).name)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_names(path) <= {"__future__", "math", "dataclasses", "torch"}


def test_the_check_compares_whole_names():
    assert "repro_torch" not in FORBIDDEN and "bench" not in FORBIDDEN
