"""What the benchmark's modules import, by whole top-level name: never
JAX or the JAX package, never the repo's other benchmark harness; the
plain references import nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = imported(path)
    assert not {n for n in names if n.split(".")[0] == "repro_torch"}
    assert "portbench.program" not in names
    assert all(n.split(".")[0] in {"__future__", "torch", "math",
                                   "statistics", "contextlib",
                                   "dataclasses", "portbench"}
               for n in names), names


def test_repro_torch_is_not_repro():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
