"""What the benchmark's modules import, by top-level name compared whole:
nothing under ``benchmark/`` imports JAX, Flax or the JAX package
(``biped_mpc_py_tpu``), and the reference imports nothing of the program
(``biped_mpc_py_torch``). The port's name begins with the JAX package's
stem, so names are compared whole and never by prefix."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
NEVER = {"jax", "jaxlib", "flax", "biped_mpc_py_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    as ``benchmark``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module.split(".")[0] if node.level == 0 and node.module else "benchmark")
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not imported_tops(path) & NEVER


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "biped_mpc_py_torch" not in imported_tops(path)


def test_whole_names(tmp_path):
    """A name that only begins like a forbidden one is not forbidden."""
    p = tmp_path / "probe.py"
    p.write_text("import biped_mpc_py_torch\nfrom jaxtyping import x\n")
    assert imported_tops(p) == {"biped_mpc_py_torch", "jaxtyping"}
    assert not imported_tops(p) & NEVER
