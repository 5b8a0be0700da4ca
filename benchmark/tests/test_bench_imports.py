"""Nothing the benchmark runs imports JAX or the JAX package; the references
import nothing of the port.  Names compare whole, by the part before the
first dot: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "algonauts2025_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "algonauts2025_tpu_torch" not in top_level_imports(path)
    assert not {"drivers", "harness"} & {n.split(".")[-1] for n in top_level_imports(path)}


def test_the_loaded_modules_hold_no_jax():
    """Every module a run loads (the harness, each driver, each metric):
    ``sys.modules`` holds none of the forbidden names after."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
for part in ("drivers", "metrics"):
    for path in sorted((harness.ROOT / part).glob("*.py")):
        harness.load_module(path)
found = harness.forbidden_modules()
print(found)
sys.exit(1 if found else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
