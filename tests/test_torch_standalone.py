"""The port stands alone: no JAX, and no quiet fall back to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from algonauts2025_tpu_torch import runtime

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "algonauts2025_tpu"}
SOURCES = sorted((ROOT / "algonauts2025_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax(path):
    assert path.exists()
    assert not _imported_roots(path) & FORBIDDEN


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.default_device()
    assert runtime.default_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
