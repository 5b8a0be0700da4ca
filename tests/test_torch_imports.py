"""What the port imports: it stands on the card machine's installations.

Every module of ``algonauts2025_tpu_torch`` and ``chip_smoke.py`` is walked
as an AST.  Each top-level package it imports must be the standard library,
``torch``, ``numpy``, ``scipy``, ``einops``, ``pandas``, ``pydantic``,
``yaml``, ``typing_extensions`` or the port itself, except the few listed
below with their reason and their only callers.  None imports ``jax``, the
JAX package, ``h5py``, ``Levenshtein`` or ``rapidfuzz``.
"""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "algonauts2025_tpu_torch"
ALLOWED = {"torch", "numpy", "scipy", "einops", "pandas", "pydantic", "yaml",
           "typing_extensions", "algonauts2025_tpu_torch"}
#: package -> (why, the only modules that import it)
EXCEPTIONS = {
    "cv2": ("video decode, and the synthetic study's video writer",
            {"io/video.py", "data/synthetic.py"}),
    "transformers": ("named HF models, read from local files only",
                     {"features/text.py", "features/audio.py", "features/video.py"}),
    "PIL": ("Image events' payload", {"core/events.py"}),
    "wandb": ("the optional wandb mirror of the metrics, absent is fine",
              {"experiment/tracking.py"}),
    "benchmark": ("the frozen peak table and bound", {"chip_smoke.py"}),
}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "algonauts2025_tpu", "h5py", "Levenshtein",
             "rapidfuzz"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> set[str]:
    """Top-level packages of every absolute import in ``path``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _name(path: Path) -> str:
    return path.relative_to(PORT).as_posix() if PORT in path.parents else path.name


@pytest.mark.parametrize("path", _sources(), ids=_name)
def test_imports_are_on_the_card_machine(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    others = found - ALLOWED - set(sys.stdlib_module_names)
    for package in others:
        assert package in EXCEPTIONS, f"{_name(path)} imports {package}"
        assert _name(path) in EXCEPTIONS[package][1], f"{_name(path)} imports {package}"


def test_exceptions_are_all_used():
    """Every listed exception is imported by each of its listed callers."""
    by_module = {_name(p): _imports(p) for p in _sources()}
    for package, (_, callers) in EXCEPTIONS.items():
        for caller in callers:
            assert package in by_module[caller], (package, caller)


def test_the_walk_sees_every_module():
    names = {_name(p) for p in _sources()}
    assert {"io/hdf5.py", "data/levenshtein.py", "grids/defaults.py", "grids/test_run.py",
            "chip_smoke.py", "experiment/grid.py", "experiment/accuracy_gate.py",
            "utils/profiling.py", "models/fmri_mlp.py", "grids/_launch.py", "grids/run_grid.py",
            "grids/run_ensemble.py", "grids/run_config.py", "grids/average_submissions.py",
            "scripts/real_data_gate.py", "parallel/mesh.py", "parallel/sharding.py",
            "parallel/collectives.py", "parallel/sequence.py", "parallel/pipeline.py",
            "config/builders.py", "data/download.py"} <= names
    assert len(names) > 70
