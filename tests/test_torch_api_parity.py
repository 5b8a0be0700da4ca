"""Every public name of the JAX package has its counterpart in the port.

Each module of ``algonauts2025_tpu`` is read as an AST (not imported): its
public names are the module-level functions and classes not starting with
``_``, the names in its ``__all__``, and the public methods and properties
of its public classes (``Class.method``).  The port's module of the same
path must have each one under the same name (a method may come from a base
class, a property may be a pydantic field), or it is in one of the two
tables below: ``RENAMED`` names the port's counterpart, ``JAX_ONLY`` says
why the port has none.  An entry that the port no longer needs fails too.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "algonauts2025_tpu"

#: "module:name" -> the port's name for it in the same module; the public
#: methods of a renamed class are looked up on the port's class
RENAMED = {
    # the JAX interface and its JAX implementation are one torch class
    "features/audio.py:AudioBackbone": "TorchAudioBackbone",
    "features/audio.py:JaxAudioBackbone": "TorchAudioBackbone",
    "features/text.py:TextBackbone": "TorchTextBackbone",
    "features/text.py:JaxTextBackbone": "TorchTextBackbone",
    "features/video.py:JaxVideoBackbone": "TorchVideoBackbone",
    # flax calls a module's method by name; the port's method returns both
    "models/fmri_encoder.py:FmriEncoder.contrastive_losses": "FmriEncoder.forward_with_contrastive",
}

#: "module:name" -> why the port has no counterpart
JAX_ONLY = {
    "features/video.py:jnp_mean_tokens": "a jitted JAX reduction of JaxVideoBackbone's "
    "outputs; TorchVideoBackbone.encode_windows_async takes the token mean in torch",
    "features/video.py:jnp_swap": "a jitted JAX transpose of JaxVideoBackbone's outputs; "
    "TorchVideoBackbone.encode_windows_async transposes in torch",
    "models/backbones/wav2vec_bert.py:ScannedConformerLayer": "the nn.scan carry wrapper of "
    "the JAX conformer; the port runs one module a layer (models.convert unstacks)",
    "models/fmri_encoder.py:FmriEncoder.setup": "flax's submodule hook; the port builds them "
    "in __init__",
    "ops/flash_attention.py:pl_program_id": "a Pallas helper of the TPU kernels; the port's "
    "kernels are csrc/flash_attention.cu",
    "ops/flash_attention.py:pl_ds": "a Pallas helper of the TPU kernels; the port's kernels "
    "are csrc/flash_attention.cu",
    "runtime.py:enable_compilation_cache": "XLA's persistent compilation cache; the port "
    "builds its kernels with nvcc into _build/ once",
    "runtime.py:force_cpu_if_requested": "JAX platform selection; the port's entry points "
    "take device= and default to the card",
    "training/trainer.py:TrainState": "the flax/optax state pytree; the port's trainer holds "
    "the torch module and optimizer",
    "training/trainer.py:BrainTrainer.batch_sharding": "the NamedSharding a JAX loader puts a "
    "global batch under; a port rank cuts its rows itself (parallel.shard_batch)",
    **{f"utils/profiling.py:StageTimer{member}": "a wall-clock stage timer on no shared clock, "
       "which nothing called; the port's stages are profiling.span ranges, in the profiler's "
       "trace beside the kernels" for member in ("", ".stage", ".wrap", ".summary", ".dump", ".log")},
}


def _port_name(module: str, name: str) -> str:
    key = f"{module}:{name}"
    if key in RENAMED:
        return RENAMED[key]
    owner, _, member = name.partition(".")
    if member and f"{module}:{owner}" in RENAMED:
        return f"{RENAMED[f'{module}:{owner}']}.{member}"
    return name


def _public_names(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                          and not sub.name.startswith("_")]
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names += [elt.value for elt in node.value.elts]
    return list(dict.fromkeys(names))


def _modules() -> list[str]:
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _port_module(module: str):
    dotted = module.removesuffix(".py").removesuffix("/__init__").replace("/", ".")
    name = "algonauts2025_tpu_torch" if dotted == "__init__" else f"algonauts2025_tpu_torch.{dotted}"
    return importlib.import_module(name)


def _has(module, name: str) -> bool:
    obj = module
    for part in name.split("."):
        fields = getattr(obj, "model_fields", {}) if isinstance(obj, type) else {}
        if part in fields:
            return True
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("module", _modules())
def test_public_names_have_port_counterparts(module):
    port = _port_module(module)
    missing = []
    for name in _public_names(JAX / module):
        key = f"{module}:{name}"
        if key in JAX_ONLY:
            assert not _has(port, name), f"{key} is in JAX_ONLY, but the port has it"
            continue
        if key in RENAMED:
            assert not _has(port, name), f"{key} is in RENAMED, but the port has it"
        if not _has(port, _port_name(module, name)):
            missing.append(name)
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_tables_name_public_jax_names():
    """Every table entry is a public name of its JAX module."""
    for key in {**RENAMED, **JAX_ONLY}:
        module, name = key.split(":")
        assert name in _public_names(JAX / module), key
