"""Weight transfer from a flax param tree to the port's ``state_dict``.

The JAX trunk scans one block over depth, so its block params are stacked
``(depth, ...)`` leaves under ``blocks/block/``; they are unstacked into
``blocks.<i>.``.  Flax Dense kernels are ``(in, out)`` and become torch
Linear ``(out, in)`` weights.  Every leaf must map to a known name: an
unmatched leaf raises, and loading the result with ``strict=True`` catches
parameters the tree lacks.  ``vjepa2_params_to_torch`` does the same for
the V-JEPA2 video backbone, whose scanned layers sit under ``layers/``, and
``llama_params_to_torch`` for the Llama text backbone, likewise, and
``wav2vec_bert_params_to_torch`` for the w2v-BERT audio backbone, whose
scanned layers sit under ``layers/layer/``.  ``fmri_mlp_params_to_torch``
maps the FmriMlp's auto-named flax modules by its config.
"""

from __future__ import annotations

import itertools
import typing as tp

import numpy as np
import torch

__all__ = ["flax_params_to_torch", "fmri_mlp_params_to_torch", "vjepa2_params_to_torch",
           "llama_params_to_torch", "wav2vec_bert_params_to_torch"]

#: flax module names whose torch counterpart has the same name
_SAME = {
    "encoder", "blocks", "attn", "ff", "qkv", "out", "attn_norm", "ff_norm",
    "final_norm", "predictor", "subject_embed",
}
_RENAMED = {"Dense_0": "fc1", "Dense_1": "fc2"}
#: leaf name -> (torch name, transpose the last two axes)
_LEAVES = {
    "kernel": ("weight", True),
    "bias": ("bias", False),
    "g": ("g", False),
    "scale": ("weight", False),  # LayerNorm gain
    "embedding": ("weight", False),
    "weights": ("weights", False),
    "time_pos_embed": ("time_pos_embed", False),
    "res_scale_attn": ("res_scale_attn", False),
    "res_scale_ff": ("res_scale_ff", False),
}


def _flatten(tree: tp.Mapping[str, tp.Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, tp.Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _module_name(part: str) -> list[str]:
    if part.startswith("proj_"):
        return ["projectors", part[len("proj_"):]]
    if part.startswith("contrastive_"):
        return ["contrastive_heads", part[len("contrastive_"):]]
    if part in _RENAMED:
        return [_RENAMED[part]]
    if part in _SAME or part.isdigit():
        return [part]
    raise KeyError(part)


def _convert_leaf(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path
    if leaf not in _LEAVES:
        raise KeyError(leaf)
    name, transpose = _LEAVES[leaf]
    parts = [p for m in modules for p in _module_name(m)]
    if transpose:
        value = np.swapaxes(value, -1, -2)
    return ".".join(parts + [name]), value


def _unstack(path: tuple[str, ...], value: np.ndarray):
    """Leaves under ``blocks/block/`` hold (depth, ...) stacks -> blocks/<i>/."""
    for at in range(len(path) - 1):
        if path[at : at + 2] == ("blocks", "block"):
            return [
                (path[: at + 1] + (str(i),) + path[at + 2 :], value[i])
                for i in range(value.shape[0])
            ]
    return [(path, value)]


_VJEPA2_NORMS = {"norm1", "norm2", "final_norm"}
_VJEPA2_DENSES = {"query", "key", "value", "proj", "fc1", "fc2"}
#: leaf of a V-JEPA2 dense -> (torch name, transpose); float Dense or _QDense
_VJEPA2_DENSE_LEAVES = {
    "kernel": ("weight", True),
    "bias": ("bias", False),
    "kernel_q": ("kernel_q", False),
    "scale": ("scale", False),
    "a_scale": ("a_scale", False),
}


def _vjepa2_leaf(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path
    if not modules and leaf in ("patch_kernel", "patch_bias"):
        return leaf, value
    parent = modules[-1] if modules else None
    if parent in _VJEPA2_NORMS and leaf in ("scale", "bias"):
        name, transpose = ("weight" if leaf == "scale" else "bias"), False
    elif parent in _VJEPA2_DENSES and leaf in _VJEPA2_DENSE_LEAVES:
        name, transpose = _VJEPA2_DENSE_LEAVES[leaf]
    else:
        raise KeyError(leaf)
    if transpose:
        value = np.swapaxes(value, -1, -2)
    return ".".join(modules + [name]), value


def vjepa2_params_to_torch(params: tp.Mapping[str, tp.Any]) -> dict[str, torch.Tensor]:
    """The JAX VJEPA2Backbone's ``params`` -> the port's VJEPA2Backbone state_dict.

    ``layers/...`` leaves hold (num_layers, ...) stacks from ``nn.scan`` and
    become ``layers.<i>....``.  int8 ``kernel_q`` stays int8; every other
    leaf becomes float32 (exact for bf16 and fp32 leaves)."""
    out: dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        items = [(path, value)]
        if path[0] == "layers":
            items = [(("layers", str(i)) + path[1:], value[i]) for i in range(value.shape[0])]
        try:
            converted = [_vjepa2_leaf(p, v) for p, v in items]
        except KeyError:
            unmatched.append("/".join(path))
            continue
        for name, array in converted:
            dtype = np.int8 if array.dtype == np.int8 else np.float32
            out[name] = torch.tensor(np.asarray(array, dtype=dtype))
    if unmatched:
        raise KeyError(f"flax leaves with no torch counterpart: {unmatched}")
    return out


_LLAMA_NORMS = {"input_norm", "post_norm", "final_norm"}
_LLAMA_DENSES = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}


def _llama_leaf(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path
    parent = modules[-1] if modules else None
    if parent == "embed_tokens" and leaf == "embedding":
        return "embed_tokens.weight", value
    if parent in _LLAMA_NORMS and leaf == "weight":
        return ".".join(modules + ["weight"]), value
    if parent in _LLAMA_DENSES and leaf == "kernel":
        return ".".join(modules + ["weight"]), np.swapaxes(value, -1, -2)
    raise KeyError(leaf)


def llama_params_to_torch(params: tp.Mapping[str, tp.Any]) -> dict[str, torch.Tensor]:
    """The JAX LlamaBackbone's ``params`` -> the port's LlamaBackbone state_dict.

    ``layers/...`` leaves hold (num_layers, ...) stacks from ``nn.scan`` and
    become ``layers.<i>....``; Dense kernels (in, out) become Linear weights
    (out, in).  Every leaf becomes float32 (exact for bf16 and fp32 leaves)."""
    out: dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        items = [(path, value)]
        if path[0] == "layers":
            items = [(("layers", str(i)) + path[1:], value[i]) for i in range(value.shape[0])]
        try:
            converted = [_llama_leaf(p, v) for p, v in items]
        except KeyError:
            unmatched.append("/".join(path))
            continue
        for name, array in converted:
            out[name] = torch.tensor(np.asarray(array, dtype=np.float32))
    if unmatched:
        raise KeyError(f"flax leaves with no torch counterpart: {unmatched}")
    return out


_W2V_DENSES = {
    "fp_projection", "intermediate_dense", "output_dense", "linear_q", "linear_k", "linear_v",
    "linear_out", "pointwise_conv1", "pointwise_conv2",
}


def _w2v_leaf(path: tuple[str, ...], value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path
    parent = modules[-1] if modules else None
    if parent is not None and parent.endswith("layer_norm") and leaf in ("scale", "bias"):
        return ".".join(modules + ["weight" if leaf == "scale" else "bias"]), value
    if parent in _W2V_DENSES and leaf == "kernel":
        return ".".join(modules + ["weight"]), np.swapaxes(value, -1, -2)
    if parent in _W2V_DENSES and leaf == "bias":
        return ".".join(modules + ["bias"]), value
    if parent == "depthwise_conv" and leaf == "kernel":  # flax (K, 1, H) -> torch (H, 1, K)
        return ".".join(modules + ["weight"]), np.transpose(value, (2, 1, 0))
    if parent == "self_attn" and leaf == "distance_embedding":
        return ".".join(modules + ["distance_embedding"]), value
    raise KeyError(leaf)


def wav2vec_bert_params_to_torch(params: tp.Mapping[str, tp.Any]) -> dict[str, torch.Tensor]:
    """The JAX Wav2VecBertBackbone's ``params`` -> the port's state_dict.

    ``layers/layer/...`` leaves hold (num_layers, ...) stacks from
    ``nn.scan`` and become ``layers.<i>....``; Dense kernels (in, out)
    become Linear weights (out, in), the pointwise convs included; the
    depthwise kernel (K, 1, H) becomes the Conv1d weight (H, 1, K).  Every
    leaf becomes float32 (exact for bf16 and fp32 leaves; the LayerNorms
    and distance tables stay float32 in the module)."""
    out: dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        items = [(path, value)]
        if path[:2] == ("layers", "layer"):
            items = [(("layers", str(i)) + path[2:], value[i]) for i in range(value.shape[0])]
        try:
            converted = [_w2v_leaf(p, v) for p, v in items]
        except KeyError:
            unmatched.append("/".join(path))
            continue
        for name, array in converted:
            out[name] = torch.tensor(np.asarray(array, dtype=np.float32))
    if unmatched:
        raise KeyError(f"flax leaves with no torch counterpart: {unmatched}")
    return out


def flax_params_to_torch(params: tp.Mapping[str, tp.Any]) -> dict[str, torch.Tensor]:
    """Flax ``params`` (nested dicts of arrays) -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        try:
            items = [_convert_leaf(p, v) for p, v in _unstack(path, value)]
        except KeyError:
            unmatched.append("/".join(path))
            continue
        for name, array in items:
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = torch.tensor(np.asarray(array, dtype=np.float32))
    if unmatched:
        raise KeyError(f"flax leaves with no torch counterpart: {unmatched}")
    return out


def _fmri_mlp_modules(config: tp.Any) -> dict[str, str]:
    """flax module name -> port module name, in the JAX FmriMlp's creation
    order (its Dense_<i> and _ActNorm_<i> numbers follow the config)."""
    cfg = config
    dense = (f"Dense_{i}" for i in itertools.count())
    act_norm = (f"_ActNorm_{i}/LayerNorm_0" for i in itertools.count())
    names = {}
    if cfg.time_agg == "in_linear":
        names[next(dense)] = "time_in"
    if cfg.subject_layers:
        names["SubjectLayers_0"] = "subject_layers"
    if cfg.use_tr_embeds:
        names["Embed_0"] = "tr_embed"
    if not cfg.use_tr_layer:
        names[next(dense)] = "input"
    names[next(act_norm)] = "norm_in.norm"
    for i in range(cfg.n_blocks):
        names[next(dense)] = f"blocks.{i}.dense"
        names[next(act_norm)] = f"blocks.{i}.act_norm.norm"
    if cfg.time_agg == "out_linear":
        names[next(dense)] = "time_out"
    names[next(dense)] = "output"
    heads = cfg.output_head_config
    prefixes = [f"heads.{name}" for name in heads] if isinstance(heads, dict) else ["head"]
    if heads is not None:
        names.update({f"Mlp_{i}": prefix for i, prefix in enumerate(prefixes)})
    return names


#: leaves inside an Mlp head: flax module kind -> port list
_MLP_PARTS = {"Dense": "layers", "LayerNorm": "norms", "PReLU": "prelus"}


def fmri_mlp_params_to_torch(params: tp.Mapping[str, tp.Any],
                             config: tp.Any) -> dict[str, torch.Tensor]:
    """The JAX FmriMlp's ``params`` -> the port's FmriMlp state_dict, for the
    ``FmriMlpConfig`` both were built from.  Dense kernels (in, out) become
    Linear weights (out, in); ``tr_weights`` (T, C, H) keeps its layout."""
    modules = _fmri_mlp_modules(config)
    out: dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        *parents, leaf = path
        module = "/".join(parents)
        head = modules.get(parents[0]) if parents and parents[0].startswith("Mlp_") else None
        if not parents and leaf in ("tr_weights", "tr_bias"):
            name = leaf
        elif head is not None and len(parents) == 2 and parents[1].rsplit("_", 1)[0] in _MLP_PARTS:
            kind, index = parents[1].rsplit("_", 1)
            leaf_name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            name = f"{head}.{_MLP_PARTS[kind]}.{index}.{leaf_name}"
            value = np.swapaxes(value, -1, -2) if leaf == "kernel" else value
        elif module in modules and leaf in ("kernel", "bias", "scale", "embedding", "weights"):
            leaf_name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
            name = f"{modules[module]}.{leaf_name}"
            value = np.swapaxes(value, -1, -2) if leaf == "kernel" else value
        else:
            unmatched.append("/".join(path))
            continue
        out[name] = torch.tensor(np.asarray(value, dtype=np.float32))
    if unmatched:
        raise KeyError(f"flax leaves with no torch counterpart: {unmatched}")
    return out
