"""int8 against bf16: the static-int8 ViT-G's features beside the exact
bf16 backbone's, on the card.

    python -m algonauts2025_tpu_torch.scripts.quant_parity [--seed N] [--out DIR]

The port's version of the JAX package's ``scripts/quant_parity.py``
(ACCURACY.md): one seeded 64-frame 256 x 256 window (pixels uniform in
[-1, 1), as normalised frames) goes through the bf16 V-JEPA2 ViT-G with
seeded full-size weights (``VJEPA2Backbone.init_random``), and through the
static-int8 backbone made from the same float weights: every dense
quantized per output column (``quantize_weight``), the activation scales
calibrated on the same window at margin 1.5 (``calibrate_quant_scales``),
then the calibrated static scales, which run kernel rows 6 and 7
(``int8_matmul_fused``, ``int8_mlp_fused``) on the card.  Both give the
token-pooled states of the L + 1 layers.  It prints the global Pearson r
over all of them, the worst per-layer r and the worst per-token cosine (a
row of a layer and a window), beside the card's name and power limit, and
the JSON of the numbers last; it exits non-zero below a global r of 0.999,
the bound ACCURACY.md sets for using the quantized path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.backbones.vjepa2 import VJEPA2_VITG, VJEPA2Backbone, VJEPA2Config
from ..ops.quant import calibrate_quant_scales, quantize_weight

__all__ = ["MIN_GLOBAL_R", "quantized_state", "static_int8_backbone", "agreement", "compare", "main"]

#: the global Pearson r the int8 features must reach (ACCURACY.md)
MIN_GLOBAL_R = 0.999
#: the calibration margin of the production feature (features/video.py)
MARGIN = 1.5


def quantized_state(float_state: dict[str, torch.Tensor], qmodel: VJEPA2Backbone) -> dict[str, torch.Tensor]:
    """The state dict of the quantized ``qmodel`` from a float backbone's:
    each ``nn.Linear`` weight (out, in) becomes the (in, out) int8
    ``kernel_q`` and its per-column ``scale`` (the JAX package's
    ``quantize_tree``), its bias stays, ``a_scale`` starts at 0 (the
    uncalibrated sentinel); the rest is copied."""
    out = {}
    for key, value in qmodel.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in ("kernel_q", "scale"):
            w_q, scale = quantize_weight(float_state[f"{prefix}.weight"].float().t())
            out[key] = w_q if leaf == "kernel_q" else scale
        elif leaf == "a_scale":
            out[key] = torch.zeros_like(value)
        else:
            out[key] = float_state[key].float()
    return out


def static_int8_backbone(cfg: VJEPA2Config, float_state: dict[str, torch.Tensor], pixels: torch.Tensor,
                         device) -> VJEPA2Backbone:
    """The static-int8 backbone of ``cfg`` from ``float_state``, its scales
    calibrated on ``pixels`` at margin 1.5."""
    qmodel = VJEPA2Backbone(dataclasses.replace(cfg, quantize=True), token_pool=True, device=device)
    qmodel.load_state_dict(quantized_state(float_state, qmodel))
    calibrate_quant_scales(qmodel, pixels, margin=MARGIN)
    return qmodel.set_quant_static()


def agreement(ref: np.ndarray, got: np.ndarray) -> dict[str, float]:
    """The global Pearson r of two (L + 1, B, D) feature stacks, the worst
    per-layer r and the worst per-token (layer, window) cosine."""
    a = ref.reshape(-1, ref.shape[-1]).astype(np.float64)
    b = got.reshape(-1, got.shape[-1]).astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    per_layer = [np.corrcoef(ref[i].ravel(), got[i].ravel())[0, 1] for i in range(ref.shape[0])]
    return {"global_r": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]), "min_layer_r": float(min(per_layer)),
            "min_token_cosine": float(cos.min())}


@torch.no_grad()
def compare(cfg: VJEPA2Config, float_state: dict[str, torch.Tensor], pixels: np.ndarray,
            device) -> dict[str, float]:
    """``agreement`` of the static-int8 backbone's token-pooled states with
    the float backbone's (``cfg.dtype``), both from ``float_state``, on
    ``pixels`` (B, T, H, W, 3)."""
    x = torch.from_numpy(pixels).to(device)
    model = VJEPA2Backbone(cfg, token_pool=True, device=device)
    model.load_state_dict({k: v.to(device) for k, v in float_state.items()})
    ref = model(x).float().cpu().numpy()
    del model
    qmodel = static_int8_backbone(cfg, {k: v.to(device) for k, v in float_state.items()}, x, device)
    got = qmodel(x).float().cpu().numpy()
    if ref.shape != got.shape or not (np.isfinite(ref).all() and np.isfinite(got).all()):
        raise SystemExit(f"quant_parity: features {ref.shape} and {got.shape}, or non-finite values")
    return agreement(ref, got)


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the weights and the window")
    parser.add_argument("--out", type=Path, help="directory for quant_parity.json")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_parity: CUDA is not available; this script needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = VJEPA2_VITG
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    float_state = VJEPA2Backbone(cfg, token_pool=True, device="cuda").init_random(gen).state_dict()
    rng = np.random.default_rng(args.seed)
    pixels = rng.uniform(-1, 1, (1, cfg.frames_per_clip, cfg.crop_size, cfg.crop_size, 3)).astype(np.float32)
    numbers = compare(cfg, float_state, pixels, "cuda")
    tokens = cfg.frames_per_clip // cfg.tubelet_size * (cfg.crop_size // cfg.patch_size) ** 2
    result = {"card": card, "seed": args.seed, "layers": cfg.num_layers, "tokens": tokens, **numbers,
              "min_global_r": MIN_GLOBAL_R}
    print(f"static int8 ViT-G against bf16 ({cfg.num_layers} layers, one {cfg.frames_per_clip} x {cfg.crop_size} x "
          f"{cfg.crop_size} window, {tokens} tokens, seed {args.seed}) on {card}: "
          f"global r {numbers['global_r']:.6f} (bound {MIN_GLOBAL_R}), worst per-layer r "
          f"{numbers['min_layer_r']:.6f}, worst per-token cosine {numbers['min_token_cosine']:.6f}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "quant_parity.json").write_text(line + "\n")
    print(line, flush=True)
    if not numbers["global_r"] >= MIN_GLOBAL_R:
        raise SystemExit(f"quant_parity: global r {numbers['global_r']:.6f} is below {MIN_GLOBAL_R}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
