"""Plain PyTorch reference of the static-int8 V-JEPA 2 ViT-G window encoder.

``facebook/vjepa2-vitg-fpc64-256`` (V-JEPA 2, arXiv:2506.09985) as the
``VJEPA2`` feature runs it: frames resized as the HF video processor does
(shortest edge to int(crop * 256 / 224), antialiased bilinear, centre crop,
ImageNet normalisation), tubelet patch embedding (2 x 16 x 16) with bf16
operands, then pre-LayerNorm blocks with bf16 activations: w8a8 int8 denses
(weights int8 per output column, activations int8 by one static scale a
dense, calibrated from the absmax of a dynamic-int8 forward of a fixed
input, times 1.5), the 3D rotary on q and k, softmax attention over bf16 q,
k, v (the probabilities rounded to bf16 before their product with v), a
gelu MLP whose hidden state is quantised by fc2's static scale; the token
mean of each layer's output, the last one after the final LayerNorm, and
the first block's attention output before its projection.

Each int8 product is exact (float64 sums of int8 values), attention is in
float32 with TF32 off, the gelu is erf's.  The controls are one stated
precision a step lower each: ``attention="fp8"``, q, k, v and the
probabilities in float8 e4m3, the step a faster attention would take
(``Encoder._attend``); ``int_max=7``, the denses in int4.  The weights
come from the seed as float (``make_weights``, in the HF checkpoint's
layout); this module quantises and calibrates them itself and imports
nothing of the program.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..common.seeds import Spec, derive, seeded_tensors

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DENSES = ("attention.query", "attention.key", "attention.value", "attention.proj", "mlp.fc1", "mlp.fc2")


def mlp_dim(cfg: dict) -> int:
    return int(cfg["hidden_size"] * cfg["mlp_ratio"])


def weight_spec(cfg: dict) -> Spec:
    """The encoder's float weights in the HF checkpoint's names and layout:
    N(0, 1/fan_in) kernels, zero biases, unit LayerNorm gains."""
    d, f = cfg["hidden_size"], mlp_dim(cfg)
    patch = cfg["tubelet_size"] * cfg["patch_size"] ** 2 * 3
    spec: Spec = [("encoder.embeddings.patch_embeddings.proj.weight",
                   (d, 3, cfg["tubelet_size"], cfg["patch_size"], cfg["patch_size"]), ("normal", patch ** -0.5)),
                  ("encoder.embeddings.patch_embeddings.proj.bias", (d,), ("zeros",))]
    shapes = {"attention.query": (d, d), "attention.key": (d, d), "attention.value": (d, d),
              "attention.proj": (d, d), "mlp.fc1": (f, d), "mlp.fc2": (d, f)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for norm in ("norm1", "norm2"):
            spec += [(p + norm + ".weight", (d,), ("ones",)), (p + norm + ".bias", (d,), ("zeros",))]
        for name in DENSES:
            out, n_in = shapes[name]
            spec += [(p + name + ".weight", (out, n_in), ("normal", n_in ** -0.5)),
                     (p + name + ".bias", (out,), ("zeros",))]
    spec += [("encoder.layernorm.weight", (d,), ("ones",)), ("encoder.layernorm.bias", (d,), ("zeros",))]
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return seeded_tensors(weight_spec(cfg), derive(seed, "weights"), device)


def make_windows(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of seeded uint8 windows (n, frames, H, W, 3), made on the device."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "windows"))
    shape = (traffic["pool_windows"], cfg["frames_per_clip"], traffic["frame_height"], traffic["frame_width"], 3)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


# -- the calibration input: jax.random.normal(PRNGKey(seed), shape) ----------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) over uint32 words held in int64 tensors."""
    ks = [k1, k2, k1 ^ k2 ^ 0x1BD11BDA]
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & _M32) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def jax_normal(seed: int, shape: tuple[int, ...], device) -> torch.Tensor:
    """JAX's default normals of ``PRNGKey(seed)``: the partitionable
    threefry bits of a counter, the exact uniform in [nextafter(-1, 0), 1),
    sqrt(2) erfinv (torch's erfinv, within float32 rounding of XLA's)."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(seed >> 32 & _M32, seed & _M32, counts >> 32, counts & _M32)
    floats = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = torch.clamp_min(floats * (1.0 - lo) + lo, lo)
    return (math.sqrt(2.0) * torch.erfinv(u)).reshape(shape)


# -- the model ----------------------------------------------------------------

def preprocess(frames: torch.Tensor, crop: int) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, crop, crop, 3) normalised float32."""
    t, h, w, _ = frames.shape
    resize = int(crop * 256 / 224)
    size = (resize, int(resize * w / h)) if h <= w else (int(resize * h / w), resize)
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=size, mode="bilinear", antialias=True,
                      align_corners=False)
    top, left = int(round((size[0] - crop) / 2.0)), int(round((size[1] - crop) / 2.0))
    x = x[:, :, top:top + crop, left:left + crop].permute(0, 2, 3, 1) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _rope_tables(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, head_dim) cos and sin of the 3D rotary: the head's first three
    equal even segments rotate with the frame, row and column of the
    token (frequencies 10000^(-2i/seg)), tiled over each segment; the tail
    is left alone."""
    grid = cfg["crop_size"] // cfg["patch_size"]
    n = cfg["frames_per_clip"] // cfg["tubelet_size"] * grid * grid
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    ids = np.arange(n)
    positions = (ids // (grid * grid), ids % (grid * grid) // grid, ids % grid)
    seg = 2 * ((hd // 3) // 2)
    cos, sin = np.ones((n, hd), np.float32), np.zeros((n, hd), np.float32)
    omega = 1.0 / 10000 ** (np.arange(seg // 2, dtype=np.float32) / (seg / 2.0))
    for which, pos in enumerate(positions):
        freq = pos[:, None].astype(np.float32) * omega
        cos[:, which * seg:(which + 1) * seg] = np.tile(np.cos(freq), (1, 2))
        sin[:, which * seg:(which + 1) * seg] = np.tile(np.sin(freq), (1, 2))
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin), in float32."""
    x = x.float()
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + turned * sin


def _layer_norm(x: torch.Tensor, w: dict, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], w[name + ".weight"], w[name + ".bias"], eps)


def _to_fp8(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per slice over ``dims``."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Encoder:
    """The encoder over quantised weights: ``states(pixels)`` gives the
    (L+1, D) token means of one window's normalised pixels."""

    def __init__(self, cfg: dict, weights: dict[str, torch.Tensor], attention: str = "bf16",
                 int_max: int = 127) -> None:
        self.cfg, self.attention, self.int_max = cfg, attention, int_max
        self.eps = cfg["layer_norm_eps"]
        w = {}
        for name, value in weights.items():
            layer_dense = name.rsplit(".", 1)[0]
            if name.endswith(".weight") and layer_dense.split(".", 3)[-1] in DENSES:
                scale = (value.abs().amax(dim=1) / int_max).clamp_min(1e-12)  # per output column
                w[layer_dense + ".q"] = torch.clamp(torch.round(value / scale[:, None]), -int_max, int_max).to(torch.int8)
                w[layer_dense + ".scale"] = scale
            else:
                w[name] = value
        self.w = w
        self.a_scale: dict[str, float] | None = None
        self.first_attention: torch.Tensor | None = None
        self.rope = _rope_tables(cfg, next(iter(weights.values())).device)

    # the int8 denses: static (calibrated) or, while calibrating, dynamic
    def _dense(self, x: torch.Tensor, name: str, observed: dict | None) -> torch.Tensor:
        """float32 (N, K) -> float32 (N, out): int8 x int8 summed exactly,
        dequantised with the activation and weight scales, plus the bias."""
        if observed is not None:
            observed[name] = max(observed.get(name, 0.0), float(x.abs().amax()))
            sx = (x.abs().amax(dim=-1, keepdim=True) / self.int_max).clamp_min(1e-12)
        else:
            sx = torch.tensor(self.a_scale[name], device=x.device)
        xq = torch.clamp(torch.round(x / sx), -self.int_max, self.int_max)
        acc = (xq.double() @ self.w[name + ".q"].double().T).float()
        return acc * (sx * self.w[name + ".scale"]) + self.w[name + ".bias"]

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(H, N, hd) bf16-valued q, k, v -> (H, N, hd) float32, a few heads
        at a time: softmax(q k^T / sqrt(hd)) v with the probabilities rounded
        to bf16 before their product with v.  The fp8 control takes q, k and
        v through e4m3 (a scale a head), and the unnormalised probabilities
        exp(s - row max), which lie in (0, 1], through e4m3 as they are,
        dividing by their float32 row sum after the product (as an fp8
        flash kernel does)."""
        out = torch.empty_like(q)
        for h in range(0, q.shape[0], 8):
            qs, ks, vs = q[h:h + 8], k[h:h + 8], v[h:h + 8]
            if self.attention == "fp8":
                qs, ks, vs = (_to_fp8(t, (1, 2)) for t in (qs, ks, vs))
                scores = qs @ ks.transpose(1, 2) * qs.shape[-1] ** -0.5
                p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
                out[h:h + 8] = (p.to(torch.float8_e4m3fn).float() @ vs) / p.sum(dim=-1, keepdim=True)
            else:
                probs = torch.softmax(qs @ ks.transpose(1, 2) * qs.shape[-1] ** -0.5, dim=-1)
                out[h:h + 8] = probs.to(torch.bfloat16).float() @ vs
        return out

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(T, crop, crop, 3) -> (N, D) tokens: each tubelet's pixels (in
        (t, y, x, channel) order) times the conv kernel, bf16 operands and
        float32 sums."""
        w, cfg = self.w, self.cfg
        ts, ps = cfg["tubelet_size"], cfg["patch_size"]
        t, h, wd, c = pixels.shape
        x = pixels.to(torch.bfloat16).float().reshape(t // ts, ts, h // ps, ps, wd // ps, ps, c)
        x = x.permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, ts * ps * ps * c)
        kernel = w["encoder.embeddings.patch_embeddings.proj.weight"].to(torch.bfloat16).float()
        kernel = kernel.permute(2, 3, 4, 1, 0).reshape(-1, kernel.shape[0])
        return (x @ kernel + w["encoder.embeddings.patch_embeddings.proj.bias"]).to(torch.bfloat16)

    def states(self, pixels: torch.Tensor, observed: dict | None = None) -> torch.Tensor:
        cfg, w, bf = self.cfg, self.w, torch.bfloat16
        h = cfg["num_attention_heads"]
        x = self._embed(pixels)
        n, d = x.shape
        out = [x.float().mean(0)]
        cos, sin = self.rope
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layer.{i}."
            a = _layer_norm(x, w, p + "norm1", self.eps).to(bf).float()
            qkv = [self._dense(a, p + "attention." + m, observed).to(bf) for m in ("query", "key", "value")]
            q, k, v = (t.float().reshape(n, h, -1).transpose(0, 1) for t in qkv)
            q, k = (_rotate(t, cos, sin).to(bf).float() for t in (q, k))
            attn = self._attend(q, k, v).to(bf).float().transpose(0, 1).reshape(n, d)
            if i == 0:
                self.first_attention = attn  # the first block's projection input
            x = x + self._dense(attn, p + "attention.proj", observed).to(bf)
            a = _layer_norm(x, w, p + "norm2", self.eps).to(bf).float()
            hidden = self._dense(a, p + "mlp.fc1", observed)
            if observed is not None:  # the calibration forward: a bf16 hidden state
                hidden = F.gelu(hidden.to(bf)).float()
            else:
                hidden = F.gelu(hidden)
            x = x + self._dense(hidden, p + "mlp.fc2", observed).to(bf)
            out.append(x.float().mean(0))
        out[-1] = _layer_norm(x, w, "encoder.layernorm", self.eps).mean(0)
        return torch.stack(out)

    def calibrate(self, margin: float) -> None:
        """Static scales from one dynamic-int8 forward of JAX's normals of
        PRNGKey(7), taken as normalised pixels: absmax x margin / 127."""
        cfg = self.cfg
        sample = jax_normal(7, (cfg["frames_per_clip"], cfg["crop_size"], cfg["crop_size"], 3),
                            self.rope[0].device)
        observed: dict[str, float] = {}
        self.states(sample, observed)
        self.a_scale = {name: max(m * margin / self.int_max, 1e-12) for name, m in observed.items()}


def sample_tokens(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` token indices of a window, drawn from the seed, in order."""
    grid = cfg["crop_size"] // cfg["patch_size"]
    n = cfg["frames_per_clip"] // cfg["tubelet_size"] * grid * grid
    gen = torch.Generator(device="cpu").manual_seed(derive(seed, "tokens"))
    return torch.randperm(n, generator=gen)[:min(count, n)].sort().values.to(device)


@torch.no_grad()
def window_states(cfg: dict, seed: int, windows: tp.Sequence[torch.Tensor], attention: str = "bf16",
                  int_max: int = 127, tf32: bool = False,
                  tokens: torch.Tensor | None = None) -> list[torch.Tensor] | list[tuple[torch.Tensor, torch.Tensor]]:
    """The (L+1, D) states of each uint8 window, computed from the seed's
    weights; with ``tokens``, each beside the first block's attention output
    (the input of its projection, (len(tokens), D)) at those tokens."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        device = windows[0].device
        encoder = Encoder(cfg, make_weights(cfg, seed, device), attention=attention, int_max=int_max)
        encoder.calibrate(cfg["calibration_margin"])
        out = []
        for win in windows:
            states = encoder.states(preprocess(win, cfg["crop_size"]))
            out.append(states if tokens is None else (states, encoder.first_attention[tokens].clone()))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gaps(got: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The relative L2 gaps of one window's (L+1, D) token-mean states:
    ``state_gap``, the largest over the layers; ``first_block_gap``, the
    first block's (layer 1), before 39 more blocks of int8 requantisation
    have compounded the float rounding of both sides."""
    got, ref = got.double(), ref.double()
    per_layer = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    return {"state_gap": float(per_layer.max()), "first_block_gap": float(per_layer[1])}


def attention_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The relative L2 gap of the first block's attention output of one
    window at the sampled tokens: per token, before any pooling, where a
    lower attention precision shows that the token means average away."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm())
