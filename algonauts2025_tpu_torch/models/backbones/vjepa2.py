"""V-JEPA2 video ViT backbone (torch.nn) for frozen video features.

The port of algonauts2025_tpu/models/backbones/vjepa2.py: 3D tubelet patch
embedding (tubelet 2 x patch 16) as a patchify + one fp32-accumulated
matmul, pre-LN ViT blocks with the V-JEPA 3D rotary attention
(frame/height/width thirds of each head rotated independently, tiled
cos/sin, interleaved pairs), a GELU MLP and a final LayerNorm.  Returns
the (L+1, B, N, D) hidden-state stack, or with ``token_pool`` the
(L+1, B, D) token means; the last entry is final-normed (HF parity).

The dtype casts are the JAX package's: bf16 activations, fp32 rotary,
LayerNorm statistics in fp32 with a bf16 output inside the blocks and an
fp32 output from the final norm.  With ``quantize`` the denses are w8a8
int8 (``_QDense``).  With ``sequence_parallel_axis`` the window's tokens
split over the shards of a ``LocalMesh`` (``forward(pixels, mesh=)``):
ring attention (parallel/sequence.py) takes the attention's place, the
rotary tables are sliced at each shard's global token offset, and the
token means are averaged over the shards.  On a CUDA card the calibrated
static-scale denses, the whole MLP and the attention over >= 1024 tokens
run the hand-written kernels of ops/quant.py and ops/flash_attention.py
wherever the JAX package runs its Pallas kernels on a TPU, and the query
and key denses' kernel applies the fp32 rotary in its epilogue (bit for
bit ``_apply_rope`` of its bf16 output); elsewhere (and on the CPU) the
plain ops run, as the JAX package's XLA path does.  The
scanned ``(L, ...)`` params of the JAX package are one module per layer
here (``models.convert.vjepa2_params_to_torch`` unstacks them).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import typing as tp
import weakref

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.flash_attention import flash_attention
from ...ops.quant import int8_matmul, int8_matmul_fused, int8_mlp_fused, quantize_dense_params
from ...parallel.sequence import ring_attention_local
from ...utils.profiling import span

__all__ = ["VJEPA2Config", "VJEPA2Backbone", "VJEPA2Block", "VJEPA2Attention",
           "params_from_hf", "VJEPA2_VITG"]


@dataclasses.dataclass(frozen=True)
class VJEPA2Config:
    crop_size: int = 256
    patch_size: int = 16
    tubelet_size: int = 2
    frames_per_clip: int = 64
    hidden_size: int = 1408
    num_layers: int = 40
    num_heads: int = 22
    mlp_ratio: float = 48 / 11
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    #: w8a8 int8 denses for qkv/proj/mlp
    quantize: bool = False
    #: with quantize: calibrated static activation scales instead of dynamic
    #: per-row maxima (requires ops.quant.calibrate_quant_scales first)
    quant_static: bool = False
    #: sequence parallelism: the token axis splits over the shards of a
    #: ``LocalMesh`` with this axis name (ring attention)
    sequence_parallel_axis: str | None = None

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


VJEPA2_VITG = VJEPA2Config()


class _QDense(nn.Module):
    """Dense over pre-quantized int8 weights + per-column scales (buffers).

    ``static_scale`` uses the calibrated activation scale ``a_scale``; on a
    CUDA card, with 128-aligned dims, that runs the fused w8a8 kernel
    (``runs_kernel``), which can also rotate the output (``rope``).
    While ``observing`` (set by ``calibrate_quant_scales``) every call
    records its input absmax in ``absmax`` and quantizes dynamically.
    ``kernel_q_kmajor`` gives the K-major copy that both fused kernels
    read (not a buffer: it is rebuilt from ``kernel_q`` whenever that
    changes)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 static_scale: bool = False, device=None) -> None:
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.static_scale = static_scale
        self.observing = False
        self.absmax: torch.Tensor | None = None
        self.register_buffer("kernel_q", torch.zeros((in_features, features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.full((features,), 0.01, device=device))
        self.register_buffer("a_scale", torch.zeros((), device=device))
        self.register_buffer("bias", torch.zeros(features, device=device) if use_bias else None)
        self._kmajor: torch.Tensor | None = None
        self._kmajor_of: tuple | None = None

    def kernel_q_kmajor(self) -> torch.Tensor:
        """``kernel_q.T`` as a contiguous (features, in_features) int8 copy,
        the layout in which wgmma reads an 8-bit B operand.  Made once and
        kept; made again when ``kernel_q`` is another tensor (``to``,
        ``cuda``), has other storage, or was written in place (``copy_`` in
        ``init_random`` or ``load_state_dict`` raises its version)."""
        w = self.kernel_q
        key = (weakref.ref(w), w._version, w.data_ptr(), w.device)
        held = self._kmajor_of
        if held is None or held[0]() is not w or held[1:] != key[1:]:
            self._kmajor, self._kmajor_of = w.t().contiguous(), key
        return self._kmajor

    def observe(self, x: torch.Tensor) -> None:
        if self.observing:
            m = x.detach().float().abs().amax()
            self.absmax = m if self.absmax is None else torch.maximum(self.absmax, m)

    def runs_kernel(self, x: torch.Tensor) -> bool:
        """Whether ``forward(x)`` runs the fused w8a8 kernel: a calibrated
        static scale, not observing, 128-aligned dims and a CUDA input."""
        aligned = self.in_features % 128 == 0 and self.features % 128 == 0
        return self.static_scale and not self.observing and aligned and x.is_cuda

    def forward(self, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        """The dense of x; with ``rope`` (only where ``runs_kernel(x)``), its
        heads rotated in the kernel's epilogue."""
        self.observe(x)
        if self.runs_kernel(x):
            return int8_matmul_fused(x, self.kernel_q, self.scale, self.a_scale, bias=self.bias,
                                     out_dtype=x.dtype, w_kmajor=self.kernel_q_kmajor(), rope=rope)
        calibrated = self.static_scale and not self.observing
        y = int8_matmul(x, self.kernel_q, self.scale, x_scale=self.a_scale if calibrated else None)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def _dense(cfg: VJEPA2Config, in_features: int, features: int, device) -> nn.Module:
    if cfg.quantize:
        return _QDense(in_features, features, static_scale=cfg.quant_static, device=device)
    return nn.Linear(in_features, features, dtype=cfg.dtype, device=device)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax LayerNorm: statistics and affine in fp32, the output in ``dtype``."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


@functools.lru_cache(maxsize=8)
def _rope_tables(n: int, head_dim: int, crop_size: int, patch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Full-width (N, head_dim) cos/sin tables for the V-JEPA 3D rotary.

    The head dim splits into (frame, height, width) thirds rotated against
    their own position id, plus an identity tail (cos=1, sin=0).  Within a
    segment the cos/sin values are tiled (not interleaved) across lanes
    while the rotation pairs are interleaved."""
    grid = crop_size // patch_size
    tokens_per_frame = grid * grid
    ids = np.arange(n)
    frame_ids = ids // tokens_per_frame
    rem = ids - frame_ids * tokens_per_frame
    height_ids = rem // grid
    width_ids = rem - height_ids * grid

    seg = int(2 * ((head_dim // 3) // 2))
    cos = np.ones((n, head_dim), np.float32)
    sin = np.zeros((n, head_dim), np.float32)
    for which, pos in enumerate((frame_ids, height_ids, width_ids)):
        omega = np.arange(seg // 2, dtype=np.float32) / (seg / 2.0)
        omega = 1.0 / 10000**omega
        freq = pos[:, None].astype(np.float32) * omega  # (N, seg/2)
        lo = which * seg
        cos[:, lo : lo + seg] = np.tile(np.cos(freq), (1, 2))
        sin[:, lo : lo + seg] = np.tile(np.sin(freq), (1, 2))
    return cos, sin


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, N, D); cos/sin: (N, D) fp32.  One fused rotation in fp32;
    the identity tail (cos=1, sin=0) makes the global expression exact.
    The plain rotary: where the query and key denses run the w8a8 kernel,
    its epilogue computes this bit for bit instead (``project``)."""
    x32 = x.float()
    pair = x32.reshape(*x32.shape[:-1], x32.shape[-1] // 2, 2)
    rot = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).reshape(x32.shape)
    return (x32 * cos + rot * sin).to(x.dtype)


def _pick_block(t: int, preferred: int) -> int:
    for b in (preferred, 512, 256, 128):
        if b <= t and t % b == 0:
            return b
    return 0


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The long-sequence kernel on the card where the JAX package runs its
    flash kernel on a TPU (T >= 1024 with blocks that divide T); the plain
    attention elsewhere."""
    t = q.shape[-2]
    if q.is_cuda and _pick_block(t, 512) and _pick_block(t, 1024) and t >= 1024:
        return flash_attention(q, k, v)
    return dot_product_attention(q, k, v)


def _token_mean(x: torch.Tensor) -> torch.Tensor:
    """fp32 mean over the token axis (axis 1 of (B, N, D))."""
    return x.float().mean(dim=1)


class VJEPA2Attention(nn.Module):
    def __init__(self, cfg: VJEPA2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = _dense(cfg, d, d, device)
        self.key = _dense(cfg, d, d, device)
        self.value = _dense(cfg, d, d, device)
        self.proj = _dense(cfg, d, d, device)

    def _rotates_in_kernel(self, x: torch.Tensor, hd: int) -> bool:
        """Whether the query and key denses of x run the w8a8 kernel with
        the rotary in its epilogue: both take the kernel, the output is
        bf16, and the heads' lanes are even and divide its 128-wide tiles."""
        dense = (self.query, self.key)
        return (x.dtype == torch.bfloat16 and hd % 2 == 0 and 128 % hd == 0
                and all(isinstance(m, _QDense) and m.runs_kernel(x) for m in dense))

    def project(self, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]):
        """(B, H, N, hd) q, k (rotated) and v of the (B, N, d) input.  Where
        the query and key denses run the w8a8 kernel, its epilogue rotates
        them; elsewhere ``_apply_rope`` does."""
        b, n, d = x.shape
        h = self.cfg.num_heads
        hd = d // h

        def heads(y: torch.Tensor) -> torch.Tensor:
            """The head-split view (B, H, N, hd) of a (B, N, d) projection."""
            return y.reshape(b, n, h, hd).transpose(1, 2)

        if self._rotates_in_kernel(x, hd):
            # the kernel's (B N, d) output rows are tokens m % N of the tables
            return heads(self.query(x, rope)), heads(self.key(x, rope)), heads(self.value(x))
        q, k, v = (heads(m(x)) for m in (self.query, self.key, self.value))
        cos, sin = rope
        return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v

    def output(self, out: torch.Tensor) -> torch.Tensor:
        """The projection of the (B, H, N, hd) attention output."""
        b, h, n, hd = out.shape
        return self.proj(out.transpose(1, 2).reshape(b, n, h * hd))

    def forward(self, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return self.output(_attention(*self.project(x, rope)))


class VJEPA2Block(nn.Module):
    """Pre-LN ViT block."""

    def __init__(self, cfg: VJEPA2Config, token_pool: bool = False, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_pool = token_pool
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.attn = VJEPA2Attention(cfg, device=device)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.fc1 = _dense(cfg, d, cfg.mlp_dim, device)
        self.fc2 = _dense(cfg, cfg.mlp_dim, d, device)

    def _fused_mlp_ok(self, x: torch.Tensor) -> bool:
        fc1 = self.fc1
        return (
            isinstance(fc1, _QDense)
            and fc1.static_scale
            and x.is_cuda
            and not fc1.observing
            and self.cfg.hidden_size % 128 == 0
            and self.cfg.mlp_dim % 128 == 0
        )

    def forward(self, x: torch.Tensor, rope) -> tuple[torch.Tensor, torch.Tensor]:
        with span("vit.attention"):
            x = x + self.attn(_layer_norm(x, self.norm1, self.cfg.dtype), rope)
        with span("vit.mlp"):
            return self.mlp_residual(x)

    def mlp_residual(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x + MLP(norm2(x)), and the layer's state (the fp32 token mean
        with ``token_pool``, else x in fp32)."""
        dt = self.cfg.dtype
        h = _layer_norm(x, self.norm2, dt)
        if self._fused_mlp_ok(h):
            # whole-MLP kernel: both quantizations inside, no fp32 hidden
            # state in device memory
            fc1, fc2 = self.fc1, self.fc2
            h = int8_mlp_fused(h, fc1.kernel_q, fc1.scale, fc1.bias, fc2.kernel_q, fc2.scale,
                               fc2.bias, fc1.a_scale, fc2.a_scale, out_dtype=h.dtype,
                               w1_kmajor=fc1.kernel_q_kmajor(), w2_kmajor=fc2.kernel_q_kmajor())
        else:
            h = self.fc2(F.gelu(self.fc1(h)))
        x = x + h
        if self.token_pool:
            return x, _token_mean(x)
        return x, x.float()


class VJEPA2Backbone(nn.Module):
    """Frozen encoder; input (B, T, H, W, 3) normalized pixels."""

    def __init__(self, cfg: VJEPA2Config, token_pool: bool = False, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_pool = token_pool
        c = 3
        patch_dim = cfg.tubelet_size * cfg.patch_size**2 * c
        self.patch_kernel = nn.Parameter(torch.zeros((patch_dim, cfg.hidden_size), device=device))
        self.patch_bias = nn.Parameter(torch.zeros(cfg.hidden_size, device=device))
        self.layers = nn.ModuleList(
            VJEPA2Block(cfg, token_pool=token_pool, device=device) for _ in range(cfg.num_layers)
        )
        self.final_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        #: device -> a copy of this backbone there (the shards of a
        #: LocalMesh on other devices than this one's); not submodules
        self._replicas: dict[torch.device, VJEPA2Backbone] = {}

    @torch.no_grad()
    def init_random(self, generator: torch.Generator | None = None) -> "VJEPA2Backbone":
        """Random weights after the JAX package's init scheme: variance
        1/fan_in normals for the patch kernel and float denses, uniform int8
        quantized denses with scale 0.01, zero biases, unit LayerNorm gains."""
        for name, p in self.named_parameters():
            if name == "patch_kernel" or name.endswith(".weight") and p.dim() == 2:
                fan_in = p.shape[0] if name == "patch_kernel" else p.shape[1]
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
        for m in self.modules():
            if isinstance(m, _QDense):
                m.kernel_q.copy_(torch.randint(-127, 128, m.kernel_q.shape, generator=generator,
                                               device=m.kernel_q.device))
        return self

    def set_quant_static(self) -> "VJEPA2Backbone":
        """Switch every quantized dense to its calibrated static scale (after
        ``calibrate_quant_scales``); in place."""
        if not self.cfg.quantize:
            raise ValueError("set_quant_static needs a quantized backbone (cfg.quantize)")
        cfg = dataclasses.replace(self.cfg, quant_static=True)
        for m in self.modules():
            if hasattr(m, "cfg"):
                m.cfg = cfg
            if isinstance(m, _QDense):
                m.static_scale = True
        return self

    def _embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) pixels -> (B, N, D) tubelet tokens in cfg.dtype."""
        cfg = self.cfg
        dt = cfg.dtype
        b, t, hgt, wid, c = pixels.shape
        ts, ps = cfg.tubelet_size, cfg.patch_size
        # tubelet patchify: (B, T/ts, ts, H/ps, ps, W/ps, ps, C) -> tokens
        x = pixels.reshape(b, t // ts, ts, hgt // ps, ps, wid // ps, ps, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, (t // ts) * (hgt // ps) * (wid // ps), ts * ps * ps * c)
        # bf16 operands, fp32 accumulation (exact products), then bf16
        x = torch.matmul(x.to(dt).float(), self.patch_kernel.to(dt).float()) + self.patch_bias
        return x.to(dt)

    def _state(self, x: torch.Tensor) -> torch.Tensor:
        return _token_mean(x) if self.token_pool else x.float()

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.float(), self.final_norm.normalized_shape, self.final_norm.weight,
                         self.final_norm.bias, self.final_norm.eps)
        return _token_mean(x) if self.token_pool else x

    def _rope(self, n: int, device: torch.device, start: int = 0, total: int | None = None):
        """The rotary tables of tokens [start, start + n) of ``total``."""
        cfg = self.cfg
        cos, sin = _rope_tables(total or n, cfg.hidden_size // cfg.num_heads,
                                cfg.crop_size, cfg.patch_size)
        return tuple(torch.from_numpy(t[start : start + n]).to(device) for t in (cos, sin))

    def forward(self, pixels: torch.Tensor, mesh=None) -> torch.Tensor:
        """(L+1, B, N, D) hidden states, or (L+1, B, D) token means with
        ``token_pool``.  With ``cfg.sequence_parallel_axis``, ``mesh`` is the
        ``LocalMesh`` whose shards split the frames (hence the tokens).
        Under a profiler its stages are spans: ``vit.embed``, ``vit.rope``,
        ``vit.attention`` and ``vit.mlp`` in each block, ``vit.final``."""
        if self.cfg.sequence_parallel_axis is not None:
            return self._forward_sequence_parallel(pixels, mesh)
        with span("vit.embed"):
            x = self._embed(pixels)
            head = self._state(x)[None]
        with span("vit.rope"):
            rope = self._rope(x.shape[1], x.device)
        states = []
        for layer in self.layers:
            x, state = layer(x, rope)
            states.append(state)
        with span("vit.final"):
            states[-1] = self._final(x)
            return torch.cat([head, torch.stack(states)], dim=0)

    def _replica(self, device: torch.device) -> "VJEPA2Backbone":
        """This backbone on ``device``: itself, or a copy made once."""
        if device == self.patch_kernel.device:
            return self
        if device not in self._replicas:
            # (the memo leaves the other replicas out of the copy)
            self._replicas[device] = copy.deepcopy(self, {id(self._replicas): {}}).to(device)
        return self._replicas[device]

    def _forward_sequence_parallel(self, pixels: torch.Tensor, mesh) -> torch.Tensor:
        """``forward`` with the frames split into ``mesh``'s shards: every
        layer runs shard by shard, its attention as one ring over them."""
        cfg = self.cfg
        if mesh is None or mesh.axis_name != cfg.sequence_parallel_axis:
            raise ValueError(
                f"sequence_parallel_axis={cfg.sequence_parallel_axis!r} needs a LocalMesh "
                "with that axis name (forward(pixels, mesh=...))"
            )
        n = mesh.size
        if pixels.shape[1] % (n * cfg.tubelet_size):
            raise ValueError(
                f"{pixels.shape[1]} frames must split into {n} shards of whole tubelets "
                f"(size {cfg.tubelet_size})"
            )
        home = pixels.device
        models = [self._replica(dev) for dev in mesh.devices]
        xs = [m._embed(part.to(dev))
              for m, part, dev in zip(models, pixels.chunk(n, dim=1), mesh.devices)]
        n_local = xs[0].shape[1]
        ropes = [m._rope(n_local, dev, r * n_local, n * n_local)
                 for r, (m, dev) in enumerate(zip(models, mesh.devices))]

        def assemble(parts: list[torch.Tensor]) -> torch.Tensor:
            """The global state from the shards': the mean of the token
            means (equal shard sizes), or the tokens in order."""
            parts = [part.to(home) for part in parts]
            return torch.stack(parts).mean(dim=0) if self.token_pool else torch.cat(parts, dim=1)

        states = [assemble([m._state(x) for m, x in zip(models, xs)])]
        for i in range(cfg.num_layers):
            layers = [m.layers[i] for m in models]
            qkv = [layer.attn.project(_layer_norm(x, layer.norm1, cfg.dtype), rope)
                   for layer, x, rope in zip(layers, xs, ropes)]
            outs = ring_attention_local(*map(list, zip(*qkv)))
            shard_states = []
            for r, layer in enumerate(layers):
                xs[r], state = layer.mlp_residual(xs[r] + layer.attn.output(outs[r]))
                shard_states.append(state)
            states.append(assemble(shard_states))
        states[-1] = assemble([m._final(x) for m, x in zip(models, xs)])
        return torch.stack(states)


def params_from_hf(state_dict: tp.Mapping[str, tp.Any], cfg: VJEPA2Config) -> dict[str, torch.Tensor]:
    """An HF VJEPA2Model encoder state dict -> this backbone's state dict.

    Needs only the tensors (no ``transformers``).  With ``cfg.quantize`` the
    denses are quantized on the host, per layer (``quantize_dense_params``),
    with a_scale 0 (uncalibrated)."""

    def arr(name: str) -> np.ndarray:
        w = state_dict[name]
        w = w.detach().float().cpu().numpy() if isinstance(w, torch.Tensor) else w
        return np.asarray(w, dtype=np.float32)

    out: dict[str, torch.Tensor] = {}

    def linear(dst: str, src: str) -> None:
        w, b = arr(src + ".weight"), arr(src + ".bias")
        if cfg.quantize:
            for key, value in quantize_dense_params({"kernel": w.T, "bias": b}).items():
                out[f"{dst}.{key}"] = value
        else:  # float denses hold cfg.dtype weights, as in the JAX package
            out[f"{dst}.weight"] = torch.from_numpy(w).to(cfg.dtype)
            out[f"{dst}.bias"] = torch.from_numpy(b).to(cfg.dtype)

    def layernorm(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = torch.from_numpy(arr(src + ".weight"))
        out[f"{dst}.bias"] = torch.from_numpy(arr(src + ".bias"))

    pref = "encoder."
    # conv3d weight (D, C, ts, ps, ps) -> flat (ts*ps*ps*C, D) in the
    # patchify order (ts, ps, ps, C)
    conv_w = arr(pref + "embeddings.patch_embeddings.proj.weight")
    d = conv_w.shape[0]
    out["patch_kernel"] = torch.from_numpy(
        np.ascontiguousarray(np.transpose(conv_w, (2, 3, 4, 1, 0)).reshape(-1, d))
    )
    out["patch_bias"] = torch.from_numpy(arr(pref + "embeddings.patch_embeddings.proj.bias"))
    for i in range(cfg.num_layers):
        src, dst = pref + f"layer.{i}.", f"layers.{i}."
        layernorm(dst + "norm1", src + "norm1")
        layernorm(dst + "norm2", src + "norm2")
        for name in ("query", "key", "value", "proj"):
            linear(dst + "attn." + name, src + "attention." + name)
        linear(dst + "fc1", src + "mlp.fc1")
        linear(dst + "fc2", src + "mlp.fc2")
    layernorm("final_norm", pref + "layernorm")
    return out
