"""Plain PyTorch reference of the DeepSeek-V2-Lite word features.

``deepseek-ai/DeepSeek-V2-Lite`` (DeepSeek-V2, arXiv:2405.04434) with the
layer equations of the checkpoint's own ``modeling_deepseek.py``, from
token ids to the (L+1, T, D) hidden states (the embedding, layers 1..L-1,
the final norm of layer L), pooled as the text feature pools a word:

- multi-head latent attention without a q LoRA: q = W_q h (16 heads of 128
  "nope" + 64 rotary dims), [c_kv, k_pe] = W_kva h, c_kv through an RMSNorm
  and W_kvb into each head's 128 key and 128 value dims, one rotary key
  shared by the heads; RoPE on the interleaved pairs (x[2i], x[2i+1]) with
  the yarn inverse frequencies (factor 40 over 4096 positions, beta 32 and
  1), cos and sin scaled by mscale(40, 0.707) / mscale(40, 0.707) = 1; the
  scores over 192 dims scaled by 192^-0.5 x mscale(40, 0.707)^2, causal,
  and P v with the 128-wide values, then o_proj;
- layer 0 a dense SwiGLU MLP; layers 1-26 a router (an fp32 gate over the
  64 experts, softmax, greedy top-6, the weights not renormalised) over 64
  SwiGLU experts, each token's 6 outputs weighted and summed in fp32 and
  cast, plus the shared experts' SwiGLU of width 2 x 1408;
- pre-norm residual layers with RMSNorm (eps 1e-6), a final RMSNorm.

Arithmetic is float32 with TF32 off.  Values are rounded to bf16 where the
configuration states bf16: the weights, and every activation the bf16
model holds (each dense output, RMSNorm output, rotated q and k, attention
output, SiLU and SwiGLU product, the routed and shared outputs and their
sum, each residual sum), and the normalised probabilities before their
product with v, as the published eager attention rounds them.  RMSNorm
statistics and gain, RoPE, the scores and softmax, the router and the
routed combine stay float32.  The MoE is a loop over the experts; the
scores are computed in blocks of query rows; each sequence runs at its
exact length, with no padding or mask.  The model runs one layer at a
time: each layer's weights are made from the seed, used on every sequence
and dropped, so the reference fits on the card beside the program's 31 GB.

Departures from the published code, each the program's own:

- the softmax scale carries the yarn mscale^2 (1.589627), as
  ``modeling_deepseek.py`` sets it; transformers' native
  ``DeepseekV2Attention`` leaves it out (its ``scaling`` is 192^-0.5);
- RoPE runs in float32 and is rounded once (the published code rotates in
  bf16 against bf16 tables);
- the RMSNorm gain multiplies in float32 before the cast (the published
  norm casts, then multiplies by the bf16 gain);
- no LM head, no KV cache, no dropout; positions 0..T-1 of each sequence.

The controls are one stated precision a step lower each: ``bf16_scores``,
the attention's scores rounded to bf16 before the softmax (as the published
eager attention holds them); ``bf16_router``, the router's logits and
softmax in bf16; ``fp8_experts``, each routed expert's weights (one scale
an expert and projection) and inputs (one a row) through float8 e4m3.  The
weights come from the seed in the HF checkpoint's names and layout, each
tensor from a seed of its own (``make_tensor``), so that the program and
this reference make one tensor at a time; this module imports nothing of
the program.
"""

from __future__ import annotations

import contextlib
import math
import typing as tp

import torch
import torch.nn.functional as F

from ..common.seeds import derive

#: query rows a block of the scores
BLOCK_ROWS = 256


# -- the weights ---------------------------------------------------------------

def is_moe(cfg: dict, layer: int) -> bool:
    return layer >= cfg["first_k_dense_replace"] and layer % cfg.get("moe_layer_freq", 1) == 0


def layer_spec(cfg: dict, layer: int) -> list[tuple[str, tuple[int, ...], str]]:
    """(HF name, shape, init) of layer ``layer``'s tensors; init is
    "normal" (N(0, initializer_range)) or "ones" (an RMSNorm gain)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, pe, v, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    p = f"layers.{layer}."
    spec = [(p + "input_layernorm.weight", (d,), "ones"), (p + "post_attention_layernorm.weight", (d,), "ones"),
            (p + "self_attn.q_proj.weight", (h * (nope + pe), d), "normal"),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (lora + pe, d), "normal"),
            (p + "self_attn.kv_a_layernorm.weight", (lora,), "ones"),
            (p + "self_attn.kv_b_proj.weight", (h * (nope + v), lora), "normal"),
            (p + "self_attn.o_proj.weight", (d, h * v), "normal")]

    def swiglu(prefix: str, f: int) -> list:
        return [(prefix + "gate_proj.weight", (f, d), "normal"), (prefix + "up_proj.weight", (f, d), "normal"),
                (prefix + "down_proj.weight", (d, f), "normal")]

    if not is_moe(cfg, layer):
        return spec + swiglu(p + "mlp.", cfg["intermediate_size"])
    f = cfg["moe_intermediate_size"]
    spec.append((p + "mlp.gate.weight", (cfg["n_routed_experts"], d), "normal"))
    for e in range(cfg["n_routed_experts"]):
        spec += swiglu(f"{p}mlp.experts.{e}.", f)
    return spec + swiglu(p + "mlp.shared_experts.", cfg["n_shared_experts"] * f)


def weight_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every tensor of the model in the HF checkpoint's names (the base
    model's: no LM head)."""
    d = cfg["hidden_size"]
    spec = [("embed_tokens.weight", (cfg["vocab_size"], d), "normal"), ("norm.weight", (d,), "ones")]
    for i in range(cfg["num_hidden_layers"]):
        spec += layer_spec(cfg, i)
    return spec


def make_tensor(cfg: dict, seed: int, name: str, shape: tuple[int, ...], init: str, device) -> torch.Tensor:
    """One float32 tensor of the model, from a seed of its own."""
    if init == "ones":
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights/" + name))
    return torch.randn(shape, generator=gen, device=device).mul_(cfg["initializer_range"])


class SeededWeights(tp.Mapping[str, torch.Tensor]):
    """The model's tensors by HF name, each made on ``device`` when it is
    read (float32), never held."""

    def __init__(self, cfg: dict, seed: int, device) -> None:
        self.cfg, self.seed, self.device = cfg, seed, device
        self.spec = {name: (shape, init) for name, shape, init in weight_spec(cfg)}

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, init = self.spec[name]
        return make_tensor(self.cfg, self.seed, name, shape, init, self.device)

    def __iter__(self):
        return iter(self.spec)

    def __len__(self) -> int:
        return len(self.spec)


# -- the model -----------------------------------------------------------------------

def bf(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, kept in float32."""
    return x.to(torch.bfloat16).float()


def to_fp8(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per slice over ``dims``."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """``modeling_deepseek.py``'s ``DeepseekV2YarnRotaryEmbedding``
    frequencies, in float64."""
    d, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rope = cfg.get("rope_scaling") or {}
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    factor = rope.get("factor", 1.0)
    if factor <= 1:
        return extra

    def correction_dim(rotations: float) -> float:
        return d * math.log(rope["original_max_position_embeddings"] / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rope["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rope["beta_slow"])), d - 1)
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float64) - low) / max(high - low, 0.001), 0, 1)
    mask = 1.0 - ramp
    return extra / factor * (1 - mask) + extra * mask


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rope = cfg.get("rope_scaling") or {}
    if rope.get("factor", 1.0) > 1 and rope.get("mscale_all_dim"):
        scale *= yarn_mscale(rope["factor"], rope["mscale_all_dim"]) ** 2
    return scale


class Model:
    """The model over the seed's weights: ``run`` gives pooled hidden
    states of token sequences, layer by layer; ``attention`` and ``moe`` one
    layer's MLA (``qkv`` and ``attend`` its parts) and MoE of a given
    input.  ``scores="bf16"``, ``router="bf16"`` and ``experts="fp8"`` are
    the controls; ``dtype`` float32 rounds nothing."""

    def __init__(self, cfg: dict, seed: int, device, scores: str = "float32", router: str = "float32",
                 experts: str = "bf16", dtype: torch.dtype = torch.bfloat16) -> None:
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.scores, self.router, self.experts = scores, router, experts
        self.eps = cfg["rms_norm_eps"]
        #: the rounding of every value the model holds in ``dtype``
        self.r = (lambda x: x) if dtype == torch.float32 else (lambda x: x.to(dtype).float())
        rope = cfg.get("rope_scaling") or {}
        factor = rope.get("factor", 1.0)
        self.cos_gain = (yarn_mscale(factor, rope.get("mscale", 1.0)) / yarn_mscale(factor, rope["mscale_all_dim"])
                         if factor > 1 and rope.get("mscale_all_dim") else 1.0)
        self.scale = softmax_scale(cfg)
        self.inv_freq = yarn_inv_freq(cfg).float().to(self.device)

    def weights(self, layer: int | None) -> dict[str, torch.Tensor]:
        """Layer ``layer``'s tensors (None: the embedding and final norm),
        the dense ones rounded to the model's dtype, the gains float32."""
        spec = ([("embed_tokens.weight", (self.cfg["vocab_size"], self.cfg["hidden_size"]), "normal"),
                 ("norm.weight", (self.cfg["hidden_size"],), "ones")] if layer is None
                else layer_spec(self.cfg, layer))
        prefix = "" if layer is None else f"layers.{layer}."
        return {name[len(prefix):]: (t if init == "ones" else self.r(t))
                for name, shape, init in spec
                for t in [make_tensor(self.cfg, self.seed, name, shape, init, self.device)]}

    def _norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        return self.r(x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + self.eps) * gain)

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Rotate the interleaved pairs of ``x`` (..., T, d) at ``positions``."""
        ang = positions[:, None].float() * self.inv_freq
        cos, sin = torch.cos(ang) * self.cos_gain, torch.sin(ang) * self.cos_gain
        even, odd = x[..., 0::2], x[..., 1::2]
        return self.r(torch.cat([even * cos - odd * sin, odd * cos + even * sin], dim=-1))

    def qkv(self, w: dict[str, torch.Tensor], a: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(T, D) normed input of one sequence -> the (H, T, 192) rotated q and
        k and the (H, T, 128) v."""
        cfg = self.cfg
        t = a.shape[0]
        h, nope, pe, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"])
        q = self.r(a @ w["self_attn.q_proj.weight"].T).view(t, h, nope + pe).transpose(0, 1)
        kv_a = self.r(a @ w["self_attn.kv_a_proj_with_mqa.weight"].T)
        c_kv, k_pe = kv_a[:, :cfg["kv_lora_rank"]], kv_a[:, cfg["kv_lora_rank"]:]
        kv = self.r(self._norm(c_kv, w["self_attn.kv_a_layernorm.weight"]) @ w["self_attn.kv_b_proj.weight"].T)
        kv = kv.view(t, h, nope + vd).transpose(0, 1)
        positions = torch.arange(t, device=a.device)
        q = torch.cat([q[..., :nope], self._rope(q[..., nope:], positions)], dim=-1)
        k = torch.cat([kv[..., :nope], self._rope(k_pe, positions)[None].expand(h, t, pe)], dim=-1)
        return q, k, kv[..., nope:]

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Causal attention of (H, T, dk) q, k and (H, T, dv) v -> (H, T, dv),
        rounded to the model's dtype."""
        h, t, _ = q.shape
        out = torch.empty(h, t, v.shape[-1], device=q.device)
        for l0 in range(0, t, BLOCK_ROWS):
            rows = torch.arange(l0, min(l0 + BLOCK_ROWS, t), device=q.device)
            scores = q[:, rows] @ k.transpose(1, 2) * self.scale
            if self.scores == "bf16":
                scores = bf(scores)
            scores = scores.masked_fill(torch.arange(t, device=q.device)[None] > rows[:, None], float("-inf"))
            out[:, rows] = self.r(torch.softmax(scores, dim=-1)) @ v
        return self.r(out)

    def attention(self, w: dict[str, torch.Tensor], a: torch.Tensor) -> torch.Tensor:
        """(T, D) normed input of one sequence -> (T, D) MLA output after o_proj."""
        out = self.attend(*self.qkv(w, a))
        out = out.transpose(0, 1).reshape(a.shape[0], -1)
        return self.r(out @ w["self_attn.o_proj.weight"].T)

    def _swiglu(self, x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                fp8: bool = False) -> torch.Tensor:
        if fp8:
            x, wg, wu = to_fp8(x, (-1,)), to_fp8(wg, (0, 1)), to_fp8(wu, (0, 1))
        a = self.r(self.r(F.silu(self.r(x @ wg.T))) * self.r(x @ wu.T))
        if fp8:
            a, wd = to_fp8(a, (-1,)), to_fp8(wd, (0, 1))
        return self.r(a @ wd.T)

    def route(self, w: dict[str, torch.Tensor], x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, D) -> the (N, k) float32 weights and expert ids."""
        logits = x @ w["mlp.gate.weight"].T
        if self.router == "bf16":
            scores = torch.softmax(logits.to(torch.bfloat16), dim=-1).float()
        else:
            scores = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(scores, self.cfg["num_experts_per_tok"], dim=-1)
        if self.cfg["norm_topk_prob"]:
            weights = weights / weights.sum(dim=-1, keepdim=True)
        return weights * self.cfg["routed_scaling_factor"], ids

    def moe(self, w: dict[str, torch.Tensor], x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, D) normed input -> the (N, D) MoE output (routed + shared) and
        the (N, k) expert ids."""
        weights, ids = self.route(w, x)
        n, k = ids.shape
        routed = torch.zeros(n, k, x.shape[1], device=x.device)
        for e in range(self.cfg["n_routed_experts"]):
            tok, slot = (ids == e).nonzero(as_tuple=True)
            if tok.numel():
                p = f"mlp.experts.{e}."
                routed[tok, slot] = self._swiglu(x[tok], w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                                                 w[p + "down_proj.weight"], fp8=self.experts == "fp8")
        routed = self.r((routed * weights[..., None]).sum(dim=1))
        shared = self._swiglu(x, w["mlp.shared_experts.gate_proj.weight"], w["mlp.shared_experts.up_proj.weight"],
                              w["mlp.shared_experts.down_proj.weight"])
        return self.r(routed + shared), ids

    def _mlp(self, w: dict[str, torch.Tensor], layer: int, x: torch.Tensor) -> torch.Tensor:
        if is_moe(self.cfg, layer):
            return self.moe(w, x)[0]
        return self._swiglu(x, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"], w["mlp.down_proj.weight"])

    def run(self, sequences: tp.Sequence[torch.Tensor], pools: tp.Sequence[torch.Tensor],
            capture: tp.Collection[int] = ()) -> list[torch.Tensor]:
        """Each 1-D token sequence's (L+1, D) states pooled by its (W, T)
        matrix: (L+1, W, D) on the host.  For the sequences in ``capture``,
        ``attention_inputs[i]`` and ``moe_inputs[i]`` keep layer 0's
        attention input and the first MoE layer's input ((T, D), on the
        device)."""
        cfg = self.cfg
        w = self.weights(None)
        xs = [self.r(w["embed_tokens.weight"][s.to(self.device)]) for s in sequences]
        pools = [p.to(self.device).float() for p in pools]
        out = [[p @ x] for p, x in zip(pools, xs)]
        final_gain = w["norm.weight"]
        del w
        self.attention_inputs: dict[int, torch.Tensor] = {}
        self.moe_inputs: dict[int, torch.Tensor] = {}
        first_moe = next(i for i in range(cfg["num_hidden_layers"]) if is_moe(cfg, i))
        for layer in range(cfg["num_hidden_layers"]):
            w = self.weights(layer)
            for j, x in enumerate(xs):
                a = self._norm(x, w["input_layernorm.weight"])
                if layer == 0 and j in capture:
                    self.attention_inputs[j] = a
                xs[j] = self.r(x + self.attention(w, a))
            normed = [self._norm(x, w["post_attention_layernorm.weight"]) for x in xs]
            for j in capture:
                if layer == first_moe:
                    self.moe_inputs[j] = normed[j]
            mlp = self._mlp(w, layer, torch.cat(normed)).split([x.shape[0] for x in xs])
            xs = [self.r(x + m) for x, m in zip(xs, mlp)]
            del w, normed, mlp
            for o, p, x in zip(out, pools, xs):
                o.append(p @ (self._norm(x, final_gain) if layer + 1 == cfg["num_hidden_layers"] else x))
        return [torch.stack(o).cpu() for o in out]


@contextlib.contextmanager
def no_tf32() -> tp.Iterator[None]:
    """TF32 off for the body (float32 matmuls in float32), the setting restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def pool_matrix(length: int, spans: tp.Sequence[tuple[int, int]]) -> torch.Tensor:
    """(W, length) mean-pooling rows: row i averages positions [end - span,
    end) of its ``(end, span)``."""
    pool = torch.zeros(len(spans), length)
    for i, (end, span) in enumerate(spans):
        pool[i, end - span:end] = 1.0 / span
    return pool


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm())


def state_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The relative L2 gap of one answer's (L+1, D) states, each layer over
    D: the largest over the layers."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def route_mismatch(got_ids: torch.Tensor, ref_ids: torch.Tensor) -> float:
    """The share of tokens whose set of k experts differs."""
    got, ref = got_ids.cpu().sort(dim=-1).values, ref_ids.cpu().sort(dim=-1).values
    return float((got != ref).any(dim=-1).double().mean())
