"""Plain PyTorch reference of the w2v-BERT 2.0 audio feature path.

``facebook/w2v-bert-2.0`` (``Wav2Vec2BertModel``; w2v-BERT 2.0 of Seamless,
arXiv:2312.05187) as TRIBE's audio feature runs it, from a 48 kHz mono
z-scored waveform to the (L+1, D, n_out) stack of hidden states on the 2 Hz
grid:

- resampling to 16 kHz: a julius-style windowed sinc (24 zero crossings,
  rolloff 0.945, a Hann window, the gcd-reduced rates), summed tap by tap;
- SeamlessM4T's kaldi fbank: the waveform x 2^15, 400-sample frames every
  160, DC removal, pre-emphasis 0.97, the povey window, a 512-point FFT,
  80 kaldi mel bins in [20, 8000] Hz, the log with a 2^-23 floor,
  per-bin normalisation over the frames (ddof 1), 2-frame stacking;
- the conformer of HF ``modeling_wav2vec2_bert.py``: the feature
  projection, then per layer a half-step swish FFN, self-attention with the
  clamped relative-distance key bias computed as HF computes it
  (``einsum(q, E[clamp(r - l, -64, 8) + 64])``), the causal depthwise-conv
  module (LayerNorm, pointwise to 2H, GLU, depthwise conv padded on the
  left, LayerNorm, swish, pointwise), a second half-step FFN and the final
  LayerNorm;
- the 2 Hz grid: frame floor(i x T50 / n_out), the ratio in float32.

Arithmetic is float32 with TF32 off.  Values are rounded to bf16 where the
configuration states bf16: the dense and conv weights and biases, and every
activation the bf16 model holds (each dense, conv and LayerNorm output,
each swish, sigmoid and GLU product, each residual sum), and the
probabilities before their product with v.  The LayerNorm statistics and
affine, the scores, the relative bias, the softmax and the distance tables
stay float32.  Scores are computed in blocks of query rows, so that a 90 s
chunk (T = 4500) fits.  Each chunk runs at its exact length, with no bucket
and no mask, so the program's padding masks are held to it too.

Departures from the published path, each the program's own:

- julius renormalises each phase of its filter to a unit sum and pads the
  edges by replication; here, as in the program, the filter is scaled by
  rate x rolloff / old rate and the edges are padded with zeros (a constant
  gain is taken out again by the mel's per-bin normalisation);
- SeamlessM4T pads an odd frame count to an even one and masks the half
  padded stacked frame; here the odd frame is dropped, which leaves every
  valid frame's state as it is;
- the model's dropout is off (inference) and no adapter is used.

The controls are one stated precision a step lower each: ``bf16_scores``,
the scores, the relative bias, their sum and the softmax in bf16;
``fp8_denses``, every dense's weight and input through float8 e4m3 (one
scale a weight, one a row of the input).  The weights come from the seed in
the HF checkpoint's names and layout (``make_weights``); this module imports
nothing of the program.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..common.seeds import Spec, derive, seeded_tensors

TARGET_SR = 16000
OUTPUT_HZ = 2.0
#: query rows a block of the score pipeline
BLOCK_ROWS = 512
DENSES = ("ffn1.intermediate_dense", "ffn1.output_dense", "ffn2.intermediate_dense", "ffn2.output_dense",
          "self_attn.linear_q", "self_attn.linear_k", "self_attn.linear_v", "self_attn.linear_out")
NORMS = ("ffn1_layer_norm", "self_attn_layer_norm", "conv_module.layer_norm", "conv_module.depthwise_layer_norm",
         "ffn2_layer_norm", "final_layer_norm")


def weight_spec(cfg: dict) -> Spec:
    """The model's weights in the HF checkpoint's names and layout:
    N(0, ``initializer_range``) dense, conv and distance weights, zero
    biases, unit LayerNorm gains."""
    d, f, std = cfg["hidden_size"], cfg["intermediate_size"], cfg["initializer_range"]
    n_in, k = cfg["feature_projection_input_dim"], cfg["conv_depthwise_kernel_size"]
    n_pos = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    hd = d // cfg["num_attention_heads"]

    def norm(name: str, width: int) -> Spec:
        return [(name + ".weight", (width,), ("ones",)), (name + ".bias", (width,), ("zeros",))]

    spec = norm("feature_projection.layer_norm", n_in)
    spec += [("feature_projection.projection.weight", (d, n_in), ("normal", std)),
             ("feature_projection.projection.bias", (d,), ("zeros",))]
    shapes = {"intermediate_dense": (f, d), "output_dense": (d, f)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layers.{i}."
        for name in NORMS:
            spec += norm(p + name, d)
        for name in DENSES:
            out, width = shapes.get(name.split(".")[-1], (d, d))
            spec += [(p + name + ".weight", (out, width), ("normal", std)), (p + name + ".bias", (out,), ("zeros",))]
        spec += [(p + "self_attn.distance_embedding.weight", (n_pos, hd), ("normal", std)),
                 (p + "conv_module.pointwise_conv1.weight", (2 * d, d, 1), ("normal", std)),
                 (p + "conv_module.depthwise_conv.weight", (d, 1, k), ("normal", std)),
                 (p + "conv_module.pointwise_conv2.weight", (d, d, 1), ("normal", std))]
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return seeded_tensors(weight_spec(cfg), derive(seed, "weights"), device)


# -- the frontend -------------------------------------------------------------

def resample(wav: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945) -> torch.Tensor:
    """(n,) float32 at ``old_sr`` -> (int(n x new_sr / old_sr),) at
    ``new_sr``: output sample f x p + i is the sum over the taps j of
    x[f x q + j - width] x h_i[j] (p / q the reduced rates)."""
    if old_sr == new_sr:
        return wav
    g = math.gcd(old_sr, new_sr)
    q, p = old_sr // g, new_sr // g
    sr = min(p, q) * rolloff
    width = math.ceil(zeros * q / sr)
    taps = torch.arange(-width, width + q, dtype=torch.float64)
    phases = torch.arange(p, dtype=torch.float64)[:, None]
    t = ((-phases / p + taps / q) * sr).clamp(-zeros, zeros) * math.pi
    bank = (torch.sinc(t / math.pi) * torch.cos(t / zeros / 2) ** 2 * (sr / q)).float().to(wav.device)
    n = wav.shape[-1]
    out_len = int(n * new_sr / old_sr)
    frames = -(-out_len // p)
    padded = F.pad(wav, (width, width + q * frames))
    out = torch.zeros(p, frames, device=wav.device)
    for j in range(bank.shape[1]):
        out += bank[:, j:j + 1] * padded[j:j + q * frames:q]
    return out.T.reshape(-1)[:out_len]


def _kaldi_mel(hz):
    return 1127.0 * torch.log(1.0 + hz / 700.0)


def mel_filters(n_fft: int = 512, n_mels: int = 80, low: float = 20.0, high: float = 8000.0,
                rate: int = TARGET_SR) -> torch.Tensor:
    """(n_fft / 2 + 1, n_mels) triangles in kaldi mel space, unnormalised."""
    centres = torch.linspace(_kaldi_mel(torch.tensor(low, dtype=torch.float64)),
                             _kaldi_mel(torch.tensor(high, dtype=torch.float64)), n_mels + 2, dtype=torch.float64)
    bins = _kaldi_mel(torch.arange(n_fft // 2 + 1, dtype=torch.float64) * rate / n_fft)[:, None]
    rise = (bins - centres[None, :-2]) / (centres[1:-1] - centres[:-2])
    fall = (centres[None, 2:] - bins) / (centres[2:] - centres[1:-1])
    return torch.clamp(torch.minimum(rise, fall), min=0.0).float()


def fbank(wav16: torch.Tensor) -> torch.Tensor:
    """(n,) 16 kHz -> (T50, 160): the normalised log-mel frames, stacked in pairs."""
    x = wav16.float() * 32768.0
    frames = x.unfold(0, 400, 160)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[:, :1] * (1 - 0.97), frames[:, 1:] - 0.97 * frames[:, :-1]], dim=-1)
    n = torch.arange(400, dtype=torch.float64)
    povey = ((0.5 - 0.5 * torch.cos(2 * math.pi * n / 399)) ** 0.85).float().to(x.device)
    power = torch.fft.rfft(frames * povey, n=512, dim=-1).abs() ** 2
    mel = torch.log(torch.clamp_min(power @ mel_filters().to(x.device), 2.0 ** -23))
    mel = (mel - mel.mean(dim=0)) / torch.sqrt(mel.var(dim=0, correction=1) + 1e-7)
    t = mel.shape[0] // 2 * 2
    return mel[:t].reshape(t // 2, 160)


def frame_index(n_out: int, t50: int) -> torch.Tensor:
    """floor(i x (T50 / n_out)) with the ratio and the product in float32,
    clipped to the frames."""
    ratio = np.float32(t50) / np.float32(n_out)
    idx = np.floor(np.arange(n_out, dtype=np.float32) * ratio).astype(np.int64)
    return torch.from_numpy(np.clip(idx, 0, t50 - 1))


# -- the conformer --------------------------------------------------------------

def bf(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, kept in float32."""
    return x.to(torch.bfloat16).float()


def to_fp8(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per slice over ``dims``."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def relative_bias(q: torch.Tensor, table: torch.Tensor, rows: torch.Tensor, keys: int, left: int,
                  right: int) -> torch.Tensor:
    """(H, rows, hd) queries at positions ``rows`` -> (H, rows, keys) bias
    q_l . E[clamp(r - l, -left, right) + left], as HF computes it: the
    table gathered by distance, then an einsum with the queries."""
    distance = torch.clamp(torch.arange(keys, device=q.device)[None, :] - rows[:, None], -left, right) + left
    return torch.einsum("hld,lrd->hlr", q, table[distance])


class Conformer:
    """The model over the seed's weights rounded to ``dtype``:
    ``states(features)`` gives the (L+1, T, D) hidden states of one chunk's
    (T, 160) features; ``scores="bf16"`` and ``denses="fp8"`` are the
    controls."""

    def __init__(self, cfg: dict, weights: dict[str, torch.Tensor], scores: str = "float32",
                 denses: str = "bf16", dtype: torch.dtype = torch.bfloat16) -> None:
        self.cfg, self.scores, self.denses = cfg, scores, denses
        self.eps = cfg["layer_norm_eps"]
        #: the rounding of every value the model holds in ``dtype`` (none in float32)
        self.r = (lambda x: x) if dtype == torch.float32 else (lambda x: x.to(dtype).float())
        self.w = {name: value if ("layer_norm" in name or "distance_embedding" in name) else self.r(value)
                  for name, value in weights.items()}
        #: the first layer's attention input, its LayerNorm's output (T, D)
        self.first_input: torch.Tensor | None = None

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.r(F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"], self.eps))

    def _dense(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        w = self.w[name + ".weight"]
        w = w.reshape(w.shape[0], -1)
        if self.denses == "fp8":
            x, w = to_fp8(x, (-1,)), to_fp8(w, (0, 1))
        y = x @ w.T
        return self.r(y + self.w[name + ".bias"] if bias else y)

    def _ffn(self, x: torch.Tensor, p: str) -> torch.Tensor:
        h = self.r(F.silu(self._dense(self._norm(x, p + "_layer_norm"), p + ".intermediate_dense")))
        return self.r(x + 0.5 * self._dense(h, p + ".output_dense"))

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """(H, T, hd) q, k, v -> (H, T, hd): softmax((q k^T + q . E[d]) /
        sqrt(hd)) v over blocks of query rows, the probabilities rounded to
        bf16 before their product with v."""
        cfg = self.cfg
        left, right = cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"]
        hd, t = q.shape[-1], q.shape[1]
        low = self.scores == "bf16"
        out = torch.empty_like(q)
        for l0 in range(0, t, BLOCK_ROWS):
            rows = torch.arange(l0, min(l0 + BLOCK_ROWS, t), device=q.device)
            qb = q[:, rows]
            scores = qb @ k.transpose(1, 2) / hd ** 0.5
            bias = relative_bias(qb, table, rows, t, left, right) / hd ** 0.5
            if low:
                scores = torch.softmax(bf(bf(scores) + bf(bias)).to(torch.bfloat16), dim=-1).float()
            else:
                scores = torch.softmax(scores + bias, dim=-1)
            out[:, rows] = self.r(scores) @ v
        return out

    def attention_output(self, a: torch.Tensor, layer: int = 0) -> torch.Tensor:
        """(T, D) attention input (the self-attention LayerNorm's output) ->
        (T, D) attention output of layer ``layer``, before ``linear_out``."""
        t, d = a.shape
        p = f"encoder.layers.{layer}.self_attn."
        q, k, v = (self._dense(a, p + "linear_" + m).reshape(t, self.cfg["num_attention_heads"], -1).transpose(0, 1)
                   for m in "qkv")
        attn = self.r(self._attend(q, k, v, self.w[p + "distance_embedding.weight"]))
        return attn.transpose(0, 1).reshape(t, d)

    def _attention(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        p = f"encoder.layers.{layer}.self_attn"
        a = self._norm(x, p + "_layer_norm")
        if layer == 0:
            self.first_input = a
        return self.r(x + self._dense(self.attention_output(a, layer), p + ".linear_out"))

    def _conv(self, x: torch.Tensor, p: str) -> torch.Tensor:
        k = self.cfg["conv_depthwise_kernel_size"]
        c = self._dense(self._norm(x, p + "conv_module.layer_norm"), p + "conv_module.pointwise_conv1", bias=False)
        a, b = c.chunk(2, dim=-1)
        g = self.r(a * self.r(torch.sigmoid(b)))
        w = self.w[p + "conv_module.depthwise_conv.weight"]
        c = self.r(F.conv1d(F.pad(g.T[None], (k - 1, 0)), w, groups=w.shape[0])[0].T)
        c = self.r(F.silu(self._norm(c, p + "conv_module.depthwise_layer_norm")))
        return self.r(x + self._dense(c, p + "conv_module.pointwise_conv2", bias=False))

    def states(self, features: torch.Tensor) -> torch.Tensor:
        x = self._norm(features.float(), "feature_projection.layer_norm")
        x = self._dense(x, "feature_projection.projection")
        out = [x]
        for i in range(self.cfg["num_hidden_layers"]):
            p = f"encoder.layers.{i}."
            x = self._ffn(x, p + "ffn1")
            x = self._attention(x, i)
            x = self._conv(x, p)
            x = self._ffn(x, p + "ffn2")
            x = self._norm(x, p + "final_layer_norm")
            out.append(x)
        return torch.stack(out)


def sample_frames(n_valid: int, seed: int, count: int) -> torch.Tensor:
    """``count`` frames of a chunk's ``n_valid`` valid ones, drawn from the seed, in order."""
    gen = torch.Generator(device="cpu").manual_seed(derive(seed, "frames"))
    return torch.randperm(n_valid, generator=gen)[:min(count, n_valid)].sort().values


@torch.no_grad()
def chunk_states(cfg: dict, seed: int, chunks: tp.Sequence[tuple[torch.Tensor, int, float]],
                 scores: str = "float32", denses: str = "bf16", frames: torch.Tensor | None = None,
                 attention_input: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.bfloat16) -> tuple[list[torch.Tensor], torch.Tensor | None]:
    """The (L+1, D, n_out) states on the 2 Hz grid of each ``(wav, rate,
    duration)`` chunk (a mono z-scored waveform on the device), from the
    seed's weights, on the host; and with ``frames``, the first layer's
    attention output at those frames ((len(frames), D)) of
    ``attention_input`` ((T, D), the first layer's attention input), or
    without it of the first chunk's own.  ``dtype`` is the model's (float32
    for a float32 model: nothing rounded)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        device = chunks[0][0].device
        model = Conformer(cfg, make_weights(cfg, seed, device), scores=scores, denses=denses, dtype=dtype)
        out, first = [], None
        for wav, rate, duration in chunks:
            states = model.states(fbank(resample(wav.float(), int(rate), TARGET_SR)))  # (L+1, T50, D)
            n_out = max(1, int(np.round(duration * OUTPUT_HZ)))
            out.append(states[:, frame_index(n_out, states.shape[1]).to(device)].transpose(1, 2).cpu())
            if first is None:
                first = model.first_input
        attention = None
        if frames is not None:
            a = first if attention_input is None else attention_input.to(device).float()
            attention = model.attention_output(a)[frames.to(device)].cpu()
        return out, attention
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gaps(got: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The relative L2 gaps of one chunk's (L+1, D, n_out) states, each
    layer over (D, n_out): ``state_gap``, the largest over the layers;
    ``first_layer_gap``, the first layer's, before 23 more layers have
    compounded the bf16 rounding of both sides."""
    got, ref = got.double().cpu(), ref.double().cpu()
    per_layer = (got - ref).flatten(1).norm(dim=-1) / ref.flatten(1).norm(dim=-1)
    return {"state_gap": float(per_layer.max()), "first_layer_gap": float(per_layer[1])}


def attention_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The relative L2 gap of the first layer's attention output at the
    sampled frames, both computed from one attention input: the q, k, v
    denses, the score pipeline and P.V alone, clear of the bf16 rounding
    that the frontend's float32 differences set off upstream."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm())
