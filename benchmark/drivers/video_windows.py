"""The static-int8 ViT-G window stream, as the ``VJEPA2`` feature runs it.

Set-up makes the encoder's float weights from the seed on the device (in
the HF checkpoint's layout) and loads them through the port's
``load_video_backbone`` (host quantisation per output column, calibration
of the static activation scales), makes a pool of seeded uint8 windows
(made on the device, held on the host as decoded frames are), and warms up
two window batches through ``encode_window_stream``.  The window is one
``encode_window_stream`` call over an endless stream of pool windows in
order, cycled, cut at a batch boundary once ``--seconds`` have passed: two
batches in flight, states back on the host.  Every answer is then checked:
each window's (L+1, D) states against the reference's for its pool window;
and, per token, the first block's attention output (its projection's
input, taken by a hook) of the window's first batch at tokens drawn from
the seed, where a lower attention precision shows before the token means
pool it away.
"""

from __future__ import annotations

import time

import torch

from algonauts2025_tpu_torch.features.video import encode_window_stream, load_video_backbone
from algonauts2025_tpu_torch.ops import _cuda
from benchmark.common.trace import span
from benchmark.reference import vjepa2_vitg_int8 as reference

#: tokens a window of the first block's attention output that are compared
SAMPLED_TOKENS = 512
HF_KEYS = ("crop_size", "patch_size", "tubelet_size", "frames_per_clip", "hidden_size",
           "num_hidden_layers", "num_attention_heads", "mlp_ratio")


class Driver:
    def __init__(self, run) -> None:
        self.run = run
        cfg = run.config
        if run.device.type == "cuda":
            _cuda.build_all(["flash_attention", "w8a8", "int8_mlp"])
        self.backbone = load_video_backbone(reference.make_weights(cfg, run.seed, run.device),
                                            {k: cfg[k] for k in HF_KEYS}, quantize=cfg["quantize"],
                                            quant_static=cfg["quant_static"], device=run.device)
        pool = reference.make_windows(cfg, run.traffic, run.seed, run.device)
        self.pool = [w.numpy() for w in pool.cpu()]
        self.batch = cfg["window_batch"]
        encode = self.backbone.encode_windows_async

        def encode_in_span(windows):
            with span("encode_windows_async"):
                return encode(windows)

        self.backbone.encode_windows_async = encode_in_span
        self.tokens = reference.sample_tokens(cfg, run.seed, SAMPLED_TOKENS, run.device)
        self.first_attention = None
        self._capture = False
        self.backbone.model.layers[0].attn.proj.register_forward_pre_hook(self._take_first_attention)

    def _take_first_attention(self, module, args) -> None:
        """The first block's attention output at the sampled tokens, once
        after ``_capture`` is set: (window batch, tokens, D), left on the device."""
        if self._capture:
            self._capture = False
            self.first_attention = args[0][:, self.tokens]

    def prepare(self) -> None:
        """Two window batches through the stream: every shape of the window."""
        encode_window_stream(self.backbone, self.pool[:2 * self.batch], self.batch)

    def _stream(self, seconds: float, order: list[int]):
        t0 = time.perf_counter()
        i = 0
        while i % self.batch or time.perf_counter() - t0 < seconds:
            with span("next_window"):
                index = i % len(self.pool)
                order.append(index)
                i += 1
            yield self.pool[index]

    def window(self, seconds: float, tracer) -> dict:
        sync = torch.cuda.synchronize if self.run.device.type == "cuda" else (lambda: None)
        sync()
        self.order: list[int] = []
        self._capture = True
        with tracer.window():
            t0 = time.perf_counter()
            with span("stream"):
                self.states = encode_window_stream(self.backbone, self._stream(seconds, self.order), self.batch)
            elapsed = time.perf_counter() - t0
        n = self.states.shape[-1]
        return {"window_s": elapsed, "windows": n, "batches": n // self.batch,
                "stim_s": n * self.run.traffic["stim_s_per_window"], "attempted": len(self.order),
                "failed": len(self.order) - n}

    def release(self) -> None:
        del self.backbone
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_states(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        pool = reference.make_windows(self.run.config, self.run.traffic, self.run.seed, self.run.device)
        return reference.window_states(self.run.config, self.run.seed, list(pool), tokens=self.tokens)

    def numbers(self) -> dict[str, float]:
        """Every answer of the window against the reference's states of its
        pool window (``reference.gaps``), the worst answer's; and the first
        batch's first-block attention output at the sampled tokens
        (``reference.attention_gap``), the worst window's."""
        ref = [(s.cpu(), a.cpu()) for s, a in self.reference_states()]
        states = torch.from_numpy(self.states).permute(2, 0, 1)  # (T, L+1, D)
        per_answer = [reference.gaps(states[t], ref[i][0]) for t, i in enumerate(self.order)]
        out = {key: max(g[key] for g in per_answer) for key in per_answer[0]}
        first = self.first_attention.cpu()
        out["first_attention_gap"] = max(reference.attention_gap(first[j], ref[i][1])
                                         for j, i in enumerate(self.order[:self.batch]))
        return out


#: the controls: each precision the configuration states, one step lower on
#: its own (the bf16 attention in fp8 e4m3, the int8 denses in int4)
CONTROLS = {"fp8_attention": {"attention": "fp8"}, "int4_denses": {"int_max": 7}}


def control(run) -> dict[str, dict[str, float]]:
    """Each control's reference in the program's place, over the pool: the
    worst window's numbers, by the control's name."""
    pool = list(reference.make_windows(run.config, run.traffic, run.seed, run.device))
    tokens = reference.sample_tokens(run.config, run.seed, SAMPLED_TOKENS, run.device)
    ref = [(s.cpu(), a.cpu()) for s, a in reference.window_states(run.config, run.seed, pool, tokens=tokens)]
    out = {}
    for name, lower in CONTROLS.items():
        low = reference.window_states(run.config, run.seed, pool, tokens=tokens, **lower)
        per_window = [{**reference.gaps(s.cpu(), r[0]), "first_attention_gap": reference.attention_gap(a, r[1])}
                      for (s, a), r in zip(low, ref)]
        out[name] = {key: max(g[key] for g in per_window) for key in per_window[0]}
    return out


def _altered_answer(driver: Driver) -> None:
    """The first window of every batch comes back with its neighbour's states."""
    encode = driver.backbone.encode_windows_async

    def altered(windows):
        states = encode(windows).clone()
        states[0] = states[1]
        return states

    driver.backbone.encode_windows_async = altered


FAULTS = {"altered_answer": _altered_answer}
