"""text.mfu (layer: text feature): the matmul operations of every forward
of the traced window, at the bf16 peak, over the window's seconds, in %.

A forward's work is counted over each row's valid tokens (the driver's
``forward_lengths``, from the masks the stream gave the backbone), so a
bucket's padding shows here as waste: 2 x the active parameters a token
(``token_flops``: the MLA projections of every layer, the dense MLP of the
leading dense layers, and per MoE layer the router, the k routed experts
and the shared experts; 4.483 GFLOP for DeepSeek-V2-Lite) and, for the
token at position p of its row, 2 x heads x (qk + v head dims) x (p + 1)
a layer for q.k and P.v (10,240 x (p + 1) for the Lite).  Counted from the
configuration and the lengths, never from the trace's launches."""

from benchmark.common.peaks import peaks_for

LAYER = "text feature"
MOVES = "feature_stim_s_per_s"


def active_params(cfg: dict) -> float:
    """The weights a token multiplies by in one forward (no LM head)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, pe, v, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    mla = d * h * (nope + pe) + d * (lora + pe) + lora * h * (nope + v) + h * v * d
    f = cfg["moe_intermediate_size"]
    moe = (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * 3 * d * f + cfg["n_routed_experts"] * d
    layers = cfg["num_hidden_layers"]
    dense = sum(1 for i in range(layers) if i < cfg["first_k_dense_replace"] or i % cfg.get("moe_layer_freq", 1))
    return float(layers * mla + dense * 3 * d * cfg["intermediate_size"] + (layers - dense) * moe)


def token_flops(cfg: dict) -> float:
    return 2.0 * active_params(cfg)


def row_flops(cfg: dict, n: int) -> float:
    """A row of ``n`` valid tokens: the dense work and the causal scores."""
    per_position = 2 * cfg["num_attention_heads"] * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                                                     + cfg["v_head_dim"])
    return n * token_flops(cfg) + cfg["num_hidden_layers"] * per_position * n * (n + 1) / 2


def read(run):
    lengths = run.work.get("forward_lengths")
    if run.trace is None or not lengths:
        return None
    peak = peaks_for(run.device_name)["bfloat16"]
    flops = sum(row_flops(run.config, n) for rows in lengths for n in rows)
    return 100.0 * flops / peak / run.window_s
