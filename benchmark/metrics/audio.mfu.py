"""audio.mfu (layer: audio feature): the ideal seconds of the chunks
completed, every matmul at the bf16 peak (the denses' and the convs'
operands are bf16, and so are q and k of the scores), over the traced
window's seconds, in %.  A chunk's work is counted over its valid 50 Hz
frames (the port's ``frames`` counter, chunk by chunk), so a bucket's
padding shows here as waste.  A frozen copy of ``chip_smoke.py``'s
``w2v_flops``."""

from benchmark.common.peaks import peaks_for

LAYER = "audio feature"
MOVES = "feature_stim_s_per_s"


def chunk_flops(cfg: dict, t: int) -> float:
    """The matmul operations of one forward over ``t`` frames: the feature
    projection, then per layer the two FFNs, q, k, v and out, q k^T and P v,
    the distance projection, and the pointwise and depthwise convs."""
    h, f, k = cfg["hidden_size"], cfg["intermediate_size"], cfg["conv_depthwise_kernel_size"]
    n_pos = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    layer = 8 * t * h * f + 8 * t * h * h + 4 * t * t * h + 2 * t * n_pos * h + 6 * t * h * h + 2 * t * h * k
    return float(2 * t * cfg["feature_projection_input_dim"] * h + cfg["num_hidden_layers"] * layer)


def read(run):
    frames = run.work.get("chunk_frames")
    if run.trace is None or not frames:
        return None
    peak = peaks_for(run.device_name)["bfloat16"]
    return 100.0 * sum(chunk_flops(run.config, t) for t in frames) / peak / run.window_s
