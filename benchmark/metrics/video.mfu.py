"""video.mfu (layer: video feature): the ideal seconds of the window
batches completed, each operation at its precision's peak (the int8 denses
q, k, v, proj, fc1 and fc2 at the int8 peak; attention's q k^T and P v and
the patch embedding, bf16 operands, at the bf16 peak), over the traced
window's seconds, in %."""

from benchmark.common.peaks import peaks_for

LAYER = "video feature"
MOVES = "feature_stim_s_per_s"


def batch_work(cfg: dict) -> dict[str, float]:
    """The operations of one window batch by precision."""
    b = cfg["window_batch"]
    grid = cfg["crop_size"] // cfg["patch_size"]
    n = cfg["frames_per_clip"] // cfg["tubelet_size"] * grid * grid
    d, layers, heads = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"]
    f = int(d * cfg["mlp_ratio"])
    tokens = b * n
    int8 = 2 * tokens * (4 * d * d + 2 * d * f) * layers
    attention = 4 * b * heads * n * n * (d // heads) * layers
    patch = 2 * tokens * (cfg["tubelet_size"] * cfg["patch_size"] ** 2 * 3) * d
    return {"int8": float(int8), "bfloat16": float(attention + patch)}


def ideal_batch_s(cfg: dict, peaks: dict) -> float:
    return sum(ops / peaks[kind] for kind, ops in batch_work(cfg).items())


def read(run):
    batches = run.work.get("batches")
    if run.trace is None or not batches:
        return None
    return 100.0 * batches * ideal_batch_s(run.config, peaks_for(run.device_name)) / run.window_s
