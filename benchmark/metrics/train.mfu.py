"""train.mfu (layer: training): the trunk's model FLOPs a step (3 x the
forward's: every matmul and the attention at the cell's shapes; remat's
recompute is not counted) over the traced window's seconds a step times the
card's float32 peak (the trunk computes in float32 with TF32 off, outside
the tensor cores), in %."""

from benchmark.common.peaks import peaks_for

LAYER = "training"
MOVES = "train_step_s"


def forward_flops(cfg: dict) -> float:
    """The forward's multiply-adds x 2 at the configuration's shapes."""
    model = cfg["brain_model_config"]
    b, t = cfg["batch_size"], cfg["n_timesteps"]
    n_mod = len(cfg["feature_dims"])
    width = model["hidden"] // n_mod * n_mod
    tokens = b * t
    inputs = {m: n_layers * dim for m, (n_layers, dim) in cfg["feature_dims"].items()}
    flops = sum(2 * tokens * d * (width // n_mod) for d in inputs.values())  # projectors
    d_head = width // model["heads"]
    per_layer = 2 * tokens * width * (3 * width + width + 2 * model["ff_mult"] * width)
    per_layer += 4 * b * model["heads"] * t * t * d_head  # q k^T and P v
    flops += model["depth"] * per_layer
    flops += 2 * tokens * width * cfg["n_outputs"]  # the subject readout
    flops += 2 * b * cfg["n_outputs"] * t * cfg["n_output_timesteps"]  # pooling onto TRs
    if model["contrastive_enabled"]:
        for m in model["contrastive_modalities"]:
            flops += 2 * tokens * inputs[m] * model["hidden"]  # the InfoNCE head
            flops += 2 * tokens * tokens * model["hidden"]  # the logits
    return float(flops)


def read(run):
    steps = run.work.get("steps")
    if run.trace is None or not steps:
        return None
    peak = peaks_for(run.device_name)["float32"]
    return 100.0 * 3 * forward_flops(run.config) * steps / (run.window_s * peak)
