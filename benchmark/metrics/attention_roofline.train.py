"""attention_roofline.train (layer: kernels, row 1 ``csrc/attention.cu``):
the trunk attention kernel's bound a call over its device time a call, in
%.  The bound is the larger of its operations (q k^T and P v: 4 B H T^2 d
at the float32 peak) and its bytes (q, k, v read and the output written
once, float32).  The calls are the ones the traffic makes: a layer's
forward a step, and with remat its recompute in the backward, over the
steps of the traced window; the time is the profiler's device time of the
kernels named below in that window.  A renamed kernel leaves this metric
empty (``train.mfu`` still bounds it)."""

from benchmark.common.peaks import bound_s, peaks_for

LAYER = "kernels"
MOVES = "train_step_s"
KERNELS = ("attn_fwd_kernel",)


def call_bound_s(cfg: dict, peaks: dict) -> tuple[float, str]:
    model = cfg["brain_model_config"]
    b, t, h = cfg["batch_size"], cfg["n_timesteps"], model["heads"]
    width = model["hidden"] // len(cfg["feature_dims"]) * len(cfg["feature_dims"])
    d = width // h
    flops = 4 * b * h * t * t * d
    nbytes = 4 * (4 * b * h * t * d)
    return bound_s(flops, nbytes, peaks["float32"], peaks)


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels(*KERNELS)
    if not kernels or not run.work.get("steps"):
        return None
    model = run.config["brain_model_config"]
    calls = run.work["steps"] * model["depth"] * (2 if model["remat"] else 1)
    bound, _ = call_bound_s(run.config, peaks_for(run.device_name))
    return 100.0 * bound * calls / sum(end - start for _, start, end in kernels)
