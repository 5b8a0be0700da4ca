"""flash_roofline.video (layer: kernels, row 4 ``flash_tc_kernel`` of
``csrc/flash_attention.cu``): the ViT-G attention's bound a call over its
device time a call, in %.  The bound is the largest of its operations (q k^T
and P v: 4 B H N^2 d at the bf16 peak), its bytes (bf16 q, k, v read and the
output written once) and its exponentials (one ex2 a score at the MUFU's
rate).  The calls are the ones the traffic makes, one a layer a window
batch of the traced window; the time is the profiler's device time of the
kernels named below in that window.  A renamed kernel leaves this metric
empty (``video.mfu`` still bounds it)."""

from benchmark.common.peaks import bound_s, peaks_for

LAYER = "kernels"
MOVES = "feature_stim_s_per_s"
KERNELS = ("flash_tc_kernel",)


def call_bound_s(cfg: dict, peaks: dict) -> tuple[float, str]:
    b, heads = cfg["window_batch"], cfg["num_attention_heads"]
    grid = cfg["crop_size"] // cfg["patch_size"]
    n = cfg["frames_per_clip"] // cfg["tubelet_size"] * grid * grid
    d = cfg["hidden_size"] // heads
    flops = 4 * b * heads * n * n * d
    nbytes = 2 * 4 * b * heads * n * d
    return bound_s(flops, nbytes, peaks["bfloat16"], peaks, exps=b * heads * n * n)


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels(*KERNELS)
    if not kernels or not run.work.get("batches"):
        return None
    calls = run.work["batches"] * run.config["num_hidden_layers"]
    bound, _ = call_bound_s(run.config, peaks_for(run.device_name))
    return 100.0 * bound * calls / sum(end - start for _, start, end in kernels)
