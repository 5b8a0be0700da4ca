"""relkey_roofline.audio (layer: kernels, row 8 ``flash_relkey_kernel`` of
``csrc/flash_attention.cu``): the w2v-BERT self-attention's bound over its
device time, in %.  The bound of a call is the largest of its operations
(q k^T and P v: 4 H T^2 d at the bf16 peak), its bytes (bf16 q, k, v read
and the output written once) and its exponentials (one ex2 a score, H T^2,
at the MUFU's rate), T a chunk's valid frames (``chunk_frames``), one call a
layer; the time is the profiler's device time of the kernels named below
in the traced window.  The bound counts the function's work once, whatever
computes it: a kernel that sweeps the keys twice reads at most ~67 %.
Where no such kernel ran (a program without it) this metric is empty."""

from benchmark.common.peaks import bound_s, peaks_for

LAYER = "kernels"
MOVES = "feature_stim_s_per_s"
KERNELS = ("flash_relkey_kernel",)


def call_bound_s(cfg: dict, t: int, peaks: dict) -> tuple[float, str]:
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    flops = 4 * heads * t * t * d
    nbytes = 2 * 4 * heads * t * d
    return bound_s(flops, nbytes, peaks["bfloat16"], peaks, exps=heads * t * t)


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels(*KERNELS)
    frames = run.work.get("chunk_frames")
    if not kernels or not frames:
        return None
    peaks = peaks_for(run.device_name)
    bound = run.config["num_hidden_layers"] * sum(call_bound_s(run.config, t, peaks)[0] for t in frames)
    return 100.0 * bound / sum(end - start for _, start, end in kernels)
