"""moe_roofline.text (layer: kernels): the routed experts' bound over the
device time of the kernels that compute their two grouped GEMMs, in %.

The bound of one MoE layer in one forward (``call_bound_s``) is the larger
of its operations, 2 x 3 x hidden x moe_intermediate for each of the k
slots of each valid token (the gate, up and down projections), at the bf16
peak, and its bytes: every routed expert's bf16 weights (1.107 GB a layer
for DeepSeek-V2-Lite) and the routed rows read and written once (k x valid
tokens x hidden, bf16, each way).  Counting every expert's weights is
exact enough: the smallest forward of the window, ~64 tokens, leaves an
expert without a row with probability (1 - 6/64)^384, ~0.2 %.  A forward's
valid tokens come from the driver's ``forward_lengths``; padded rows are
computed too and show as waste.  The time is the profiler's device time of
the kernels named below in the traced window: the CUTLASS grouped GEMM
that ``torch._grouped_mm`` launches for bf16 on sm_90 (an H100's trace
names it ``cutlass::device_kernel<...GemmUniversal<GroupProblemShape<...``,
mangled; its small ``prepare_grouped_gemm_data`` kernel is left out).  Where no such
kernel ran (a program without it), this metric is empty."""

from benchmark.common.peaks import bound_s, peaks_for

LAYER = "kernels"
MOVES = "feature_stim_s_per_s"
KERNELS = ("GroupProblemShape",)


def moe_layers(cfg: dict) -> int:
    return sum(1 for i in range(cfg["num_hidden_layers"])
               if i >= cfg["first_k_dense_replace"] and i % cfg.get("moe_layer_freq", 1) == 0)


def call_bound_s(cfg: dict, tokens: int, peaks: dict) -> tuple[float, str]:
    d, f, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    flops = 2 * 3 * d * f * k * tokens
    nbytes = 2 * 3 * d * f * cfg["n_routed_experts"] + 2 * 2 * k * tokens * d
    return bound_s(flops, nbytes, peaks["bfloat16"], peaks)


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.kernels(*KERNELS)
    lengths = run.work.get("forward_lengths")
    if not kernels or not lengths:
        return None
    peaks = peaks_for(run.device_name)
    bound = moe_layers(run.config) * sum(call_bound_s(run.config, sum(rows), peaks)[0] for rows in lengths)
    return 100.0 * bound / sum(end - start for _, start, end in kernels)
