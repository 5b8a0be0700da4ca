"""int8_mlp_roofline.video (layer: kernels, row 7 ``csrc/int8_mlp.cu``): the
ViT-G MLP kernel's bound a call over its device time a call, in %.  The
bound is the larger of its operations (fc1 and fc2: 4 M K F at the int8
peak) and its bytes (the bf16 input and output, both int8 weights, the
biases and scales, each once).  The calls are the ones the traffic makes,
one a layer a window batch of the traced window; the time is the device
time of the three kernels of each call in that window: fc1's GEMM, fc2's
GEMM and the quantize pass launched just before fc1 (the names below).  A
renamed kernel leaves this metric empty (``video.mfu`` still bounds it)."""

from benchmark.common.peaks import bound_s, peaks_for

LAYER = "kernels"
MOVES = "feature_stim_s_per_s"
FC1, FC2, QUANTIZE = "StoreGeluQuant", "StoreDequant<__nv_bfloat16, 1>", "quantize_kernel"


def call_bound_s(cfg: dict, peaks: dict) -> tuple[float, str]:
    grid = cfg["crop_size"] // cfg["patch_size"]
    m = cfg["window_batch"] * cfg["frames_per_clip"] // cfg["tubelet_size"] * grid * grid
    k = cfg["hidden_size"]
    f = int(k * cfg["mlp_ratio"])
    flops = 4 * m * k * f
    nbytes = 2 * m * k * 2 + 2 * k * f + 4 * (2 * f + 2 * k)
    return bound_s(flops, nbytes, peaks["int8"], peaks)


def read(run):
    if run.trace is None:
        return None
    kernels = sorted(((s, e, n) for n, c, s, e in run.trace.device if c == "kernel"))
    found, seconds = False, 0.0
    for i, (start, end, name) in enumerate(kernels):
        if FC1 in name:
            found = True
            seconds += end - start
            if i and QUANTIZE in kernels[i - 1][2]:
                seconds += kernels[i - 1][1] - kernels[i - 1][0]
        elif FC2 in name:
            seconds += end - start
    if not found or not run.work.get("batches"):
        return None
    calls = run.work["batches"] * run.config["num_hidden_layers"]
    bound, _ = call_bound_s(run.config, peaks_for(run.device_name))
    return 100.0 * bound * calls / seconds
