"""Reading the program's spans beside the device's work (``common/program_trace.py``)."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import harness, spans
from benchmark.common import program_trace
from benchmark.common.trace import read_events
from conftest import BENCH, spec, tiny_root
from test_bench_trace import event
from test_bench_trace import trace as bench_trace


def call(name, ts, corr=None, dur=2):
    return {"ph": "X", "name": name, "cat": "cuda_runtime", "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def device(name, cat, ts, dur, corr):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": {"correlation": corr}}


#: one window batch (#5) of the stream, from 1000 us, with the fetch of
#: batch #3: times in us, the window's start at 1000
PROGRAM = [
    event("video.stack#5", "user_annotation", 1100, 300),
    event("video.encode#5", "user_annotation", 1400, 1300),
    event("video.upload", "user_annotation", 1400, 200),
    event("video.preprocess", "user_annotation", 1600, 200),
    call("cudaStreamSynchronize", 1650),
    call("cudaLaunchKernel", 1700, corr=1),
    event("video.backbone", "user_annotation", 1800, 800),
    event("vit.rope", "user_annotation", 1800, 100),
    call("cudaMemcpyAsync", 1840, corr=2),
    call("cudaStreamSynchronize", 1850),
    event("vit.mlp", "user_annotation", 2000, 500),
    call("cudaLaunchKernel", 2100, corr=3),
    call("cudaLaunchKernel", 2200, corr=4),
    call("cuLaunchKernelEx", 2300, corr=5),
    event("video.fetch#3", "user_annotation", 2700, 900),
    call("cudaMemcpyAsync", 2710, corr=6),
    call("cudaStreamSynchronize", 2720),
    call("cudaStreamSynchronize", 9000),  # inside no program span
    device("void resize_kernel<float>()", "kernel", 1900, 100, 1),
    device("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2000, 10, 2),
    device("void i8wg::gemm_kernel<PingPongPairs, i8wg::StoreGeluQuant>", "kernel", 2600, 400, 3),
    device("void at::native::elementwise_kernel<128, 2>()", "kernel", 3000, 200, 4),
    device("void i8wg::quantize_kernel<bf16>", "kernel", 3200, 100, 5),
    device("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 3300, 200, 6),
    device("void lost_kernel()", "kernel", 5000, 100, 99),  # its launch is not in the trace
]
BENCH_EVENTS = [
    event("bench.window", "user_annotation", 1000, 10000),
    event("bench.stream", "user_annotation", 1000, 10000),
]


def test_program_spans_are_kept_and_bench_spans_unchanged():
    t = program_trace.read(BENCH_EVENTS + PROGRAM)
    assert [(r.name, r.start) for r in t.spans][:3] == [("video.stack", pytest.approx(100e-6)),
                                                          ("video.encode", pytest.approx(400e-6)),
                                                          ("video.upload", pytest.approx(400e-6))]
    assert {r.name for r in t.spans} == {"video.stack", "video.encode", "video.upload", "video.preprocess",
                                        "video.backbone", "vit.rope", "vit.mlp", "video.fetch"}
    assert t.base.spans == [("stream", 0.0, pytest.approx(10000e-6))]
    assert t.base == read_events(BENCH_EVENTS + PROGRAM)


def test_existing_metrics_and_breakdown_read_the_same_with_program_events():
    """On the existing test events, with the program's events added, every
    metric of the benchmark and ``breakdown()`` read what they read before."""
    before = bench_trace()
    events = [event("bench.window", "user_annotation", 1000, 100),
              event("bench.train_step", "user_annotation", 1000, 60),
              event("bench.encode_windows_async", "user_annotation", 1070, 20),
              event("void attn_fwd_kernel<4>(Params)", "kernel", 1005, 10),
              event("void attn_fwd_kernel<4>(Params)", "kernel", 1010, 10),
              event("Memcpy HtoD", "gpu_memcpy", 1040, 5),
              event("before the window", "kernel", 900, 50),
              event("cudaLaunchKernel", "cuda_runtime", 1001, 2)]
    after = read_events(events + [event("video.stack#0", "user_annotation", 1020, 30),
                                  event("vit.mlp", "user_annotation", 1071, 5),
                                  call("cudaStreamSynchronize", 1030)])
    assert after == before and after.breakdown() == before.breakdown()
    for cfg_name, work in (("tribe_trunk", {"steps": 1}), ("vjepa2_vitg_int8", {"batches": 1})):
        cfg = json.loads((BENCH / "configs" / f"{cfg_name}.json").read_text())
        for path in sorted((BENCH / "metrics").glob("*.py")):
            reader = harness.load_module(path)
            runs = [harness.Run(name="t", cell={}, config=cfg, traffic={"stim_s_per_window": 0.5}, seed=0,
                                seconds=1, device=None, device_name="NVIDIA H100 80GB HBM3", window_s=100e-6, setup_s=1.0,
                                work=dict(work), trace=t) for t in (before, after)]
            try:
                values = [reader.read(run) for run in runs]
            except KeyError:  # a reader of the other configuration's cell
                continue
            assert values[0] == values[1], path.name


def test_hand_written_kernels_are_the_rooflines_own():
    """The glue reader leaves out the kernels the roofline metrics time, by
    the names those metrics hold, and row 6's GEMM beside row 7's fc2."""
    flash = harness.load_module(BENCH / "metrics" / "flash_roofline.video.py")
    mlp = harness.load_module(BENCH / "metrics" / "int8_mlp_roofline.video.py")
    assert program_trace.HAND_WRITTEN == (*flash.KERNELS, mlp.FC1, mlp.FC2, mlp.QUANTIZE, program_trace.ROW6_GEMM)
    assert program_trace.ROW6_GEMM != mlp.FC2


def test_launches_go_to_the_innermost_range():
    t = program_trace.read(BENCH_EVENTS + PROGRAM)
    got = t.device_by_span()
    assert got["all"] == pytest.approx({"video.preprocess": 100e-6, "vit.mlp": 700e-6, "none": 100e-6})
    # inside video.backbone and not hand-written: the elementwise kernel alone
    assert got["glue"] == pytest.approx({"vit.mlp": 200e-6})


def test_an_idle_gap_under_video_stack_is_named_so():
    events = BENCH_EVENTS + PROGRAM + [event("video.stack#6", "user_annotation", 6000, 4000)]
    t = program_trace.read(events)
    # the device idles over [4100, 10000) us of the window; its middle is in video.stack#6
    assert t.named_gaps()[0] == ["video.stack", pytest.approx(5900e-6)]
    assert t.base.breakdown()["idle_gaps"][0] == ["stream", pytest.approx(5900e-6)]
    idle = t.idle_by_span()
    assert idle["video.stack"] == pytest.approx(300e-6 + 4000e-6)
    assert idle["vit.mlp"] == pytest.approx(490e-6) and idle["video.fetch"] == pytest.approx(100e-6)


@pytest.mark.parametrize("name, value", [
    # idle under stack 300, upload 200, preprocess 200, rope 100, mlp 490,
    # backbone 100 us (the 100 us under the fetch and the rest under
    # bench.stream are not the program's stages)
    ("stream.exposed_ms.video", 1.39 / 2),
    ("stream.stage_ms.video", 0.5 / 2),  # stack 300 + upload 200 us
    ("stream.waits.video", 3 / 2),  # preprocess, rope, fetch
    ("vit.glue_ms.video", 0.2 / 2),
])
def test_each_quantity_a_batch(name, value):
    t = program_trace.read(BENCH_EVENTS + PROGRAM)
    assert t.per_batch(2)[name] == pytest.approx(value)


@pytest.mark.parametrize("name", ["stream.exposed_ms.video", "stream.stage_ms.video", "stream.waits.video",
                                  "vit.glue_ms.video"])
def test_each_quantity_is_none_without_its_spans(name):
    bare = [e for e in BENCH_EVENTS + PROGRAM if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]
    assert program_trace.read(bare).per_batch(2)[name] is None
    fetch_only = bare + [event("video.fetch#3", "user_annotation", 2700, 900)]
    got = program_trace.read(fetch_only).per_batch(2)[name]
    assert got is None if name != "stream.waits.video" else got == 0.5
    assert program_trace.read(BENCH_EVENTS + PROGRAM).per_batch(0)[name] is None


def test_event_tracer_keeps_the_events():
    from algonauts2025_tpu_torch.utils.profiling import span

    tracer = program_trace.EventTracer()
    with tracer.window():
        with span("video.stack#0"):
            torch.ones(8).sum()
    t = program_trace.read(tracer.events)
    assert [r.name for r in t.spans] == ["video.stack"]
    assert tracer.trace == t.base


def test_traced_run_reports_the_program_on_the_cpu(tiny):
    """``spans.traced_run`` at the tiny size: the result line of a traced
    run, and the program's quantities (no kernel on the CPU: no glue)."""
    line = spans.traced_run(spec(), "video_windows.vitg", 2**33 + 7, 0.3, torch.device("cpu"), root=tiny)
    assert line["batches"] > 0 and "device.idle.video" in line["result"]["metrics"]
    program = line["program"]
    assert program["per_batch"]["stream.stage_ms.video"] > 0
    assert program["per_batch"]["vit.glue_ms.video"] == 0.0
    assert program["per_batch"]["stream.waits.video"] == 0.0
    assert {"video.stack", "video.upload", "video.backbone", "vit.mlp", "video.fetch"} <= set(program["host_ms"])


@pytest.mark.card
def test_card_mlp_kernels_are_launched_in_vit_mlp(tmp_path, cuda):
    """A short traced window of the cell at two layers: the fused MLP's fc1
    GEMM is launched inside ``vit.mlp`` ranges."""
    root = tiny_root(tmp_path)
    for part in ("configs", "traffic", "limits"):
        shutil.rmtree(root / part)
        shutil.copytree(BENCH / part, root / part)
    cfg = json.loads((root / "configs" / "vjepa2_vitg_int8.json").read_text())
    (root / "configs" / "vjepa2_vitg_int8.json").write_text(json.dumps({**cfg, "num_hidden_layers": 2}))
    cell = next(c for c in spec()["workloads"] if c["name"] == "video_windows.vitg")
    traffic = harness.read_json(root / "traffic" / "video_windows.json")
    run = harness.Run(name=cell["name"], cell=cell, config=harness.read_json(root / "configs" / "vjepa2_vitg_int8.json"),
                      traffic=traffic, seed=2**33 + 5, seconds=2.0, device=cuda)
    driver = harness.load_module(root / "drivers" / "video_windows.py").Driver(run)
    driver.prepare()
    tracer = program_trace.EventTracer()
    driver.window(2.0, tracer)
    driver.release()
    t = program_trace.read(tracer.events)
    assert "vit.mlp" in {r.name for r in t.spans}
    launch = {corr: ts for _, ts, corr in t.calls if corr is not None}
    fc1 = [launch.get(corr) for name, _, corr in t.kernels if "StoreGeluQuant" in name]
    assert fc1 and None not in fc1
    assert all(opened[-1] == "vit.mlp" for opened in t.open_at(fc1))
