"""Reading a trace: busy time, idle gaps, the breakdown and the rooflines."""

from __future__ import annotations

import json

import pytest

from benchmark.common.trace import read_events
from benchmark.harness import Run, load_module
from conftest import BENCH


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def trace():
    return read_events([
        event("bench.window", "user_annotation", 1000, 100),
        event("bench.train_step", "user_annotation", 1000, 60),
        event("bench.encode_windows_async", "user_annotation", 1070, 20),
        event("void attn_fwd_kernel<4>(Params)", "kernel", 1005, 10),
        event("void attn_fwd_kernel<4>(Params)", "kernel", 1010, 10),  # overlaps the first
        event("Memcpy HtoD", "gpu_memcpy", 1040, 5),
        event("before the window", "kernel", 900, 50),
        event("cudaLaunchKernel", "cuda_runtime", 1001, 2),
    ])


def test_busy_and_gaps():
    t = trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(20e-6)  # [1005, 1020) and [1040, 1045)
    assert t.idle_gaps() == pytest.approx([(0.0, 5e-6), (20e-6, 40e-6), (45e-6, 100e-6)])
    b = t.breakdown()
    assert b["device_ops"][0] == ["void attn_fwd_kernel<4>(Params)", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["encode_windows_async", pytest.approx(55e-6)]
    assert b["idle_gaps"][1] == ["train_step", pytest.approx(20e-6)]


def test_roofline_reads_the_named_kernels():
    cfg = json.loads((BENCH / "configs" / "tribe_trunk.json").read_text())
    run = Run(name="t", cell={}, config=cfg, traffic={}, seed=0, seconds=1, device=None,
              device_name="NVIDIA H100 80GB HBM3", window_s=100e-6, work={"steps": 1})
    run.trace = trace()
    reader = load_module(BENCH / "metrics" / "attention_roofline.train.py")
    bound, _ = reader.call_bound_s(cfg, __import__("benchmark.common.peaks", fromlist=["x"]).peaks_for(run.device_name))
    # the calls the traffic makes (8 layers, forward and remat's recompute),
    # not the two launches in the trace
    assert reader.read(run) == pytest.approx(100 * 16 * bound / 20e-6)
    idle = load_module(BENCH / "metrics" / "device.idle.train.py")
    assert idle.read(run) == pytest.approx(80.0)
    run.trace.device = []
    assert reader.read(run) is None


def test_int8_mlp_roofline_takes_the_quantize_before_fc1():
    cfg = json.loads((BENCH / "configs" / "vjepa2_vitg_int8.json").read_text())
    run = Run(name="t", cell={}, config=cfg, traffic={}, seed=0, seconds=1, device=None,
              device_name="NVIDIA H100 80GB HBM3", work={"batches": 1})
    run.trace = read_events([
        event("bench.window", "user_annotation", 0, 10000),
        event("void i8wg::quantize_kernel<bf16>", "kernel", 10, 50),
        event("void i8wg::gemm_kernel<PingPong, i8wg::StoreDequant<__nv_bfloat16, 0> >", "kernel", 60, 100),
        event("void i8wg::quantize_kernel<bf16>", "kernel", 200, 40),
        event("void i8wg::gemm_kernel<PingPongPairs, i8wg::StoreGeluQuant>", "kernel", 240, 900),
        event("void i8wg::gemm_kernel<Cooperative, i8wg::StoreDequant<__nv_bfloat16, 1> >", "kernel", 1140, 400),
    ])
    reader = load_module(BENCH / "metrics" / "int8_mlp_roofline.video.py")
    bound, _ = reader.call_bound_s(cfg, __import__("benchmark.common.peaks", fromlist=["x"]).peaks_for(run.device_name))
    assert reader.read(run) == pytest.approx(100 * 40 * bound / 1340e-6)  # 40 layers a batch


def test_flash_roofline_counts_the_traffics_calls():
    """A call split into two launches reads as one call: the count is the
    traffic's (a layer a window batch), the launches give only the time."""
    cfg = json.loads((BENCH / "configs" / "vjepa2_vitg_int8.json").read_text())
    run = Run(name="t", cell={}, config=cfg, traffic={}, seed=0, seconds=1, device=None,
              device_name="NVIDIA H100 80GB HBM3", work={"batches": 2})
    run.trace = read_events([
        event("bench.window", "user_annotation", 0, 10000),
        event("void flash_tc_kernel<64, true>(Params)", "kernel", 10, 1000),
        event("void flash_tc_kernel<64, true>(Params)", "kernel", 1010, 1000),
        event("void other_kernel()", "kernel", 2100, 500),
    ])
    reader = load_module(BENCH / "metrics" / "flash_roofline.video.py")
    bound, _ = reader.call_bound_s(cfg, __import__("benchmark.common.peaks", fromlist=["x"]).peaks_for(run.device_name))
    assert reader.read(run) == pytest.approx(100 * 80 * bound / 2000e-6)
    run.work = {"batches": 0}
    assert reader.read(run) is None
