"""The work the per-layer metrics count, against hand counts and PERF.md's kernel table."""

from __future__ import annotations

import json

import pytest

from benchmark.common.peaks import peaks_for
from benchmark.harness import load_module
from conftest import BENCH

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def metric(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py")


def test_trunk_forward_flops_by_hand():
    tokens = 16 * 298
    projectors = 2 * tokens * (6144 + 2048 + 2816) * 1024
    layer = 2 * tokens * 3072 * (9216 + 3072 + 2 * 12288) + 4 * 16 * 8 * 298 ** 2 * 384
    readout = 2 * tokens * 3072 * 1000 + 2 * 16 * 1000 * 298 * 100
    infonce = 2 * tokens * 2816 * 3072 + 2 * tokens ** 2 * 3072
    hand = projectors + 8 * layer + readout + infonce
    got = metric("train.mfu").forward_flops(config("tribe_trunk"))
    assert got == hand
    assert got == pytest.approx(9.139e12, rel=1e-3)


def test_vitg_batch_work_by_hand():
    work = metric("video.mfu").batch_work(config("vjepa2_vitg_int8"))
    tokens = 4 * 8192
    assert work["int8"] == 2 * tokens * (4 * 1408 ** 2 + 2 * 1408 * 6144) * 40
    assert work["int8"] == pytest.approx(66.1e12, rel=1e-3)
    attention = 4 * 4 * 22 * 8192 ** 2 * 64 * 40
    assert attention == pytest.approx(60.5e12, rel=1e-3)
    assert work["bfloat16"] == attention + 2 * tokens * 1536 * 1408
    # the ideal seconds of a batch: 33.4 ms of int8 and 61.3 ms of bf16
    ideal = metric("video.mfu").ideal_batch_s(config("vjepa2_vitg_int8"), H100)
    assert ideal == pytest.approx(0.0947, rel=2e-3)


@pytest.mark.parametrize("name, cfg, bound_ms, by", [
    ("attention_roofline.train", "tribe_trunk", 0.2606, "operations"),  # row 1: 17.46 GFLOP at 67
    ("flash_roofline.video", "vjepa2_vitg_int8", 1.5286, "operations"),  # row 4: 1.512 TFLOP at 989
    ("int8_mlp_roofline.video", "vjepa2_vitg_int8", 0.5730, "operations"),  # row 7: 1.134 TOP at 1979
])
def test_roofline_bounds_match_the_kernel_table(name, cfg, bound_ms, by):
    bound_s, bound_by = metric(name).call_bound_s(config(cfg), H100)
    assert bound_s * 1e3 == pytest.approx(bound_ms, abs=1e-4) and bound_by == by


def test_flash_bound_terms():
    """Row 4's bytes (369.1 MB) and exponentials (5.906 G ex2 at 4.182e12 a second)."""
    from benchmark.common.peaks import bound_s

    cfg = config("vjepa2_vitg_int8")
    n = 8192
    assert 2 * 4 * 4 * 22 * n * 64 == pytest.approx(369.1e6, rel=1e-3)
    assert H100["exp"] == pytest.approx(4.182e12, rel=1e-3)
    exp_only, by = bound_s(0.0, 0.0, 1.0, H100, exps=4 * 22 * n * n)
    assert by == "exp" and exp_only * 1e3 == pytest.approx(1.412, abs=1e-3)
    assert metric("flash_roofline.video").call_bound_s(cfg, H100)[0] > exp_only


def test_int8_mlp_bytes():
    """Row 7's bytes: 201.9 MB (the bf16 input and output, both int8 weights)."""
    m, k, f = 32768, 1408, 6144
    assert 2 * m * k * 2 + 2 * k * f + 4 * (2 * f + 2 * k) == pytest.approx(201.9e6, rel=1e-3)
