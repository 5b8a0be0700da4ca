"""A run with its timed path broken comes out not correct; the controls fail.

Each test drives the whole of a run through ``harness.execute`` (set-up,
window, release, check, result) at a tiny size on the CPU, with one fault
of the cell driver's ``FAULTS`` planted before the first step.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from conftest import spec

CASES = [("trunk_step.flagship", "half_batch"), ("trunk_step.flagship", "frozen_state"),
         ("video_windows.vitg", "altered_answer")]


def execute(tiny, cell: str, patch=None) -> dict:
    result, checks = harness.execute(spec(trunk=True), cell, 2**31 + 5, 0.3, False, torch.device("cpu"),
                                     time.perf_counter(), root=tiny, patch=patch)
    return {"correct": result["correct"], "checks": checks}


@pytest.mark.parametrize("cell", [c["name"] for c in spec(trunk=True)["workloads"]])
def test_sound_run_is_correct(tiny, card_semantics, cell):
    out = execute(tiny, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_not_correct(tiny, card_semantics, cell, fault):
    kind = next(c for c in spec(trunk=True)["workloads"] if c["name"] == cell)["traffic"]
    traffic = harness.read_json(tiny / "traffic" / f"{kind}.json")
    module = harness.load_module(tiny / "drivers" / f"{traffic['driver']}.py")
    assert fault in module.FAULTS
    out = execute(tiny, cell, patch=module.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("control", ["fp8_attention", "int4_denses"])
def test_video_control_fails_at_a_small_size(tiny, control):
    """Each control (fp8 attention alone, int4 denses alone) reads above a
    limit of the cell."""
    import json

    module = harness.load_module(tiny / "drivers" / "video_windows.py")
    assert set(module.CONTROLS) == {"fp8_attention", "int4_denses"}
    cfg = json.loads((tiny / "configs" / "vjepa2_vitg_int8.json").read_text())
    tr = json.loads((tiny / "traffic" / "video_windows.json").read_text())
    run = harness.Run(name="t", cell={}, config=cfg, traffic=tr, seed=3, seconds=0.1, device=torch.device("cpu"))
    limits = json.loads((harness.ROOT / "limits" / "video_windows.vitg.json").read_text())
    got = module.control(run)[control]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.card
def test_trunk_control_fails_on_the_card(tiny, cuda):
    """The reference's steps on TF32 in the program's place read above the
    cell's limits (a small trunk: 2 layers at the flagship's width)."""
    import json

    module = harness.load_module(tiny / "drivers" / "trunk_step.py")
    cfg = json.loads((harness.ROOT / "configs" / "tribe_trunk.json").read_text())
    cfg["brain_model_config"]["depth"] = 2
    tr = json.loads((harness.ROOT / "traffic" / "trunk_step.json").read_text())
    run = harness.Run(name="t", cell={}, config=cfg, traffic=tr, seed=3, seconds=0.1, device=cuda)
    limits = json.loads((harness.ROOT / "limits" / "trunk_step.flagship.json").read_text())
    numbers = module.control(run)["tf32"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
