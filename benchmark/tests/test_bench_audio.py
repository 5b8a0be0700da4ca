"""The w2v-BERT 2.0 cell (``audio_chunks.w2vbert``) at its own tiny size on the CPU.

The whole of a run through ``harness.execute`` (set-up, window, release,
check, result): a sound run is correct, a planted fault is not, a control
reads above a limit, and the cell reports its metrics; with a program that
has no chunk counters (the port before them), the run still stands and
``audio.mfu`` is left out.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness
from conftest import BENCH, spec, tiny_root

CELL = "audio_chunks.w2vbert"
#: 2 layers at 64 wide, 4 heads, conv 7; the published distance clamp
TINY_CONFIG = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
               "conv_depthwise_kernel_size": 7}
#: two soundtracks of 8-12 s cut into 4 s pieces and a 2-6 s tail: padded
#: 5 s and 10 s buckets, and T > 73 frames, so that the clamp engages
TINY_TRAFFIC = {"soundtracks": 2, "min_soundtrack_s": 8, "max_soundtrack_s": 12, "max_duration": 4,
                "min_duration": 2}
#: the tiny model's sound readings on the CPU: 1.6e-3 to 2.5e-3 (a bf16
#: flip the frontend's float32 differences set off moves its layer by up
#: to 2^-8), the attention 4e-6 to 4.3e-4; fp8 denses read 4e-2 and more
TINY_LIMITS = {"state_gap": 1e-2, "first_layer_gap": 1e-2, "first_attention_gap": 1e-3}


@pytest.fixture
def tiny_audio(tmp_path):
    root = tiny_root(tmp_path)
    for part, name, update in (("configs", "w2v_bert2", TINY_CONFIG), ("traffic", "audio_chunks", TINY_TRAFFIC)):
        path = root / part / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **update}))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return root


def execute(root, trace: bool = False, patch=None, seed: int = 2**31 + 77) -> tuple[dict, list]:
    return harness.execute(spec(), CELL, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(), root=root,
                           patch=patch)


def driver_module(root):
    return harness.load_module(root / "drivers" / "audio_chunks.py")


@pytest.mark.parametrize("seed", [3, 2**31 + 77, 2**40 + 5])
def test_sound_run_is_correct(tiny_audio, seed):
    result, checks = execute(tiny_audio, seed=seed)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_altered_answer_is_not_correct(tiny_audio):
    module = driver_module(tiny_audio)
    result, checks = execute(tiny_audio, patch=module.FAULTS["altered_answer"])
    assert not result["correct"], checks


def test_a_control_fails_at_a_small_size(tiny_audio):
    """fp8 denses read above every limit; bf16 scores above the attention's."""
    module = driver_module(tiny_audio)
    assert set(module.CONTROLS) == {"bf16_scores", "fp8_denses"}
    cfg = json.loads((tiny_audio / "configs" / "w2v_bert2.json").read_text())
    tr = json.loads((tiny_audio / "traffic" / "audio_chunks.json").read_text())
    run = harness.Run(name="t", cell={}, config=cfg, traffic=tr, seed=3, seconds=0.1, device=torch.device("cpu"))
    got = module.control(run)
    assert all(got["fp8_denses"][k] > TINY_LIMITS[k] for k in TINY_LIMITS), got
    assert got["bf16_scores"]["first_attention_gap"] > TINY_LIMITS["first_attention_gap"], got


def test_the_cell_reports_its_metrics(tiny_audio):
    s = spec()
    cell = next(c for c in s["workloads"] if c["name"] == CELL)
    config = next(c for c in s["configs"] if c["name"] == cell["config"])
    assert config["reduced"] == [] and (BENCH.parent / config["file"]).is_file() and cell["chips"] == 1
    for part, name in (("traffic", "audio_chunks"), ("limits", CELL), ("drivers", "audio_chunks")):
        assert (BENCH / part / f"{name}.{'py' if part == 'drivers' else 'json'}").is_file()
    assert {m["name"] for m in harness.cell_metrics(s, CELL, False)} == {"feature_stim_s_per_s", "peak_device_gb",
                                                                          "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(s, CELL, True)} == {"audio.mfu", "device.idle.audio"}
    result, _ = execute(tiny_audio)
    assert set(result["metrics"]) == {"feature_stim_s_per_s", "setup_s"}  # no device memory on the CPU
    result, _ = execute(tiny_audio, trace=True)
    assert set(result["metrics"]) == {"audio.mfu", "device.idle.audio"}
    assert 0 < result["metrics"]["audio.mfu"]["value"]


def test_a_program_without_the_counters_leaves_audio_mfu_out(tiny_audio):
    """The port before its chunk counters: the run is correct and its
    traced line lacks ``audio.mfu`` alone."""

    class WithoutCounters:
        def __init__(self, backbone) -> None:
            self._backbone = backbone

        def __getattr__(self, name: str):
            if name in ("counts", "reset_counts"):
                raise AttributeError(name)
            return getattr(self._backbone, name)

    def without_counters(driver) -> None:
        driver.backbone = WithoutCounters(driver.backbone)

    result, checks = execute(tiny_audio, trace=True, patch=without_counters)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"device.idle.audio"}


def test_window_work_counts_the_port_counters(tiny_audio):
    """The window's ``work``: the chunks answered, their stimulus seconds,
    and the port's counters for the window alone (the warm-up's reset)."""
    module = driver_module(tiny_audio)
    cfg = json.loads((tiny_audio / "configs" / "w2v_bert2.json").read_text())
    tr = json.loads((tiny_audio / "traffic" / "audio_chunks.json").read_text())
    run = harness.Run(name="t", cell={}, config=cfg, traffic=tr, seed=9, seconds=0.2, device=torch.device("cpu"))
    driver = module.Driver(run)
    driver.prepare()
    work = driver.window(0.2, harness.Tracer(False))
    order = driver.order[:work["chunks"]]
    valid = [module.valid_frames(len(driver.pool[i][0]), driver.pool[i][1]) for i in order]
    buckets = [(1 + (module.bucket_of(len(driver.pool[i][0]), driver.pool[i][1], 5) - 400) // 160) // 2
               for i in order]
    assert work["chunks"] == len(driver.answers) == driver.backbone.counts["chunks"] > 0
    assert work["chunk_frames"] == valid and work["frames"] == sum(valid)
    assert work["padded_frames"] == sum(buckets) - sum(valid) > 0
    assert work["stim_s"] == pytest.approx(sum(driver.pool[i][2] for i in order))
