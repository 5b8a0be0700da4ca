"""The DeepSeek-V2-Lite cell (``word_stream.dsv2lite``) at its own tiny size on the CPU.

The whole of a run through ``harness.execute`` (set-up, window, release,
check, result): a sound run is correct, a planted fault is not, each
control reads above a limit, and the cell reports its metrics; the
traffic's words, contexts and tokens are as the configuration says.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import BENCH, spec, tiny_root

CELL = "word_stream.dsv2lite"
#: 3 layers (one dense, two MoE), 64 wide, 4 heads of 16 + 8 rotary / 16,
#: 8 experts top-2 of 32 + 1 shared; the published yarn, router and dtypes
TINY_CONFIG = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
               "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8, "n_shared_experts": 1,
               "num_experts_per_tok": 2, "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
               "v_head_dim": 16, "vocab_size": 512, "bos_token_id": 510, "eos_token_id": 511}
#: two transcripts of 40-50 s from 400 words; chains up to 64 tokens, then
#: padded batches of 8 x 64
TINY_TRAFFIC = {"transcripts": 2, "min_transcript_s": 40, "max_transcript_s": 50, "vocabulary": 400,
                "max_context_tokens": 64}
#: the tiny model's sound readings on the CPU (5 seeds): state_gap
#: 0-5.9e-3, first_attention_gap 3.4e-10-6.2e-7, first_attention_core_gap 0,
#: first_moe_gap 0-6.1e-5, no route flipped; the bf16 scores read
#: first_attention_gap 9.5e-4-1.02e-3 and first_attention_core_gap
#: 5.5e-4-6.2e-4, the bf16 router first_moe_gap 2.8e-2-3.4e-2 and 1.8-3.5 %
#: of routes, fp8 experts first_moe_gap 1.28e-2-1.32e-2 (3 seeds)
TINY_LIMITS = {"state_gap": 2e-2, "first_attention_gap": 1e-4, "first_attention_core_gap": 1e-4, "first_moe_gap": 2e-3,
               "route_mismatch_share": 1e-2}


@pytest.fixture
def tiny_text(tmp_path):
    root = tiny_root(tmp_path)
    for part, name, update in (("configs", "deepseek_v2_lite", TINY_CONFIG), ("traffic", "word_stream", TINY_TRAFFIC)):
        path = root / part / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **update}))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return root


def execute(root, trace: bool = False, patch=None, seed: int = 2**31 + 77) -> tuple[dict, list]:
    return harness.execute(spec(), CELL, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(), root=root,
                           patch=patch)


def driver_module(root):
    return harness.load_module(root / "drivers" / "word_stream.py")


def tiny_run(root, seed: int = 3) -> harness.Run:
    cfg = json.loads((root / "configs" / "deepseek_v2_lite.json").read_text())
    tr = json.loads((root / "traffic" / "word_stream.json").read_text())
    return harness.Run(name="t", cell={}, config=cfg, traffic=tr, seed=seed, seconds=0.2, device=torch.device("cpu"))


@pytest.mark.parametrize("seed", [3, 2**31 + 77, 2**40 + 5])
def test_sound_run_is_correct(tiny_text, seed):
    result, checks = execute(tiny_text, seed=seed)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_altered_answer_is_not_correct(tiny_text):
    module = driver_module(tiny_text)
    result, checks = execute(tiny_text, patch=module.FAULTS["altered_answer"])
    assert not result["correct"], checks


def test_each_control_fails_at_a_small_size(tiny_text):
    """The bf16 scores read above the attention's limit; the bf16 router
    above the MoE's limits (routes and output); fp8 experts above the MoE
    output's."""
    module = driver_module(tiny_text)
    assert set(module.CONTROLS) == {"bf16_scores", "bf16_router", "fp8_experts"}
    got = module.control(tiny_run(tiny_text))
    assert got["bf16_scores"]["first_attention_gap"] > TINY_LIMITS["first_attention_gap"], got
    assert got["bf16_scores"]["first_attention_core_gap"] > TINY_LIMITS["first_attention_core_gap"], got
    assert got["bf16_router"]["route_mismatch_share"] > TINY_LIMITS["route_mismatch_share"], got
    assert got["bf16_router"]["first_moe_gap"] > TINY_LIMITS["first_moe_gap"], got
    assert got["fp8_experts"]["first_moe_gap"] > TINY_LIMITS["first_moe_gap"], got


def test_the_cell_reports_its_metrics(tiny_text):
    s = spec()
    cell = next(c for c in s["workloads"] if c["name"] == CELL)
    config = next(c for c in s["configs"] if c["name"] == cell["config"])
    assert config["reduced"] == [] and (BENCH.parent / config["file"]).is_file() and cell["chips"] == 1
    for part, name in (("traffic", "word_stream"), ("limits", CELL), ("drivers", "word_stream")):
        assert (BENCH / part / f"{name}.{'py' if part == 'drivers' else 'json'}").is_file()
    assert {m["name"] for m in harness.cell_metrics(s, CELL, False)} == {"feature_stim_s_per_s", "peak_device_gb",
                                                                          "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(s, CELL, True)} == {"text.mfu", "moe_roofline.text",
                                                                         "device.idle.text"}
    result, _ = execute(tiny_text)
    assert set(result["metrics"]) == {"feature_stim_s_per_s", "setup_s"}  # no device memory on the CPU
    result, _ = execute(tiny_text, trace=True)
    # no grouped-GEMM kernel on the CPU: the roofline is left out
    assert set(result["metrics"]) == {"text.mfu", "device.idle.text"}
    assert 0 < result["metrics"]["text.mfu"]["value"]


def test_window_work_counts_the_port_counters(tiny_text):
    """The window's ``work``: the words answered and their stimulus seconds,
    each forward's valid tokens by row, the port's counters and the MoE's
    expert counts for the window alone."""
    module = driver_module(tiny_text)
    run = tiny_run(tiny_text, seed=9)
    driver = module.Driver(run)
    driver.prepare()
    work = driver.window(0.3, harness.Tracer(False))
    n = work["words"]
    assert n == len(driver.answers) == work["attempted"] > 0 and work["failed"] == 0
    assert work["stim_s"] == pytest.approx(sum(driver.cover[i % len(driver.words)] for i in range(n)))
    lengths = work["forward_lengths"]
    assert len(lengths) == work["forwards"] == work["chain_forwards"] + work["batched_forwards"]
    assert sum(map(sum, lengths)) == work["tokens"] > 0
    k = run.config["num_experts_per_tok"]
    assert np.asarray(work["expert_tokens"]).sum(axis=1).tolist() == [k * work["tokens"]] * 2
    assert lengths[0] == [len(driver.tokenizer(driver.words[0][1]))] or len(lengths[0]) == 1


def test_the_traffic_is_as_configured(tiny_text):
    """Full-size traffic: 4 transcripts of 540-780 s at 2.4-3.0 words a
    second, each word's context its rolling left context of up to 1024
    words, about 1.3 token ids a word; the first ~790 words of a transcript
    within 1024 tokens."""
    module = driver_module(tiny_text)
    traffic = json.loads((BENCH / "traffic" / "word_stream.json").read_text())
    pool = module.make_pool(traffic, 2**33 + 1)
    assert len(pool) == 4
    tok = module.SeededTokenizer(2**33 + 1, 100000)
    for t in pool:
        assert 540 <= t.duration <= 780 and 2.4 <= len(t.words) / t.duration <= 3.0
        assert t.starts[0] == 0 and np.all(np.diff(t.starts) >= 0)
        assert t.cover().sum() == pytest.approx(t.duration)
        assert t.words[0][1] == t.words[0][0]
        assert all(len(c.split(" ")) <= 1025 for _, c in t.words)
        assert all(c.endswith(w) for w, c in t.words)
    words = pool[0].words
    lengths = [len(tok(c)) for _, c in words]
    chain = next(i for i, n in enumerate(lengths) if n > 1024)
    assert 700 <= chain <= 880, chain
    per_word = len(tok(" ".join(w for w, _ in words))) / len(words)
    assert 1.2 <= per_word <= 1.45, per_word


def test_tokenizer_counts_ids_by_letters():
    from benchmark.drivers.word_stream import SeededTokenizer

    tok = SeededTokenizer(7, 100000)
    assert [len(tok(w)) for w in ("a", "abcdef", "abcdefg", "abcdefghij", "abcdefghijk", "abcdefghijkl")] == \
        [1, 1, 2, 2, 3, 3]
    assert tok("ab cd. ef") == tok("ab") + tok("cd") + tok(".") + tok("ef")
    assert tok("end.Next") == tok("end") + tok(".") + tok("next")
    assert tok("ab") != SeededTokenizer(8, 100000)("ab") and max(tok("abcdefghijkl")) < 100000
