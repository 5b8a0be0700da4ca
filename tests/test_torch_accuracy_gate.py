"""The port's real-data accuracy gate, and the four verdicts in which it
differs from the JAX package's on purpose.

The harness cases of tests/test_accuracy_gate.py that pin no JAX CPU
golden number, on the port: the one-command gate on the synthetic study
against a "reference" made from the port's own outputs must pass, and fail
on perturbed features or shifted metrics.  Then each fixed fault of the
JAX gate, on the same input for both gates:

1. one portable uid standing for two different arrays;
2. more than 10 % of the items missing from the reference export;
3. a feature stage in which every modality was skipped;
4. several seeds whose spread is inside the gate.
"""

import json
import types

import numpy as np
import pandas as pd
import pytest
from test_torch_experiment import _config

from algonauts2025_tpu.data.synthetic import make_synthetic_study
from algonauts2025_tpu.experiment import accuracy_gate as jax_gate
from algonauts2025_tpu_torch.data.helpers import extract_events
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.experiment import accuracy_gate as gate


def _export_fake_reference(exp, ref_root, perturb=0.0, max_items=None):
    """The port's own features in the gate's interchange format,
    optionally perturbed: the stand-in for export_reference_features.py."""
    events = exp.data.get_events()
    features = exp.data.build_features(events)
    rng = np.random.default_rng(7)
    for name in ("text", "audio", "video"):
        feature = features.get(name)
        if feature is None:
            continue
        evs = extract_events(events, types=feature._event_types_helper)[:max_items]
        out_dir = ref_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for e, arr in zip(evs, feature._get_data(evs)):
            arr = np.asarray(arr, np.float32)
            if perturb:
                arr = arr + perturb * rng.standard_normal(arr.shape).astype(np.float32)
            np.save(out_dir / f"{gate.item_key(gate.portable_uid(e))}.npy", arr)


def test_real_data_gate_harness(tmp_path):
    """The one command end to end: a faithful reference passes every stage;
    perturbed features and shifted metrics fail."""
    study_path = make_synthetic_study(tmp_path / "data", with_video=False, n_parcels=16,
                                      duration=40.0)
    cfg = _config(tmp_path, study_path, "gate")
    cfg["n_epochs"] = 1
    cfg["save_checkpoints"] = False
    cfg["infra"] = {"folder": str(tmp_path / "gate_runs"), "mode": "cached"}
    exp = Experiment(**cfg)
    _export_fake_reference(exp, tmp_path / "ref_ok", max_items=20)
    truth = Experiment(**{**cfg, "infra": {"folder": str(tmp_path / "truth"),
                                           "mode": "force"}}).run()
    ref_metrics = tmp_path / "ref_metrics.json"
    ref_metrics.write_text(json.dumps({"val/pearson": [truth["val/pearson"]]}))
    run = dict(seeds=[33], max_items=20)

    verdict = gate.run_gate(cfg, ref_features=tmp_path / "ref_ok", ref_metrics=ref_metrics,
                            out=tmp_path / "report.json", **run)
    assert verdict["complete"] and verdict["passed"], verdict
    text = verdict["features"]["modalities"]["text"]
    assert text["passed"] and text["missing_ratio"] == 0.0 and not text["duplicate_uids"]
    assert verdict["gate"]["rel_diff"] <= 1e-9  # same seed, same pipeline
    assert (tmp_path / "report.json").exists()

    _export_fake_reference(exp, tmp_path / "ref_bad", perturb=0.1, max_items=20)
    bad = gate.run_gate(cfg, ref_features=tmp_path / "ref_bad", ref_metrics=ref_metrics, **run)
    assert not bad["passed"] and not bad["features"]["modalities"]["text"]["passed"]
    assert "skipped" in bad["gate"]  # a failing backbone blocks the recipe

    ref_metrics.write_text(json.dumps({"val/pearson": [truth["val/pearson"] * 1.02 + 0.02]}))
    shifted = gate.run_gate(cfg, ref_features=tmp_path / "ref_ok", ref_metrics=ref_metrics,
                            **run)
    assert shifted["features"]["passed"]
    assert not shifted["gate"]["passed"] and not shifted["passed"]


def test_gate_feature_comparisons_units(tmp_path):
    """Thresholds, missing items and shape guards (the JAX units' cases)."""
    rng = np.random.default_rng(0)
    ref_dir = tmp_path / "audio"
    ref_dir.mkdir()
    a = rng.standard_normal((3, 8, 16)).astype(np.float32)
    np.save(ref_dir / f"{gate.item_key('u1')}.npy", a)
    r = gate.compare_feature_items("audio", [("u1", a)], ref_dir)
    assert r["passed"] and r["compared"] == 1
    b = a.copy()
    b[1] = rng.standard_normal((8, 16))
    r = gate.compare_feature_items("audio", [("u1", b)], ref_dir)
    assert not r["passed"] and r["worst_layer_pearson"] < 0.999
    t = rng.standard_normal((4, 8)).astype(np.float32)
    tdir = tmp_path / "text"
    tdir.mkdir()
    np.save(tdir / f"{gate.item_key('w1')}.npy", t)
    assert gate.compare_feature_items("text", [("w1", t + 2e-3)], tdir)["passed"]
    assert not gate.compare_feature_items("text", [("w1", t + 2e-2)], tdir)["passed"]
    assert not gate.compare_feature_items("audio", [("unknown", a)], ref_dir)["passed"]
    r = gate.compare_feature_items("audio", [("u1", a[:, :, :8])], ref_dir)
    assert not r["passed"] and r["shape_mismatches"]
    # one stimulus in several subjects' timelines: compared once, passes
    r = gate.compare_feature_items("audio", [("u1", a), ("u1", a.copy())], ref_dir)
    assert r["passed"] and r["items"] == 1


def test_gate_stage_single_values_and_means():
    g = gate.gate_stage([0.2000], [0.2005])
    assert not g["compared_on_means"] and g["passed"]
    g = gate.gate_stage([0.195, 0.205], [0.205, 0.1955])
    assert g["compared_on_means"] and g["passed"]
    g = gate.gate_stage([0.195, 0.205], [0.215, 0.225])
    assert g["compared_on_means"] and not g["passed"]


def test_gate_cli_usage():
    with pytest.raises(SystemExit):
        gate.main([])  # nothing to compare


def test_gate_subject_report(tmp_path):
    csv = tmp_path / "ref.csv"
    pd.DataFrame([{"val/pearson": 0.2, "val/subj_pearson/sub-01": 0.21,
                   "val/subj_pearson/sub-02": 0.19}]).to_csv(csv, index=False)
    ours = {"val/pearson": [0.2], "val/subj_pearson/sub-01": [0.215, 0.205]}
    rep = gate.subject_report(ours, csv)
    assert set(rep) == {"val/subj_pearson/sub-01"}
    assert rep["val/subj_pearson/sub-01"]["rel_diff"] == pytest.approx(0.0, abs=1e-12)
    assert gate.subject_report(ours, tmp_path / "ref.json") is None


def test_gate_degenerate_reference_inputs(tmp_path):
    empty = tmp_path / "empty.csv"
    pd.DataFrame({"val/pearson": [float("nan")]}).to_csv(empty, index=False)
    with pytest.raises(ValueError, match="no non-NaN"):
        gate._load_reference_metrics(empty)
    with pytest.raises(ValueError, match=">=1 val/pearson"):
        gate.gate_stage([], [0.2])
    with pytest.raises(ValueError, match="gate undefined"):
        gate.gate_stage([0.2], [0.0])
    nan_csv = tmp_path / "nan.csv"
    pd.DataFrame({"val/pearson": [0.2], "val/subj_pearson/sub-01": [float("nan")]}).to_csv(
        nan_csv, index=False)
    rep = gate.subject_report({"val/subj_pearson/sub-01": [0.2]}, nan_csv)
    assert rep["val/subj_pearson/sub-01"]["rel_diff"] is None


# -- the four fixed faults: the port's verdict against the JAX gate's --------


def test_fix_duplicate_portable_uids(tmp_path):
    """Two stimuli with one file name in two directories share a portable
    uid; the export kept one array.  The other stimulus's features
    correlate with it by chance (r > 0.999): the JAX gate passes, the
    port's fails and names the uid."""
    rng = np.random.default_rng(1)
    ref_dir = tmp_path / "audio"
    ref_dir.mkdir()
    kept = rng.standard_normal((2, 8, 16)).astype(np.float32)
    other = kept + 1e-3 * rng.standard_normal(kept.shape).astype(np.float32)
    uid = "clip.wav_0.00_1.00"
    np.save(ref_dir / f"{gate.item_key(uid)}.npy", kept)
    items = [(uid, kept), (uid, other)]
    assert jax_gate.compare_feature_items("audio", items, ref_dir)["passed"]
    port = gate.compare_feature_items("audio", items, ref_dir)
    assert not port["passed"] and port["duplicate_uids"] == [uid]


def test_fix_missing_reference_items_fail_above_ten_percent(tmp_path):
    """Of 10 items the reference export holds 8, all equal to ours: the JAX
    gate passes on the matching subset, the port's fails on the 20 %
    missing; with 1 of 10 missing both pass."""
    rng = np.random.default_rng(2)
    ref_dir = tmp_path / "video"
    ref_dir.mkdir()
    items = [(f"v{i}.mp4_{i:.2f}_1.00", rng.standard_normal((2, 4, 6)).astype(np.float32))
             for i in range(10)]
    for uid, arr in items[:8]:
        np.save(ref_dir / f"{gate.item_key(uid)}.npy", arr)
    assert jax_gate.compare_feature_items("video", items, ref_dir)["passed"]
    port = gate.compare_feature_items("video", items, ref_dir)
    assert not port["passed"] and port["missing_ratio"] == pytest.approx(0.2)
    np.save(ref_dir / f"{gate.item_key(items[8][0])}.npy", items[8][1])
    assert gate.compare_feature_items("video", items, ref_dir)["passed"]


def test_fix_all_skipped_feature_stage_reports_skipped(tmp_path):
    """A --ref-features directory with no modality subdirectory: the JAX
    stage fails (and would block the recipe as a parity failure), the
    port's reports skipped."""
    events = object()
    exp = types.SimpleNamespace(data=types.SimpleNamespace(
        get_events=lambda: events, build_features=lambda ev: {"text": object()}))
    (tmp_path / "empty_export").mkdir()
    want = jax_gate.feature_stage(exp, tmp_path / "empty_export")
    got = gate.feature_stage(exp, tmp_path / "empty_export")
    assert want["passed"] is False and "skipped" not in want
    assert "skipped" in got and "passed" not in got
    assert "skipped" in got["modalities"]["text"]


def test_fix_seed_means_compared_whenever_several_seeds():
    """Seed spreads inside the gate (0.45 %): the JAX gate compares the
    first seeds (0.2000 vs 0.2011: 0.55 %, fail), the port's the means
    (0.10 %, pass)."""
    ours, ref = [0.2000, 0.2009], [0.2011, 0.2002]
    want, got = jax_gate.gate_stage(ours, ref), gate.gate_stage(ours, ref)
    assert not want["compared_on_means"] and not want["passed"]
    assert got["compared_on_means"] and got["passed"]
    assert got["rel_diff"] == pytest.approx(abs(np.mean(ours) - np.mean(ref)) / np.mean(ref))
