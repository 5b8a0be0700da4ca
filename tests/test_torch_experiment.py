"""The port's Experiment against the JAX package's, on the CPU.

Both packages read the same synthetic study (tests/test_experiment_e2e.py's
text-only config).  Held equal: the event table, the segments, the fmri and
subject_id batches, the cache and task uids, and the LLAMA3p2 features when
both backbones carry the JAX tiny backbone's weights.  End to end, the
port's ``Experiment.run()`` starts from the JAX run's initial trunk weights
and must give the same per-epoch train loss (rtol 1e-4, the trunk limit of
tests/test_torch_training.py), per-voxel pearson and submission arrays.
The trimodal twin of tests/test_experiment_e2e.py's trimodal run adds the
Wav2VecBert and VJEPA2 features, each backbone with the JAX tiny
backbone's weights.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from algonauts2025_tpu.config import ConfDict
from algonauts2025_tpu.config.uid import config_uid as jax_config_uid
from algonauts2025_tpu.data.synthetic import make_synthetic_study
from algonauts2025_tpu.experiment import Experiment as JaxExperiment
from algonauts2025_tpu.experiment.data import Data as JaxData
from algonauts2025_tpu.features import audio as jaudio
from algonauts2025_tpu.features import text as jt
from algonauts2025_tpu.features import video as jvideo
from algonauts2025_tpu.training import trainer as jax_trainer
from algonauts2025_tpu_torch.config.uid import config_uid
from algonauts2025_tpu_torch.data import synthetic as port_synthetic
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.experiment.data import Data
from algonauts2025_tpu_torch.features import audio as ta
from algonauts2025_tpu_torch.features import text as tt
from algonauts2025_tpu_torch.features import video as tv
from algonauts2025_tpu_torch.models import (
    flax_params_to_torch, llama_params_to_torch, vjepa2_params_to_torch,
    wav2vec_bert_params_to_torch,
)
from algonauts2025_tpu_torch.training import trainer as port_trainer

#: every pearson.npy and submission value: atol 1e-4 (the largest differences
#: read on the CPU: 1.0e-7 for pearson, 8.6e-7 for the submission)
ARTIFACT_ATOL = 1e-4


def _config(root, study_path, name):
    """tests/test_experiment_e2e.py::_config, with the CPU named for the
    trainer and the text backbone (both excluded from every uid)."""
    cache = str(root / f"cache_{name}")
    return ConfDict(
        {
            "infra": {"folder": str(root / f"run_{name}"), "mode": "force"},
            "accelerator": "cpu",
            "data": {
                "num_workers": 0,
                "batch_size": 4,
                "study": {
                    "path": str(study_path),
                    "query": None,
                    "infra": {"folder": cache},
                    "enhancers": [
                        {"name": "AddText"},
                        {"name": "AddSentenceToWords", "max_unmatched_ratio": 0.3},
                        {"name": "AddContextToWords", "sentence_only": False,
                         "max_context_len": 64},
                        {"name": "RemoveMissing"},
                    ],
                },
                "neuro": {"name": "Fmri", "infra": {"folder": cache}},
                "text_feature": {
                    "name": "LLAMA3p2",
                    "model_name": "tiny-random",
                    "device": "cpu",
                    "infra": {"folder": cache},
                },
                "layers": [0.5, 1.0],
                "layer_aggregation": "group_mean",
            },
            "brain_model_config": {
                "name": "FmriEncoder",
                "hidden": 96,
                "depth": 1,
                "heads": 4,
                "modality_dropout": 0.0,
            },
            "metrics": [
                {"log_name": "pearson", "name": "MultidimPearsonCorrCoef"},
                {"log_name": "subj_pearson", "name": "GroupedMetric",
                 "metric_name": "MultidimPearsonCorrCoef"},
            ],
            "loss": {"name": "MSELoss"},
            "optim": {
                "optimizer": {"name": "Adam", "lr": 1e-3},
                "scheduler": {"name": "OneCycleLR",
                              "kwargs": {"max_lr": 1e-3, "pct_start": 0.1}},
            },
            "n_epochs": 2,
            "seed": 33,
            "wandb_config": None,
            "save_checkpoints": True,
        }
    ).to_dict()


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("study")
    return root, make_synthetic_study(root / "data", with_video=False, n_parcels=32,
                                      duration=40.0)


@pytest.fixture(scope="module")
def tiny_text():
    """The JAX tiny backbone and the port's with the same weights."""
    jax_backbone = jt.TinyTextBackbone()
    port = tt.TinyTextBackbone(state_dict=llama_params_to_torch(jax_backbone.params),
                               device="cpu")
    return jax_backbone, port


@pytest.fixture(scope="module")
def events(study):
    root, path = study
    cfg = _config(root, path, "events")
    return JaxData(**cfg["data"]).get_events(), Data(**cfg["data"]).get_events()


def test_synthetic_study_files_are_identical(study, tmp_path):
    root, path = study
    port_path = port_synthetic.make_synthetic_study(tmp_path / "data", with_video=False,
                                                    n_parcels=32, duration=40.0)
    want = sorted(p.relative_to(path) for p in path.rglob("*") if p.is_file())
    got = sorted(p.relative_to(port_path) for p in port_path.rglob("*") if p.is_file())
    assert got == want and len(got) > 5
    for rel in want:
        if rel.suffix == ".h5":  # HDF5 headers hold timestamps: compare the arrays
            import h5py

            with h5py.File(path / rel) as a, h5py.File(port_path / rel) as b:
                assert sorted(a) == sorted(b)
                for key in a:
                    np.testing.assert_array_equal(a[key][()], b[key][()])
        else:
            assert (port_path / rel).read_bytes() == (path / rel).read_bytes(), rel


def test_events_equal_jax(events):
    want, got = events
    assert len(got) > 100 and {"Word", "Fmri", "Sentence"} <= set(got.type)
    assert set(got.split.dropna()) == {"train", "val", "test"}
    pd.testing.assert_frame_equal(got, want)


def test_segments_and_batches_equal_jax(study, events):
    """Segments, and the fmri / subject_id batches of every split, exactly."""
    root, path = study
    cfg = _config(root, path, "batches")
    cfg["data"]["text_feature"] = None
    want = JaxData(**cfg["data"]).get_datasets(events[0])
    got = Data(**cfg["data"]).get_datasets(events[1])
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for split in want:
        assert len(got[split]) == len(want[split]) > 0
        for a, b in zip(got[split].segments, want[split].segments):
            assert (a.start, a.duration) == (b.start, b.duration)
            pd.testing.assert_frame_equal(a.events, b.events)
        (gb,) = list(got[split].batches(batch_size=len(got[split])))
        (wb,) = list(want[split].batches(batch_size=len(want[split])))
        assert sorted(gb.data) == sorted(wb.data) == ["fmri", "subject_id"]
        for key in wb.data:
            assert gb.data[key].dtype == wb.data[key].dtype
            np.testing.assert_array_equal(gb.data[key], wb.data[key])
    # the threaded, shuffled path yields the same batches as the JAX package's
    order = [list(ds.batches(batch_size=3, shuffle=True, seed=5, num_workers=2))
             for ds in (got["train"], want["train"])]
    assert len(order[0]) == len(order[1])
    for gb, wb in zip(*order):
        np.testing.assert_array_equal(gb.data["fmri"], wb.data["fmri"])
        np.testing.assert_array_equal(gb.data["subject_id"], wb.data["subject_id"])


def test_uids_equal_jax(study):
    root, path = study
    cfg = _config(root, path, "uids")
    port, ref = Experiment(**cfg), JaxExperiment(**cfg)
    assert port.infra.uid() == ref.infra.uid()
    for name in ("study", "neuro", "text_feature"):
        assert config_uid(getattr(port.data, name)) == jax_config_uid(getattr(ref.data, name))
    # placement fields stay out of the uids, semantics split them
    other = dict(cfg, n_devices=8, model_parallel=2, profile=True, accelerator="cuda")
    assert Experiment(**other).infra.uid() == port.infra.uid()
    assert Experiment(**dict(cfg, seed=99)).infra.uid() != port.infra.uid()
    feat = dict(cfg["data"]["text_feature"], device="cuda", batch_size=2, pipeline_stages=2,
                layers=[1.0])
    assert config_uid(tt.LLAMA3p2(**feat)) == config_uid(port.data.text_feature)
    assert config_uid(tt.LLAMA3p2(**dict(feat, max_context_tokens=7))) != config_uid(
        port.data.text_feature)


def test_text_features_equal_jax(study, events, tiny_text, tmp_path):
    from algonauts2025_tpu.core.events import Word as JaxWord
    from algonauts2025_tpu_torch.core.events import Word

    root, path = study
    cfg = _config(tmp_path, path, "text")["data"]["text_feature"]
    jax_feat, port_feat = jt.LLAMA3p2(**cfg), tt.LLAMA3p2(**cfg)
    jax_feat.set_backbone(tiny_text[0])
    port_feat.set_backbone(tiny_text[1])
    words = [(r.text, r.context, r.start, r.duration) for r in
             events[1][events[1].type == "Word"].itertuples()][:80]
    want = jax_feat._get_data([JaxWord(text=t, context=c, start=s, duration=d, timeline="t")
                               for t, c, s, d in words])
    got = port_feat._get_data([Word(text=t, context=c, start=s, duration=d, timeline="t")
                               for t, c, s, d in words])
    assert len(got) == len(want) == 80
    for g, w in zip(got, want):
        assert g.shape == w.shape == (5, 64)
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6)


def _jax_run(cfg, monkeypatch):
    """The JAX Experiment; returns it, its output and its initial params."""
    captured = {}
    orig = jax_trainer.BrainTrainer.init_state

    def init_state(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        captured["params"] = flax_params_to_torch(jax.tree.map(np.asarray, self.state.params))
        return out

    monkeypatch.setattr(jax_trainer.BrainTrainer, "init_state", init_state)
    exp = JaxExperiment(**cfg)
    out = exp.run()
    monkeypatch.undo()
    return exp, out, captured["params"]


def _port_run(cfg, backbone, init_params, monkeypatch, audio=None, video=None):
    orig = port_trainer.BrainTrainer.init_state

    def init_state(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.model.load_state_dict(init_params, strict=True)

    monkeypatch.setattr(port_trainer.BrainTrainer, "init_state", init_state)
    exp = Experiment(**cfg)
    exp.data.text_feature.set_backbone(backbone)
    if audio is not None:
        exp.data.audio_feature.set_backbone(audio)
    if video is not None:
        exp.data.video_feature.set_backbone(video)
    out = exp.run()
    monkeypatch.undo()
    return exp, out


def _assert_same_artifacts(port_dir, ref_dir, n_parcels, subjects):
    np.testing.assert_allclose(np.load(port_dir / "pearson.npy"),
                               np.load(ref_dir / "pearson.npy"), atol=ARTIFACT_ATOL)
    sub = np.load(port_dir / "submission.npy", allow_pickle=True).item()
    ref_sub = np.load(ref_dir / "submission.npy", allow_pickle=True).item()
    assert set(sub) == set(ref_sub) == set(subjects)
    for subject, chunks in ref_sub.items():
        assert set(sub[subject]) == set(chunks)
        for chunk, arr in chunks.items():
            assert sub[subject][chunk].shape == arr.shape and arr.shape[1] == n_parcels
            np.testing.assert_allclose(sub[subject][chunk], arr, atol=ARTIFACT_ATOL)


def test_experiment_matches_jax_end_to_end(study, tiny_text, tmp_path, monkeypatch):
    root, path = study
    ref_exp, ref_out, init_params = _jax_run(_config(tmp_path, path, "jax"), monkeypatch)
    cfg = _config(tmp_path, path, "port")
    exp, out = _port_run(cfg, tiny_text[1], init_params, monkeypatch)

    want = [r["train/loss"] for r in ref_exp._trainer.history]
    got = [r["train/loss"] for r in exp._trainer.history]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(out["val/pearson"]) and not any(k.startswith("test/") for k in out)

    port_dir, ref_dir = tmp_path / "run_port", tmp_path / "run_jax"
    for artifact in ["config.yaml", "metrics.csv", "metrics.jsonl", "pearson.npy",
                     "submission.zip", "last.ckpt"]:
        assert (port_dir / artifact).exists(), artifact
    _assert_same_artifacts(port_dir, ref_dir, 32, {"sub-01", "sub-02", "sub-03", "sub-05"})
    # one JSONL record per epoch, logged by the trainer
    assert len((port_dir / "metrics.jsonl").read_text().splitlines()) == 2
    # the caches of both packages carry the same uids
    assert sorted(p.name for p in (tmp_path / "cache_port").iterdir()) == sorted(
        p.name for p in (tmp_path / "cache_jax").iterdir())

    # task cache: rerun with mode=cached returns without building a trainer
    cached = Experiment(**dict(cfg, infra={**cfg["infra"], "mode": "cached"}))
    assert cached.run() == out and cached._trainer is None


def test_experiment_test_metrics_with_real_targets(study, tmp_path, monkeypatch):
    """The test-split guard: with real Fmri targets in the test split the
    test/* metrics are scored against them (tests/test_experiment_e2e.py)."""
    root, path = study
    cfg = _config(tmp_path, path, "targets")
    cfg["n_epochs"] = 1
    orig = Data.get_events

    def with_targeted_test(self):
        ev = orig(self)
        chunk = ev.loc[ev.split == "train", "chunk"].iloc[0]
        ev.loc[ev.chunk == chunk, "split"] = "test"
        return ev

    monkeypatch.setattr(Data, "get_events", with_targeted_test)
    monkeypatch.setattr(Experiment, "write_submission", lambda self, *a, **k: None)
    out = Experiment(**cfg).run()
    assert np.isfinite(out["test/pearson"])
    assert out["test/pearson"] != 0.0  # scored against real targets
    assert np.isfinite(out["test/loss"])


@pytest.mark.parametrize("override,match", [
    ({"n_devices": 2}, "torchrun --nproc-per-node 2"),
    ({"model_parallel": 2}, "not divisible by model_parallel=2"),
])
def test_unported_options_raise(study, tmp_path, override, match):
    """A mesh the launch cannot give raises before anything trains: two
    devices in a one-process launch (the error names the torchrun command
    that gives them), and a model axis wider than the devices (the JAX
    ``get_mesh`` raises so too)."""
    root, path = study
    with pytest.raises(ValueError, match=match):
        Experiment(**dict(_config(tmp_path, path, "unported"), **override)).run()


def test_unported_features_raise(study, tmp_path, monkeypatch):
    """The audio and video features are accepted; their device-topology
    options build on the CPU (the shards or stages all on it) and give the
    one-device backbone's features; on the card, more shards or stages
    than visible cards raise, as the JAX ``_sp_mesh`` does."""
    root, path = study
    data = _config(tmp_path, path, "features")["data"]
    built = Data(**dict(data, audio_feature={"name": "Wav2VecBert"},
                        video_feature={"name": "VJEPA2"}))
    assert isinstance(built.audio_feature, ta.Wav2VecBert)
    assert isinstance(built.video_feature, tv.VJEPA2)
    assert built.video_feature.layers == data["layers"]

    video = tv.VJEPA2(model_name="tiny-random", device="cpu", sequence_parallel=2).backbone
    plain = tv.VJEPA2(model_name="tiny-random", device="cpu").backbone
    assert video.sequence_parallel and video.mesh.shape == {"seq": 2}
    windows = np.random.default_rng(0).integers(0, 255, (2, 8, 32, 32, 3), dtype=np.uint8)
    # the tiny default is static int8 (the tolerance of the JAX quantized SP test)
    np.testing.assert_allclose(video.encode_windows(windows), plain.encode_windows(windows),
                               atol=5e-5)
    text = tt.LLAMA3p2(model_name="tiny-random", device="cpu", pipeline_stages=2).backbone
    one = tt.LLAMA3p2(model_name="tiny-random", device="cpu").backbone
    assert text.pipeline_mesh.shape == {"stage": 2}
    ids, mask = one.encode(["the cat sat", "on the mat today"])
    np.testing.assert_allclose(text.hidden_states(ids, mask), one.hidden_states(ids, mask),
                               rtol=0, atol=1e-5)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        tv._sp_mesh(2, torch.device("cuda"))
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        tt._pp_mesh(2, torch.device("cuda"))


def test_no_card_means_no_run(study, tmp_path, monkeypatch):
    """accelerator="cuda" and device="auto" raise without a card; nothing
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, path = study
    cfg = _config(tmp_path, path, "nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(**dict(cfg, accelerator="cuda")).run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.LLAMA3p2(model_name="tiny-random").backbone


def test_named_model_without_weights_raises(monkeypatch):
    """A named model whose weights cannot be read raises, never falling
    back to random weights; the loader reads the local HF cache only."""
    seen = {}

    def missing(model_name, device=None, pipeline_stages=0):
        seen["args"] = (model_name, device, pipeline_stages)
        raise OSError("not in the local cache")

    monkeypatch.setattr(tt, "load_hf_text_backbone", missing)
    feat = tt.LLAMA3p2(model_name="meta-llama/Llama-3.2-3B", device="cpu")
    with pytest.raises(RuntimeError, match="refusing to substitute random weights"):
        feat.backbone
    assert seen["args"] == ("meta-llama/Llama-3.2-3B", torch.device("cpu"), 0)
    assert feat._backbone is None


def test_loss_config_surface():
    """Experiment.loss takes the JAX package's loss names, and every one
    builds (each held to JAX in test_torch_losses_optim.py); a changed
    torch kwarg and an unknown name raise."""
    import pydantic

    from algonauts2025_tpu_torch.training.losses import LossConfig, build_loss, mse_loss

    adapter = pydantic.TypeAdapter(LossConfig)
    assert build_loss(adapter.validate_python({"name": "MSELoss"})) is mse_loss
    pearson = build_loss(adapter.validate_python({"name": "PearsonLoss", "dim": 0}))
    assert pearson(torch.ones(3, 2), torch.ones(3, 2)).ndim == 0
    huber = build_loss(adapter.validate_python({"name": "HuberLoss"}))
    assert float(huber(torch.zeros(2, 2), torch.full((2, 2), 3.0))) == pytest.approx(2.5)
    with pytest.raises(ValueError, match="unsupported kwargs"):
        build_loss(adapter.validate_python({"name": "HuberLoss", "kwargs": {"reduction": "sum"}}))
    with pytest.raises(pydantic.ValidationError):
        adapter.validate_python({"name": "NoSuchLoss"})


def test_llama3p2_named_model_reads_local_hf_files(tmp_path):
    """A named model is read from local HF files (a tiny random LlamaModel
    and a word-level tokenizer saved in the test): its weights arrive in
    the bf16 backbone as the HF converter maps them, and the feature runs."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaModel, PreTrainedTokenizerFast

    from algonauts2025_tpu_torch.core.events import Word
    from algonauts2025_tpu_torch.models.backbones import llama as tl

    torch.manual_seed(0)
    hf = LlamaModel(HFConfig(vocab_size=16, hidden_size=32, intermediate_size=48,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             rope_theta=500000.0))
    hf.save_pretrained(tmp_path)
    vocab = {w: i for i, w in enumerate(["<pad>", "<unk>", *"the quick brown fox".split()])}
    word_level = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    word_level.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=word_level, pad_token="<pad>",
                            unk_token="<unk>").save_pretrained(tmp_path)

    feat = tt.LLAMA3p2(model_name=str(tmp_path), device="cpu")
    backbone = feat.backbone
    assert feat._backbone_owned and backbone.pad_id == 0
    assert backbone.model.cfg.dtype == torch.bfloat16 and backbone.model.cfg.num_layers == 2
    want = tl.params_from_hf({k: v.numpy() for k, v in hf.state_dict().items()},
                             backbone.model.cfg)
    got = backbone.model.state_dict()
    for name, value in want.items():
        torch.testing.assert_close(got[name], torch.as_tensor(value).to(got[name].dtype))
    assert backbone._tokenize_full("the quick fox") == [2, 3, 5]
    words = [("the", "the"), ("quick", "the quick"), ("fox", "the quick fox")]
    events = [Word(start=0.5 * i, duration=0.4, text=w, context=c, timeline="t")
              for i, (w, c) in enumerate(words)]
    out = [np.asarray(x) for x in feat._compute(events)]
    assert len(out) == 3 and all(o.shape == (3, 32) and np.isfinite(o).all() for o in out)


# -- the trimodal twin of tests/test_experiment_e2e.py -----------------------
@pytest.fixture(scope="module")
def trimodal_study(tmp_path_factory):
    root = tmp_path_factory.mktemp("trimodal")
    return root, make_synthetic_study(root / "data", with_video=True, n_parcels=16,
                                      duration=24.0, subjects=("sub-01",),
                                      train_episodes=("e01a", "e01b"), test_episodes=("e01a",))


@pytest.fixture(scope="module")
def tiny_audio_video():
    """The port's tiny audio and video backbones with the weights of the JAX
    tiny backbones that ``model_name="tiny-random"`` builds (the static
    int8 video backbone calibrates itself, as the JAX one does)."""
    audio = ta.TinyAudioBackbone(
        state_dict=wav2vec_bert_params_to_torch(jaudio.TinyAudioBackbone().params), device="cpu")
    video = tv.TinyVideoBackbone(
        quantize=True, quant_static=True, device="cpu",
        state_dict=vjepa2_params_to_torch(jvideo.TinyVideoBackbone(quantize=True).params))
    return audio, video


def _trimodal_config(root, study_path, name):
    """tests/test_experiment_e2e.py::test_experiment_trimodal_end_to_end's
    config, with two epochs and no modality dropout: its draws come from
    each package's own generator, so equal losses need none."""
    cfg = _config(root, study_path, name)
    cache = cfg["data"]["text_feature"]["infra"]["folder"]
    cfg["data"]["study"]["enhancers"].append({"name": "ExtractAudioFromVideo"})
    cfg["data"]["audio_feature"] = {"name": "Wav2VecBert", "model_name": "tiny-random",
                                    "device": "cpu", "infra": {"folder": cache}}
    cfg["data"]["video_feature"] = {"name": "VJEPA2", "model_name": "tiny-random",
                                    "window_batch": 2, "device": "cpu",
                                    "infra": {"folder": cache}}
    cfg["brain_model_config"].update(contrastive_enabled=True, contrastive_modalities=["video"],
                                     modality_dropout=0.0)
    return cfg


def test_trimodal_feature_uids_equal_jax(trimodal_study, tmp_path):
    root, path = trimodal_study
    cfg = _trimodal_config(tmp_path, path, "uids")
    port, ref = Experiment(**cfg), JaxExperiment(**cfg)
    assert port.infra.uid() == ref.infra.uid()
    for name in ("audio_feature", "video_feature"):
        assert config_uid(getattr(port.data, name)) == jax_config_uid(getattr(ref.data, name))
    # placement and padding stay out of the uids, semantics split them
    audio, video = cfg["data"]["audio_feature"], cfg["data"]["video_feature"]
    base_a, base_v = config_uid(ta.Wav2VecBert(**audio)), config_uid(tv.VJEPA2(**video))
    assert config_uid(ta.Wav2VecBert(**dict(audio, bucket_seconds=0, device="cuda",
                                            layers=[1.0]))) == base_a
    assert config_uid(tv.VJEPA2(**dict(video, window_batch=8, sequence_parallel=4,
                                       device="cuda"))) == base_v
    assert config_uid(ta.Wav2VecBert(**dict(audio, model_name="other"))) != base_a
    assert config_uid(tv.VJEPA2(**dict(video, quantize=False))) != base_v
    for feature, jax_feature in ((ta.Wav2VecBert, jaudio.Wav2VecBert), (tv.VJEPA2, jvideo.VJEPA2)):
        assert feature._exclude_from_cache_uid(feature()) == jax_feature._exclude_from_cache_uid(
            jax_feature())


def test_trimodal_features_equal_jax(trimodal_study, tiny_audio_video, tmp_path):
    """Wav2VecBert and VJEPA2 over the synthetic study's Sound and Video
    events, against the JAX features' own ``_compute`` (tolerances of
    tests/test_torch_audio.py and tests/test_torch_video.py).  VJEPA2 runs
    its float backbone here: on these decoded frames the static int8 one
    rounds a few activations that sit on a rounding tie to the other side
    of it in one package (the two resizes differ by ~1e-6), which moves
    whole windows; the int8 path is held to JAX on seeded windows in
    tests/test_torch_video.py and end to end below."""
    root, path = trimodal_study
    cfg = _trimodal_config(tmp_path, path, "features")
    cfg["data"]["video_feature"].update(quantize=False, quant_static=False)
    events = Data(**cfg["data"]).get_events()
    float_video = tv.TinyVideoBackbone(
        device="cpu", state_dict=vjepa2_params_to_torch(jvideo.TinyVideoBackbone().params))
    pairs = [("audio_feature", "Sound", tiny_audio_video[0], dict(atol=1e-4, rtol=1e-4)),
             ("video_feature", "Video", float_video, dict(atol=3e-4, rtol=1e-3))]
    from algonauts2025_tpu.core import events as jax_events
    from algonauts2025_tpu_torch.core import events as port_events

    for name, kind, backbone, tol in pairs:
        rows = events[events.type == kind].drop_duplicates("filepath")
        assert len(rows) == 3  # two train and one test stimulus
        fields = [dict(filepath=r.filepath, start=r.start, duration=r.duration, offset=r.offset,
                       timeline=r.timeline) for r in rows.itertuples()]
        port_feat = (ta.Wav2VecBert if kind == "Sound" else tv.VJEPA2)(**cfg["data"][name])
        port_feat.set_backbone(backbone)
        jax_cls = jaudio.Wav2VecBert if kind == "Sound" else jvideo.VJEPA2
        jax_feat = jax_cls(**{k: v for k, v in cfg["data"][name].items() if k != "device"})
        got = list(port_feat._compute([getattr(port_events, kind)(**f) for f in fields]))
        want = list(jax_feat._compute([getattr(jax_events, kind)(**f) for f in fields]))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, **tol)
        assert [port_feat.item_uid(e) for e in [getattr(port_events, kind)(**f) for f in fields]] \
            == [jax_feat.item_uid(e) for e in [getattr(jax_events, kind)(**f) for f in fields]]


def test_trimodal_experiment_matches_jax_end_to_end(trimodal_study, tiny_text, tiny_audio_video,
                                                   tmp_path, monkeypatch):
    """The twin of tests/test_experiment_e2e.py::test_experiment_trimodal_end_to_end:
    from the JAX run's initial trunk weights and the JAX tiny backbones'
    weights, the same per-epoch train loss, pearson.npy and submission."""
    root, path = trimodal_study
    ref_exp, ref_out, init_params = _jax_run(_trimodal_config(tmp_path, path, "jax"), monkeypatch)
    cfg = _trimodal_config(tmp_path, path, "port")
    exp, out = _port_run(cfg, tiny_text[1], init_params, monkeypatch, *tiny_audio_video)
    assert set(exp._trainer.model.projectors) == {"text", "audio", "video"}
    want = [r["train/loss"] for r in ref_exp._trainer.history]
    got = [r["train/loss"] for r in exp._trainer.history]
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(out["val/pearson"])
    # the generator writes test timelines for every release subject
    _assert_same_artifacts(tmp_path / "run_port", tmp_path / "run_jax", 16,
                           {"sub-01", "sub-02", "sub-03", "sub-05"})
    assert sorted(p.name for p in (tmp_path / "cache_port").iterdir()) == sorted(
        p.name for p in (tmp_path / "cache_jax").iterdir())


@pytest.mark.parametrize("feature,hf_model,port_loader", [
    (ta.Wav2VecBert, "Wav2Vec2BertModel", "load_hf_audio_backbone"),
    (tv.VJEPA2, "AutoModel", "load_hf_video_backbone"),
])
def test_named_audio_video_models_read_local_files_only(monkeypatch, feature, hf_model,
                                                        port_loader):
    """A named model is read from the local HF cache only; when it cannot
    be read the feature raises and keeps no backbone (no random weights)."""
    import transformers

    seen = {}

    def missing(name, **kwargs):
        seen.update(kwargs, name=name)
        raise OSError("not in the local cache")

    monkeypatch.setattr(getattr(transformers, hf_model), "from_pretrained", missing)
    feat = feature(device="cpu")
    with pytest.raises(RuntimeError, match="refusing to substitute random weights"):
        feat.backbone
    assert seen == {"name": feat.model_name, "local_files_only": True}
    assert feat._backbone is None and port_loader in (ta.__all__ + tv.__all__)


def test_audio_of_a_video_event_reads_its_wav_sibling(trimodal_study, tmp_path):
    """Wav2VecBert on a ``Video`` event reads the ``.wav`` demuxed beside it,
    as the JAX feature does."""
    from algonauts2025_tpu.core import events as jax_events
    from algonauts2025_tpu_torch.core import events as port_events

    root, path = trimodal_study
    mkv = sorted(path.rglob("*.mkv"))[0]
    fields = dict(filepath=str(mkv), start=0.0, duration=10.0, offset=3.0, frequency=4.0,
                  timeline="t")
    got, got_sr = ta.Wav2VecBert(device="cpu")._read_mono_zscore(port_events.Video(**fields))
    want, want_sr = jaudio.Wav2VecBert()._read_mono_zscore(jax_events.Video(**fields))
    assert got_sr == want_sr == 16000 and got.shape == want.shape == (10 * 16000,)
    np.testing.assert_array_equal(got, want)
