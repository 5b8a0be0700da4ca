"""The port's grids (``grids/defaults.py``, ``grids/test_run.py``) against
the JAX package's: the same default config key by key, the same
environment variables, and a smoke config that validates as the port's
``Experiment`` on the CPU."""

import importlib

import pytest

from algonauts2025_tpu.config import ConfDict as JaxConfDict
from algonauts2025_tpu.grids import defaults as jax_defaults
from algonauts2025_tpu.grids import test_run as jax_test_run
from algonauts2025_tpu_torch.config import ConfDict
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.features.audio import Wav2VecBert
from algonauts2025_tpu_torch.features.text import LLAMA3p2
from algonauts2025_tpu_torch.features.video import VJEPA2
from algonauts2025_tpu_torch.grids import defaults
from algonauts2025_tpu_torch.grids import test_run as port_test_run

ENV = ("ALGONAUTS_TPU_DATA", "ALGONAUTS_TPU_SAVE", "ALGONAUTS_TPU_CACHE")


def _flat(cfg, confdict):
    return dict(confdict(cfg).flat())


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    return (port_test_run.build_test_config(tmp_root=str(root / "port"), device="cpu"),
            jax_test_run.build_test_config(tmp_root=str(root / "jax")))


def test_default_config_equals_jax_key_by_key():
    got, want = _flat(defaults.default_config, ConfDict), _flat(jax_defaults.default_config,
                                                                 JaxConfDict)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key] == value, key
    assert got["data.video_feature.name"] == "VJEPA2"
    assert got["brain_model_config.contrastive_modalities"] == ["video"]


def test_paths_come_from_the_same_environment_variables(monkeypatch, tmp_path):
    for name in ENV:
        monkeypatch.setenv(name, str(tmp_path / name.lower()))
    try:
        port, ref = importlib.reload(defaults), importlib.reload(jax_defaults)
        for attr in ("DATADIR", "BASEDIR", "CACHEDIR", "SAVEDIR"):
            assert getattr(port, attr) == getattr(ref, attr)
        assert port.DATADIR == str(tmp_path / "algonauts_tpu_data")
        assert port.default_config == ref.default_config
    finally:
        monkeypatch.undo()
        importlib.reload(defaults)
        importlib.reload(jax_defaults)


def test_default_config_validates_as_the_ports_experiment(smoke, tmp_path):
    """The whole trimodal default builds the port's Experiment over the
    smoke config's synthetic study (nothing runs)."""
    cfg = ConfDict(defaults.default_config)
    cfg["infra.folder"] = str(tmp_path / "run")
    cfg["data.study.path"] = smoke[0]["data"]["study"]["path"]
    exp = Experiment(**cfg.to_dict())
    assert isinstance(exp.data.text_feature, LLAMA3p2)
    assert isinstance(exp.data.audio_feature, Wav2VecBert)
    assert isinstance(exp.data.video_feature, VJEPA2)
    assert exp.accelerator == "cuda" and exp.data.video_feature.device == "auto"
    assert exp.data.video_feature.quantize and exp.data.video_feature.quant_static


def test_build_test_config_validates_on_the_cpu(smoke):
    cfg, ref = smoke
    exp = Experiment(**cfg)
    assert exp.accelerator == "cpu"
    for feature in ("text_feature", "audio_feature", "video_feature"):
        assert getattr(exp.data, feature).device == "cpu"
        assert getattr(exp.data, feature).model_name == "tiny-random"
    # the JAX package's smoke config but for the placement and the study path
    got, want = _flat(cfg, ConfDict), _flat(ref, JaxConfDict)
    placement = {"accelerator", *(f"data.{f}.device" for f in port_test_run.FEATURES)}
    assert set(got) - set(want) == placement
    for key, value in want.items():
        if key != "data.study.path":
            assert got[key] == value, key


def test_build_test_config_does_not_mutate_defaults(smoke):
    """ConfDict holds the metrics list by reference to the defaults: the
    smoke config's synthetic study must not strip num_outputs from them."""
    kwargs = [dict(m.get("kwargs", {})) for m in defaults.default_config["metrics"]]
    assert [kw.get("num_outputs") for kw in kwargs] == [1000, 1000, None]
    assert all("num_outputs" not in m.get("kwargs", {}) for m in smoke[0]["metrics"])
