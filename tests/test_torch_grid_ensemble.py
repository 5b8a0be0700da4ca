"""The port's grid fan-out and model-soup ensemble against the JAX package's.

- ``experiment.grid.run_grid``: the dry run and the in-process job array
  (tests/test_data_layer.py's case), ``run_grid``'s and ``run_ensemble``'s
  enumerations.
- The external launcher (tests/test_fanout.py): a job array through
  ``grids.run_config`` subprocesses, with a completed element skipped, and
  a killed element resuming from its last.ckpt.
- ``grids.average_submissions``: the scoreless-run and unreadable-zip cases
  (tests/test_utils_misc.py), and the JAX package's weighting on the same
  runs (equal at 1e-12: the same NumPy).
- End to end: a 3-member soup of the tiny trunk through ``run_grid`` in
  both packages (the port's members from the JAX members' initial trunk
  weights, the text backbone with the JAX tiny weights), averaged by both:
  the ensemble zips agree at atol 1e-4 (tests/test_torch_experiment.py's
  artifact limit).
"""

import io
import json
import os
import signal
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pydantic
import pytest
from test_torch_experiment import ARTIFACT_ATOL, _config

from algonauts2025_tpu.data.synthetic import make_synthetic_study
from algonauts2025_tpu.experiment import Experiment as JaxExperiment
from algonauts2025_tpu.experiment.grid import run_grid as jax_run_grid
from algonauts2025_tpu.features import text as jt
from algonauts2025_tpu.grids import average_submissions as jax_avg
from algonauts2025_tpu.grids import run_ensemble as jax_run_ensemble
from algonauts2025_tpu.training import trainer as jax_trainer
from algonauts2025_tpu_torch.cache import TaskInfra
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.experiment.grid import run_grid
from algonauts2025_tpu_torch.features import text as tt
from algonauts2025_tpu_torch.grids import average_submissions as avg
from algonauts2025_tpu_torch.grids import run_ensemble, run_grid as run_grid_cli
from algonauts2025_tpu_torch.models import flax_params_to_torch, llama_params_to_torch
from algonauts2025_tpu_torch.training import trainer as port_trainer

REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid_study")
    return root, make_synthetic_study(root / "data", with_video=False, n_parcels=16,
                                      duration=40.0)


# -- run_grid -----------------------------------------------------------------


class Toy(pydantic.BaseModel):
    x: int = 0
    seed: int = 0
    infra: TaskInfra = TaskInfra()

    def model_post_init(self, _ctx):
        self.infra.bind(self)

    def run(self):
        RAN.append((self.x, self.seed))


RAN: list = []


def test_run_grid_runs_every_point_in_uid_folders(tmp_path):
    RAN.clear()
    configs = run_grid(Toy, "toygrid", {"infra": {"folder": str(tmp_path)}},
                       {"x": [1, 2], "seed": [0, 1]}, combinatorial=True, interactive=False)
    assert len(configs) == 4
    assert sorted(RAN) == [(1, 0), (1, 1), (2, 0), (2, 1)]
    assert all("toygrid" in c["infra.folder"] for c in configs)
    jax_configs = jax_run_grid(Toy, "toygrid", {"infra": {"folder": str(tmp_path)}},
                               {"x": [1, 2], "seed": [0, 1]}, combinatorial=True,
                               interactive=False, dry_run=True)
    assert [c.to_dict() for c in configs] == [c.to_dict() for c in jax_configs]


@pytest.mark.parametrize("combinatorial,sample,seed", [(False, None, None), (True, 3, 7)])
def test_run_grid_dry_run_matches_jax(tmp_path, combinatorial, sample, seed):
    """One axis at a time or the sampled product: the same configs (uid
    folders included) as the JAX package's, and nothing runs."""
    RAN.clear()
    grid = {"x": [1, 2, 3], "seed": [0, 1]}
    args = dict(combinatorial=combinatorial, n_randomly_sampled=sample, seed=seed,
                dry_run=True, interactive=False)
    got = run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, grid, **args)
    want = jax_run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, grid, **args)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert len(got) == (sample or 5) and not RAN
    with pytest.raises(ValueError, match="exceeds the 6 grid points"):
        run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, grid, combinatorial=True,
                 n_randomly_sampled=7, dry_run=True)


def test_run_grid_overwrite_clears_folders(tmp_path, monkeypatch):
    configs = run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, {"x": [1]},
                       dry_run=True)
    folder = Path(configs[0]["infra.folder"])
    folder.mkdir(parents=True)
    (folder / "stale").write_text("x")
    monkeypatch.setattr("builtins.input", lambda: "n")  # the prompt declines x=1
    kept = run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, {"x": [1, 2]},
                    overwrite=True)
    assert (folder / "stale").exists() and [c["x"] for c in kept] == [2]
    run_grid(Toy, "g", {"infra": {"folder": str(tmp_path)}}, {"x": [1]}, overwrite=True,
             interactive=False)
    assert not (folder / "stale").exists()


def test_layer_seed_grid_and_soup_enumerate(tmp_path):
    """``run_grid --dry-run`` gives len(LAYER_CHOICES) x seeds configs;
    the soup samples from the JAX package's grid, the same points for a
    seed; more models than the soup's 768 points samples all of them."""
    got = run_grid_cli.main(["--dry-run", "--seeds", "3", "--savedir", str(tmp_path)])
    assert len(got) == len(run_grid_cli.LAYER_CHOICES) * 3
    assert {tuple(c["data"]["layers"]) for c in got} == {
        tuple(x) for x in run_grid_cli.LAYER_CHOICES}
    assert run_ensemble.SOUP_GRID == jax_run_ensemble.SOUP_GRID
    argv = ["--dry-run", "--n-models", "6", "--sample-seed", "3", "--savedir", str(tmp_path)]
    soup = run_ensemble.main(argv)
    jax_soup = jax_run_ensemble.main(argv)
    keys = list(run_ensemble.SOUP_GRID)
    assert [[c[k] for k in keys] for c in soup] == [[c[k] for k in keys] for c in jax_soup]
    assert all(c["seed"] is None and c["save_checkpoints"] is False for c in soup)
    assert len(run_ensemble.main(["--dry-run", "--savedir", str(tmp_path)])) == 768


# -- the external launcher (tests/test_fanout.py) -------------------------------


def _base_config(root, study_path, folder, n_epochs=1):
    cfg = _config(root, study_path, "fanout")
    cfg["n_epochs"] = n_epochs
    cfg["infra"] = {"folder": str(folder), "mode": "retry", "cluster": None}
    return cfg


def test_job_array_external_launcher(study, tmp_path, monkeypatch):
    root, study_path = study
    Experiment(**_base_config(root, study_path, tmp_path / "warm")).run()  # warm the caches
    grid_root = tmp_path / "grid"
    tasks = []
    for seed in (1, 2, 3):
        cfg = _base_config(root, study_path, grid_root / f"seed{seed}")
        cfg["seed"] = seed
        tasks.append(Experiment(**cfg))
    tasks[0].run()  # one element is completed: the array must skip it
    assert tasks[0].infra.status() == "completed"
    array_infra = tasks[0].infra.model_copy(
        update={"folder": str(grid_root), "cluster": "external", "max_workers": 2})
    array_infra.bind(tasks[0])
    monkeypatch.setenv("ALGONAUTS_TPU_LAUNCHER",
                       f"{sys.executable} -m algonauts2025_tpu_torch.grids.run_config")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with array_infra.job_array() as arr:
        arr.extend(tasks)
    summary = json.loads((grid_root / "job_array" / "array_status.json").read_text())
    by_index = {e["index"]: e for e in summary}
    assert by_index[0]["status"] == "skipped (completed)"
    for i in (1, 2):
        assert by_index[i]["returncode"] == 0 and by_index[i]["status"] == "completed"
        assert Path(by_index[i]["log"]).exists()
    for seed in (1, 2, 3):
        assert (grid_root / f"seed{seed}" / "metrics.csv").exists()
        assert (grid_root / f"seed{seed}" / "submission.zip").exists()


_CRASH_HARNESS = """
import os, signal, sys
from algonauts2025_tpu_torch.training import trainer as tr

_orig = tr.BrainTrainer.save_checkpoint

def _save_then_die(self, name, epoch=None, **kw):
    out = _orig(self, name, epoch=epoch, **kw)
    if name == "last" and epoch == 2:
        os.kill(os.getpid(), signal.SIGKILL)  # preempted after epoch 2's checkpoint
    return out

tr.BrainTrainer.save_checkpoint = _save_then_die
from algonauts2025_tpu_torch.grids.run_config import main
main(sys.argv[1])
"""


def test_killed_element_resumes_from_last_ckpt(study, tmp_path):
    root, study_path = study
    folder = tmp_path / "victim"
    cfg_path = tmp_path / "victim.json"
    cfg_path.write_text(json.dumps(_base_config(root, study_path, folder, n_epochs=5),
                                   default=str))
    harness = tmp_path / "crash_harness.py"
    harness.write_text(_CRASH_HARNESS)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(harness), str(cfg_path)], env=env,
                          capture_output=True, timeout=600)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()[-2000:]
    assert (folder / "last.ckpt").exists()

    def epochs():
        return [int(json.loads(line)["epoch"])
                for line in (folder / "metrics.jsonl").read_text().splitlines()]

    assert max(epochs()) == 2
    out = subprocess.run([sys.executable, "-m", "algonauts2025_tpu_torch.grids.run_config",
                          str(cfg_path)], env=env, capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    # every epoch trained exactly once across both processes
    assert sorted(epochs()) == list(range(5))


def test_run_config_is_single_process(monkeypatch, tmp_path):
    """Without a launcher run_config joins no process group (one process,
    one device); under a launcher's environment it joins the group first,
    and a WORLD_SIZE without a RANK raises before any rendezvous (as the
    JAX init_distributed refuses JAX_NUM_PROCESSES without JAX_PROCESS_ID)."""
    import torch.distributed as dist

    from algonauts2025_tpu_torch.grids import run_config
    from algonauts2025_tpu_torch.parallel import init_distributed

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    init_distributed(device="cpu")
    assert not dist.is_initialized()
    config = tmp_path / "task.json"
    config.write_text(json.dumps({"accelerator": "cpu"}))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK is not"):
        run_config.main(str(config))
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="usage"):
        run_config.cli([])


# -- average_submissions ------------------------------------------------------


def _fake_run(folder, score, corrupt_zip=False, pearson=None, value=None):
    folder.mkdir(parents=True)
    fill = float(score or 0.0) if value is None else value
    preds = {"sub-01": {"s07e01a": np.full((4, 3), fill), "s07e01b": np.full((2, 3), -fill)}}
    if corrupt_zip:
        (folder / "submission.zip").write_bytes(b"not a zip")
    else:
        buf = io.BytesIO()
        np.save(buf, preds, allow_pickle=True)
        with zipfile.ZipFile(folder / "submission.zip", "w") as zf:
            zf.writestr("submission.npy", buf.getvalue())
    if score is not None:
        pd.DataFrame([{"val/pearson": score}]).to_csv(folder / "metrics.csv", index=False)
    else:
        (folder / "metrics.csv").write_text("garbage,,,\n\x00")
    if pearson is not None:
        np.save(folder / "pearson.npy", np.asarray(pearson, np.float32))


def test_score_weighted_ensemble_skips_scoreless_runs(tmp_path):
    _fake_run(tmp_path / "a", score=0.5)
    _fake_run(tmp_path / "b", score=None)  # corrupt metrics.csv
    out = avg.average_submissions(tmp_path, weigh_by_score=True)
    got = np.load(tmp_path / "submission.npy", allow_pickle=True).item()
    np.testing.assert_allclose(got["sub-01"]["s07e01a"], 0.5)  # only run "a"
    assert out.exists()


def test_ensemble_all_zips_unreadable_raises_clearly(tmp_path):
    _fake_run(tmp_path / "a", score=0.5, corrupt_zip=True)
    _fake_run(tmp_path / "b", score=0.1, corrupt_zip=True)
    with pytest.raises(RuntimeError, match="failed to load"):
        avg.average_submissions(tmp_path)


@pytest.mark.parametrize("kwargs", [
    {},
    {"weigh_by_score": True, "temperature": 0.3},
    {"weigh_by_score": True, "per_voxel_weights": True, "temperature": 0.3},
    {"k_most_diverse": 2},
    {"max_runs": 2, "weigh_by_score": True},
])
def test_average_submissions_matches_jax(tmp_path, kwargs):
    rng = np.random.default_rng(5)
    for name, score in zip("abcd", (0.1, 0.3, 0.2, 0.05)):
        pearson = rng.standard_normal(3) * 0.1 + score
        for root in (tmp_path / "port", tmp_path / "jax"):
            _fake_run(root / name, score, pearson=pearson, value=score * 3 - 0.2)
    avg.average_submissions(tmp_path / "port", **kwargs)
    jax_avg.average_submissions(tmp_path / "jax", **kwargs)
    got = np.load(tmp_path / "port" / "submission.npy", allow_pickle=True).item()
    want = np.load(tmp_path / "jax" / "submission.npy", allow_pickle=True).item()
    for chunk, arr in want["sub-01"].items():
        np.testing.assert_allclose(got["sub-01"][chunk], arr, rtol=1e-12, atol=0)


# -- the soup end to end ----------------------------------------------------------

SOUP = {"loss.name": ["MSELoss", "SmoothL1Loss", "HuberLoss"]}


def test_three_member_soup_matches_jax(study, tmp_path, monkeypatch):
    root, study_path = study
    jax_text = jt.TinyTextBackbone()  # the weights JAX's LLAMA3p2 builds for tiny-random
    port_text = tt.TinyTextBackbone(state_dict=llama_params_to_torch(jax_text.params),
                                    device="cpu")
    init = {}
    orig_jax = jax_trainer.BrainTrainer.init_state

    def jax_init_state(self, *args, **kwargs):
        out = orig_jax(self, *args, **kwargs)
        init[Path(self.config.folder).name] = flax_params_to_torch(
            jax.tree.map(np.asarray, self.state.params))
        return out

    def base(name):
        cfg = _config(root, study_path, f"soup_{name}")
        cfg.update(n_epochs=1, save_checkpoints=False)
        cfg["infra"] = {"folder": str(tmp_path / name), "mode": "force"}
        return cfg

    monkeypatch.setattr(jax_trainer.BrainTrainer, "init_state", jax_init_state)
    jax_configs = jax_run_grid(JaxExperiment, "soup", base("jax"), SOUP, combinatorial=True,
                               interactive=False, infra_mode="force")
    monkeypatch.undo()

    orig_port = port_trainer.BrainTrainer.init_state

    def port_init_state(self, *args, **kwargs):
        orig_port(self, *args, **kwargs)
        self.model.load_state_dict(init[Path(self.config.folder).name], strict=True)

    monkeypatch.setattr(port_trainer.BrainTrainer, "init_state", port_init_state)
    monkeypatch.setattr(tt.LLAMA3p2, "_tiny_backbone", lambda self, device: port_text)
    configs = run_grid(Experiment, "soup", base("port"), SOUP, combinatorial=True,
                       interactive=False, infra_mode="force")
    monkeypatch.undo()

    names = [Path(c["infra.folder"]).name for c in configs]
    assert names == [Path(c["infra.folder"]).name for c in jax_configs] and len(set(names)) == 3
    kwargs = dict(weigh_by_score=True, per_voxel_weights=True, temperature=0.3)
    zips = (avg.average_submissions(tmp_path / "port" / "soup", **kwargs),
            jax_avg.average_submissions(tmp_path / "jax" / "soup", **kwargs))
    got, want = (np.load(z.with_suffix(".npy"), allow_pickle=True).item() for z in zips)
    assert all(z.exists() for z in zips) and set(got) == set(want)
    for subject, chunks in want.items():
        assert set(got[subject]) == set(chunks)
        for chunk, arr in chunks.items():
            np.testing.assert_allclose(got[subject][chunk], arr, atol=ARTIFACT_ATOL)
