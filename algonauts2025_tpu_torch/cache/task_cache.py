"""Task-level caching and fan-out (exca TaskInfra equivalent).

A task = a pydantic config + a run() method.  The config hash is the task
identity; a completed run is never recomputed unless mode="force" (or the
previous attempt failed and mode="retry") — the same contract as the
reference's ``@infra.apply`` (reference algonauts2025/main.py:479,
grids/test_run.py:24).

Fan-out: the reference submits Slurm job arrays.  On TPU the equivalent is
many independent single-slice jobs; ``job_array()`` collects tasks and runs
them through a pluggable launcher — in-process sequential by default,
"threadpool" for IO-bound fanout, or an external command template
(ALGONAUTS_TPU_LAUNCHER) that receives a config path per task for
multi-slice deployment.
"""

from __future__ import annotations

import contextlib
import json
import logging
import pickle
import traceback
import typing as tp
from pathlib import Path

import pydantic

from ..config.uid import config_uid

logger = logging.getLogger(__name__)

__all__ = ["TaskInfra"]


class TaskInfra(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")

    folder: str | Path | None = None
    cluster: tp.Optional[str] = None  # None | "local" | "threadpool" | "external"
    mode: tp.Literal["cached", "force", "retry"] = "cached"
    version: str = "1"
    job_name: str | None = None
    # device-count knobs kept for config-surface parity with the reference
    # (gpus_per_node>1 <-> data-parallel over the local mesh)
    gpus_per_node: int = 1
    tasks_per_node: int = 1
    slurm_partition: str | None = None
    slurm_use_srun: bool = False
    max_workers: int = 4

    _owner: tp.Any = None

    def _exclude_from_cache_uid(self) -> list[str]:
        return list(type(self).model_fields)

    # -- identity ---------------------------------------------------------
    def bind(self, owner: pydantic.BaseModel) -> "TaskInfra":
        self._owner = owner
        return self

    def uid(self) -> str:
        if self._owner is None:
            raise RuntimeError("TaskInfra.uid() requires bind(owner) first")
        return config_uid(self._owner, version=self.version)

    def _status_path(self) -> Path:
        assert self.folder is not None
        return Path(self.folder) / f".task-{self.uid()}.status.json"

    def _result_path(self) -> Path:
        assert self.folder is not None
        return Path(self.folder) / f".task-{self.uid()}.result.pkl"

    def status(self) -> str:
        """One of: "not submitted", "running", "completed", "failed"."""
        if self.folder is None or not self._status_path().exists():
            return "not submitted"
        try:
            return json.loads(self._status_path().read_text())["status"]
        except Exception:
            return "not submitted"

    def clear_job(self) -> None:
        if self.folder is None:
            return
        for p in (self._status_path(), self._result_path()):
            with contextlib.suppress(FileNotFoundError):
                p.unlink()

    def job(self) -> tp.Any:  # parity shim: no remote job objects locally
        return None

    def clone_obj(self, **updates: tp.Any) -> tp.Any:
        """Clone the owner with dotted-key config updates applied."""
        from ..config.confdict import ConfDict

        assert self._owner is not None
        cfg = ConfDict(self._owner.model_dump())
        cfg.update(updates)
        return type(self._owner)(**cfg.to_dict())

    # -- execution --------------------------------------------------------
    def run_cached(self, fn: tp.Callable[[], tp.Any]) -> tp.Any:
        """Run fn with task-level result caching in ``folder``."""
        if self.folder is None:
            return fn()
        Path(self.folder).mkdir(parents=True, exist_ok=True)
        status = self.status()
        if self.mode == "force":
            self.clear_job()
            status = "not submitted"
        elif status == "completed":
            logger.info("Task %s already completed; returning cached result", self.uid())
            try:
                with open(self._result_path(), "rb") as f:
                    return pickle.load(f)
            except Exception:
                # corrupted/truncated result (crash mid-write, disk full):
                # recompute instead of silently serving None
                logger.warning(
                    "Cached result for %s is unreadable; recomputing", self.uid()
                )
                self.clear_job()
        elif status == "failed" and self.mode != "retry":
            raise RuntimeError(
                f"Task {self.uid()} previously failed; use mode='retry' or 'force'"
            )
        self._status_path().write_text(json.dumps({"status": "running"}))
        try:
            out = fn()
        except Exception:
            self._status_path().write_text(
                json.dumps({"status": "failed", "traceback": traceback.format_exc()})
            )
            raise
        try:
            with open(self._result_path(), "wb") as f:
                pickle.dump(out, f)
        except (pickle.PicklingError, TypeError, AttributeError):
            # genuinely unpicklable result: the run still succeeded, cache a
            # tombstone (IO errors, by contrast, must propagate — a partial
            # write with status "completed" would poison the cache)
            logger.warning(
                "Task result for %s is not picklable; caching None", self.uid()
            )
            with open(self._result_path(), "wb") as f:
                pickle.dump(None, f)
        self._status_path().write_text(json.dumps({"status": "completed"}))
        return out

    @contextlib.contextmanager
    def job_array(self, allow_empty: bool = False) -> tp.Iterator[list]:
        """Collect tasks, then execute them via the configured launcher."""
        tasks: list[tp.Any] = []
        yield tasks
        if not tasks and not allow_empty:
            raise RuntimeError("Empty job array (pass allow_empty=True to allow)")
        if not tasks:
            return
        logger.info("Launching job array with %d tasks (cluster=%s)", len(tasks), self.cluster)
        if self.cluster == "threadpool":
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(self.max_workers) as ex:
                futures = [ex.submit(t.run) for t in tasks]
                for f in futures:
                    f.result()
        elif self.cluster == "external":
            self._launch_external(tasks)
        else:  # None / "local": sequential in-process
            for t in tasks:
                t.run()

    def _launch_external(self, tasks: list) -> None:
        """Fan tasks out through an external launcher, array-style.

        The launcher command (env ALGONAUTS_TPU_LAUNCHER) is invoked once
        per task with a JSON config path appended — e.g. a script that
        queues a job running ``python -m
        algonauts2025_tpu_torch.grids.run_config <config.json>`` (that
        module is not ported yet: ROADMAP queue 1, orchestration).  Semantics
        mirror the reference's exca job arrays (modeling_utils
        utils.py:124-155): already-completed elements are skipped, up to
        ``max_workers`` launches run concurrently, each task gets its own
        log file, and a per-element summary lands in
        ``job_array/array_status.json``.  One failing element does not
        stop the others; failures raise at the end with their logs.
        """
        import os
        import subprocess
        import time

        import shlex

        launcher = os.environ.get("ALGONAUTS_TPU_LAUNCHER")
        if not launcher:
            raise RuntimeError(
                "cluster='external' requires the ALGONAUTS_TPU_LAUNCHER env var"
            )
        launcher_argv = shlex.split(launcher)
        assert self.folder is not None
        outdir = Path(self.folder) / "job_array"
        outdir.mkdir(parents=True, exist_ok=True)

        summary: list[dict] = []
        queue: list[tuple[int, tp.Any]] = []
        for i, task in enumerate(tasks):
            infra = getattr(task, "infra", None)
            done = infra is not None and infra.status() == "completed"
            if done and self.mode != "force":
                logger.info("array element %d already completed; skipping", i)
                summary.append({"index": i, "status": "skipped (completed)"})
                continue
            queue.append((i, task))

        running: list[tuple[int, tp.Any, tp.Any, Path]] = []
        failures: list[dict] = []

        def _reap(block: bool) -> None:
            while running:
                finished = [
                    slot for slot, item in enumerate(running) if item[2].poll() is not None
                ]
                for slot in reversed(finished):
                    i, task, proc, log_path = running.pop(slot)
                    infra = getattr(task, "infra", None)
                    entry = {
                        "index": i,
                        "returncode": proc.returncode,
                        "log": str(log_path),
                        "status": infra.status() if infra is not None else "unknown",
                    }
                    summary.append(entry)
                    if proc.returncode != 0 or entry["status"] == "failed":
                        failures.append(entry)
                if finished or not block:
                    return
                time.sleep(0.05)

        for i, task in queue:
            cfg_path = outdir / f"task_{i:05d}.json"
            cfg_path.write_text(json.dumps(task.model_dump(mode="json"), default=str))
            log_path = outdir / f"task_{i:05d}.log"
            while len(running) >= max(1, self.max_workers):
                _reap(block=True)
            logger.info("launching array element %d (%s)", i, cfg_path.name)
            with open(log_path, "wb") as log_file:
                proc = subprocess.Popen(
                    launcher_argv + [str(cfg_path)],
                    stdout=log_file,
                    stderr=subprocess.STDOUT,
                )
            running.append((i, task, proc, log_path))
        while running:
            _reap(block=True)

        summary.sort(key=lambda e: e["index"])
        (outdir / "array_status.json").write_text(json.dumps(summary, indent=2))
        if failures:
            lines = [
                f"element {e['index']}: rc={e['returncode']} status={e['status']} "
                f"log={e['log']}"
                for e in failures
            ]
            raise RuntimeError(
                f"{len(failures)}/{len(tasks)} array elements failed:\n"
                + "\n".join(lines)
            )
