"""Dataset download via datalad (reference data_utils/download.py:39-108).

The port's copy of algonauts2025_tpu/data/download.py.  Clones the
courtois-neuromod / Algonauts release with datalad and fetches the annexed
content, writing success-marker files so interrupted downloads resume
cheaply.  Host-side tooling; gated on the datalad binary being available
(the tests put a stub ``datalad`` on ``PATH``).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import typing as tp
from pathlib import Path

import pydantic

logger = logging.getLogger(__name__)

__all__ = ["Datalad"]

DEFAULT_SOURCE = "https://github.com/courtois-neuromod/algonauts_2025.competitors.git"


class Datalad(pydantic.BaseModel):
    """datalad clone + get with success markers."""

    model_config = pydantic.ConfigDict(extra="forbid")

    dset_dir: Path
    source: str = DEFAULT_SOURCE
    paths: tp.List[str] = []  # subpaths to fetch; empty = everything
    jobs: int = 8

    def _marker(self, tag: str) -> Path:
        return Path(self.dset_dir) / f".download_{tag}_success.txt"

    def _run(self, *cmd: str, cwd: Path | None = None) -> None:
        logger.info("Running: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, cwd=cwd)

    def download(self) -> Path:
        if shutil.which("datalad") is None:
            raise RuntimeError(
                "datalad is not installed; install it (pip install datalad) "
                "or place the dataset manually under "
                f"{self.dset_dir}/download/algonauts_2025.competitors"
            )
        dset = Path(self.dset_dir)
        dset.mkdir(parents=True, exist_ok=True)
        clone_dir = dset / "download" / "algonauts_2025.competitors"

        if not self._marker("clone").exists():
            if not clone_dir.exists():
                self._run("datalad", "clone", self.source, str(clone_dir))
            self._marker("clone").write_text("done")

        targets = self.paths or ["."]
        for target in targets:
            tag = "get_" + target.replace("/", "_")
            if self._marker(tag).exists():
                continue
            self._run(
                "datalad", "get", "-J", str(self.jobs), target, cwd=clone_dir
            )
            self._marker(tag).write_text("done")
        return clone_dir
