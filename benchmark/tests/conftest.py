"""Shared set-up of the benchmark's tests: tiny copies of the cells on the CPU.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
Tests that need the CUDA card carry the ``card`` marker and skip, deciding
inside the test, where there is none; on the card:
``python -m pytest benchmark/tests -q -m card``.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny sizes of each configuration and traffic mix (widths that keep every
#: code path: 128-wide int8 denses, >= 2 heads, the contrastive head)
TINY_CONFIGS = {
    # modality dropout off: under dropout the port's Adam leaves a dropped
    # projector unmoved (``test_dropped_after_use_is_the_ports_fault``), and
    # these tests hold the trunk's driver and reference to each other
    "tribe_trunk": {"brain_model_config": {"hidden": 96, "depth": 2, "heads": 2, "modality_dropout": 0.0},
                    "feature_dims": {"text": [2, 40], "audio": [2, 16], "video": [2, 24]},
                    "n_outputs": 20, "n_output_timesteps": 10, "n_timesteps": 30, "batch_size": 4},
    "vjepa2_vitg_int8": {"crop_size": 32, "frames_per_clip": 8, "hidden_size": 128,
                         "num_hidden_layers": 3, "num_attention_heads": 4, "mlp_ratio": 2.0},
}
TINY_TRAFFIC = {
    "trunk_step": {"total_steps": 100},
    "video_windows": {"frame_height": 36, "frame_width": 64, "pool_windows": 6},
}
TINY_LIMITS = {"trunk_step.flagship": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4},
               "video_windows.vitg": {"state_gap": 1e-6, "first_block_gap": 1e-6,
                                      "first_attention_gap": 1e-6}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card (skips without one)")


def _merge(base: dict, update: dict) -> dict:
    out = dict(base)
    for key, value in update.items():
        out[key] = _merge(base[key], value) if isinstance(value, dict) and key in base else value
    return out


#: the trunk's cell and its step metric: their files are here, but
#: BENCHMARK.json leaves the cell out while the port's Adam skips a leaf
#: without a gradient (PERF.md, Open questions)
TRUNK_CELL = {"name": "trunk_step.flagship", "config": "tribe_trunk", "traffic": "trunk_step", "chips": 1,
              "why": "back-to-back train steps on 8 device-resident batches"}
TRUNK_STEP_S = {"name": "train_step_s", "unit": "s/step", "better": "lower", "bound": 0.01,
                "source": "host_clock", "workloads": ["trunk_step.flagship"]}


def spec(trunk: bool = False) -> dict:
    """BENCHMARK.json; with ``trunk``, with the trunk's cell added."""
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trunk:
        s["workloads"].append(TRUNK_CELL)
        s["end_to_end"].append(TRUNK_STEP_S)
    return s


def tiny_root(tmp: Path) -> Path:
    """A benchmark folder with the real drivers and metrics and tiny
    configurations, traffic and limits."""
    root = tmp / "bench"
    for part in ("drivers", "metrics"):
        shutil.copytree(BENCH / part, root / part)
    for part, tiny in (("configs", TINY_CONFIGS), ("traffic", TINY_TRAFFIC), ("limits", TINY_LIMITS)):
        (root / part).mkdir(parents=True)
        for path in (BENCH / part).glob("*.json"):
            data = json.loads(path.read_text())
            if part == "limits":
                data = tiny.get(path.stem, data)
            else:
                data = _merge(data, tiny.get(path.stem, {}))
            (root / part / path.name).write_text(json.dumps(data))
    return root


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.fixture
def card_semantics():
    """The ViT-G's static int8 denses and MLP through the plain versions of
    the card's fused kernels (on the CPU the port takes its unfused path,
    which rounds the MLP's hidden state to bf16)."""
    from unittest import mock

    from algonauts2025_tpu_torch.models.backbones import vjepa2
    from algonauts2025_tpu_torch.ops import quant

    def forward(self, x):
        self.observe(x)
        if self.static_scale and not self.observing:
            return quant.int8_matmul_fused_plain(x, self.kernel_q, self.scale, self.a_scale, bias=self.bias,
                                                 out_dtype=x.dtype)
        return (quant.int8_matmul(x, self.kernel_q, self.scale) + self.bias).to(x.dtype)

    def fused_ok(self, x):
        return self.fc1.static_scale and not self.fc1.observing

    with mock.patch.object(vjepa2._QDense, "forward", forward), \
            mock.patch.object(vjepa2.VJEPA2Block, "_fused_mlp_ok", fused_ok):
        yield
