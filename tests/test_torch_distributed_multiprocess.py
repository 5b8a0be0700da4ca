"""Two real processes joined by ``parallel.init_distributed`` (gloo, CPU):
the twin of tests/test_distributed_multiprocess.py.

Each process gets torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK), joins the group, builds the ("data",
"model") mesh over both, takes its 8-row half of a 16-row global batch
through ``shard_batch`` and reduces ``sum(x * 2)`` over the mesh; both
must print the JAX test's total exactly.  The JAX twin runs the same
reduction as a jitted sum over a process-sharded global array.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_mp import TIMEOUT, free_port

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from algonauts2025_tpu_torch.parallel.mesh import get_mesh, init_distributed, shard_batch

init_distributed(device="cpu")
try:
    assert dist.get_world_size() == 2, dist.get_world_size()
    mesh = get_mesh()
    assert mesh.shape == (2, 1), mesh.shape
    # the 16-row global array; each process keeps its own 8-row half
    rows = torch.cat([torch.arange(8.0), torch.arange(8.0) + 100.0])
    local, split = shard_batch({{"x": rows}}, mesh, "cpu")
    assert split and local["x"].shape == (8,)
    assert local["x"][0].item() == 100.0 * dist.get_rank()
    total = (local["x"] * 2.0).sum()
    dist.all_reduce(total, group=mesh.get_group("data"))
    print("RESULT", total.item(), flush=True)
finally:
    dist.barrier()  # neither rank tears down while the other still talks
    dist.destroy_process_group()
"""


def test_two_process_mesh_step(tmp_path):
    port = free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\nstdout={out}\nstderr={err[-2000:]}"
            outs.append(out)
    finally:
        # a hung rendezvous or a failed rank must not leak its sibling
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # both halves: 2 * (sum(0..7) + sum(100..107)) = 2 * (28 + 828)
    expected = 2.0 * (sum(range(8)) + sum(range(100, 108)))
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("RESULT")][-1]
        assert float(line.split()[1]) == pytest.approx(expected)
