"""The relative-key attention kernel on the CUDA card: tests that skip without one.

This file imports no JAX, so it runs on a machine with the card and
without JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest tests/test_torch_relkey_card.py -q -m card --noconftest
"""

import pytest
import torch

from algonauts2025_tpu_torch.ops import flash_attention as tf

#: relative L2 of the kernel against its plain version (``chip_smoke.py``'s
#: ``RELKEY_REL``).  Both round the same normalised fp32 probabilities to
#: bf16 and differ only where a sum in another order lands across a bf16
#: rounding boundary: an H100 reads 1.3e-4 to 1.9e-4 at these shapes; a
#: kernel that rounds p before normalising it reads ~3e-3
REL_L2 = 4.5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("t", [1500, 3000, 4500])
def test_card_kernel_matches_its_plain_version(cuda, t):
    """w2v-BERT 2.0's attention at the 30, 60 and 90 s buckets' frames, (1,
    16, T, 64) head views of (1, T, 16, 64) projections, the keys valid to 3
    frames short of T, the distance table at the model's init scale."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn((1, t, 16, 64), generator=gen, device=cuda).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    table = 0.02 * torch.randn((73, 64), generator=gen, device=cuda)
    lengths = torch.tensor([t - 3], dtype=torch.int32, device=cuda)
    before = tf.launch_counts["flash_relkey"]
    out = tf.relkey_attention(q, k, v, table, lengths, 64, 8)
    torch.cuda.synchronize()
    assert tf.launch_counts["flash_relkey"] == before + 1
    ref = tf.relkey_attention_plain(q, k, v, table, lengths, 64, 8)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and torch.isfinite(out).all()
    rel = (torch.linalg.vector_norm(out.float() - ref.float()) / torch.linalg.vector_norm(ref.float())).item()
    assert rel <= REL_L2
