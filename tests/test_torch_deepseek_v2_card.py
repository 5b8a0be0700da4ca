"""The DeepSeek-V2 backbone's routed experts and forward on the CUDA card:
tests that skip without one.

This file imports no JAX, so it runs on a machine with the card and
without JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest tests/test_torch_deepseek_v2_card.py -q -m card --noconftest
"""

import pytest
import torch

from algonauts2025_tpu_torch.models.backbones import deepseek_v2 as dv
from algonauts2025_tpu_torch.ops import moe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


def _small(device) -> dv.DeepseekV2Backbone:
    cfg = dv.DeepseekV2Config(vocab_size=1000, hidden_size=256, intermediate_size=384, moe_intermediate_size=128,
                              num_layers=3, num_heads=4, kv_lora_rank=64, n_routed_experts=16, n_shared_experts=2,
                              num_experts_per_tok=4)
    model = dv.DeepseekV2Backbone(cfg, device=device)
    return model.init_random(torch.Generator(device=device).manual_seed(3))


@pytest.mark.card
@pytest.mark.parametrize("tokens", [64, 1024, 8192])
def test_card_grouped_gemms_match_the_per_expert_loop(cuda, tokens):
    """``torch._grouped_mm`` over the sorted rows at the Lite's widths (64
    experts, top 6, 2048 -> 1408 -> 2048), one expert without a row: the
    per-expert loop's rows bit for bit, as an H100 gives them (the
    relative L2 is printed with ``-s``)."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    x = torch.randn(tokens, 2048, generator=gen, device=cuda).bfloat16()
    w13 = (0.02 * torch.randn(64, 2816, 2048, generator=gen, device=cuda)).bfloat16()
    w2 = (0.02 * torch.randn(64, 2048, 1408, generator=gen, device=cuda)).bfloat16()
    logits = torch.randn(tokens, 64, generator=gen, device=cuda)
    logits[:, 5] = -1e9
    _, ids = torch.topk(logits.softmax(-1), 6, dim=-1, sorted=False)
    got = moe.expert_rows_grouped(x, ids, w13, w2).float()
    want = moe.expert_rows_plain(x, ids, w13, w2).float()
    gap = float((got - want).norm() / want.norm())
    print(f"grouped GEMMs vs the loop at {tokens} tokens: rel L2 {gap:.3e}, equal {torch.equal(got, want)}")
    assert torch.equal(got, want), gap


@pytest.mark.card
def test_card_forward_takes_no_host_sync(cuda):
    """A forward of a right-padded batch on the card, with every synchronising
    CUDA call an error: expert counts and offsets stay on the device."""
    model = _small(cuda)
    ids = torch.randint(0, 990, (2, 256), device=cuda)
    mask = torch.ones(2, 256, dtype=torch.int32, device=cuda)
    mask[1, 200:] = 0
    with torch.no_grad():
        model(ids, mask)  # the rotary table's one upload
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out).all()


@pytest.mark.card
def test_card_forward_matches_the_cpu(cuda):
    """The bf16 small model on the card (cuBLAS and the CUTLASS grouped
    GEMMs) against the same weights on the CPU, the valid positions."""
    model = _small(cuda)
    ids = torch.randint(0, 990, (2, 300), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 300, dtype=torch.int32)
    mask[1, 220:] = 0
    with torch.no_grad():
        card = model(ids.to(cuda), mask.to(cuda)).cpu()
        model.reset_expert_tokens()
        cpu = model.cpu()(ids, mask)
    valid = mask.bool()[None, :, :, None].expand_as(cpu)
    gaps = [float((card[i][valid[i]] - cpu[i][valid[i]]).norm() / cpu[i][valid[i]].norm()) for i in range(4)]
    assert gaps[0] == 0 and max(gaps) < 3e-2, gaps
