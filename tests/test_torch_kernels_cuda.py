"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs an NVIDIA GPU (built for sm_90a) and
skips without one; the module imports neither jax nor the JAX package, so
on a machine without jax it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""
import pytest
import torch

from hipt_abmil_atec23_tpu_torch.models.abmil import CLAM_SB
from hipt_abmil_atec23_tpu_torch.models.vit import Block
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,heads", [(3, 16, 9, 96, 3),
                                            (2, 264, 257, 192, 6),
                                            (4, 264, 257, 384, 6),
                                            (2, 8, 5, 64, 1)])
def test_block_kernel_matches_plain(b, n, nv, d, heads, cuda_device):
    """bf16 kernel against the plain version on the same card inputs:
    |kernel - plain| <= 3e-2 + 5e-2 |plain| (bf16 rounding of P and the
    head outputs at other summation orders)."""
    g = torch.Generator().manual_seed(0)
    blk = Block(d, heads, 4.0, 1e-6)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    blk = blk.to(cuda_device)
    x = torch.randn(b, n, d, generator=g).to(cuda_device, torch.bfloat16)
    before = fused_vit_block.launches
    with torch.inference_mode():
        got = fused_vit_block(x, blk, num_heads=heads, n_valid=nv)
        want = fused_vit_block_reference(x, blk, num_heads=heads,
                                         n_valid=nv).float()
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float()
    assert bool(((got - want).abs() <= 3e-2 + 5e-2 * want.abs()).all())


@pytest.mark.cuda
def test_block_kernel_refuses_what_it_does_not_take(cuda_device):
    """No quiet fallback: f32 I/O, head size 96 and odd token counts raise."""
    blk = Block(192, 2, 4.0, 1e-6).to(cuda_device)
    x = torch.zeros(1, 16, 192, device=cuda_device)
    with pytest.raises(ValueError):
        fused_vit_block(x, blk, num_heads=2)            # f32, hd 96
    with pytest.raises(ValueError):
        fused_vit_block(x[:, :9].bfloat16(), blk, num_heads=6)  # n_pad 9


@pytest.mark.cuda
@pytest.mark.parametrize("n,masked", [(4096, 97), (100_000, 97), (300, 300),
                                      (1, 0)])
def test_pool_kernel_matches_plain(n, masked, cuda_device):
    """f32 kernel against the plain version on the card: logits and scores
    within 1e-4 (f32 sums in another order); an all-masked bag gives the
    bias logits."""
    g = torch.Generator().manual_seed(0)
    model = CLAM_SB("hipt_smaller", 2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    p = gap.params_from_clam(model.to(cuda_device))
    bag = torch.randn(n, 192, generator=g).to(cuda_device)
    mask = torch.arange(n, device=cuda_device) < n - masked
    before = gap.gated_attention_pool.launches
    logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
    ref_logits, ref_scores = gap.gated_attention_pool_reference(bag, mask, p)
    torch.cuda.synchronize()
    assert gap.gated_attention_pool.launches == before + 1
    assert (logits[0] - ref_logits).abs().max().item() <= 1e-4
    assert (scores - ref_scores).abs().max().item() <= 1e-4
    if masked == n:
        assert torch.allclose(logits[0], p.b_cls, atol=1e-7)


@pytest.mark.cuda
def test_pool_kernel_prefix_length_equals_mask(cuda_device):
    g = torch.Generator().manual_seed(1)
    model = CLAM_SB("hipt_smaller", 2).to(cuda_device)
    p = gap.params_from_clam(model)
    bag = torch.randn(5000, 192, generator=g).to(cuda_device)
    a = gap.gated_attention_pool(bag, p, n_valid=4321)
    b = gap.gated_attention_pool(
        bag, p, mask=torch.arange(5000, device=cuda_device) < 4321)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
