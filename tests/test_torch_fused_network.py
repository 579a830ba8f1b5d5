"""The port's whole-network ViT kernel (hipt_abmil_atec23_tpu_torch/ops/
fused_network.py) held against the JAX package: its plain version against
the Pallas kernel ``fused_vit_network`` (interpret mode, as
tests/test_fused_network.py runs it), against the port's own block, and the
weight bridges against the JAX leaves. The CUDA kernel is held against the
plain version on the card in test_torch_kernels_cuda.py."""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hipt_abmil_atec23_tpu.models.vit import Block as JaxBlock
from hipt_abmil_atec23_tpu.ops.fused_network import (
    fused_vit_network as jax_network)
from hipt_abmil_atec23_tpu_torch.models.convert import (
    block_state_dict_from_jax, stacked_blocks_from_jax)
from hipt_abmil_atec23_tpu_torch.models.vit import Block, init_dino_
from hipt_abmil_atec23_tpu_torch.ops import fused_network as fnw
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    block_f32, fused_vit_block_reference)
from hipt_abmil_atec23_tpu_torch.ops.fused_network import (
    ORDER, fused_vit_network, fused_vit_network_reference, stack_blocks)

# the shapes of tests/test_fused_network.py: (T, D, heads, hidden, B,
# n_pad, n_valid, group)
MASKED = (3, 64, 4, 256, 4, 16, 13, 2)
UNMASKED = (2, 32, 2, 64, 2, 8, None, 1)
F32_ATOL = 1e-4               # measured max 5.2e-6 at MASKED
BF16_MAX, BF16_MEAN = 1.6e-2, 1e-4   # measured 7.8e-3 (one ulp), 3.5e-6


def _interpret(fn, *args, **kwargs):
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _stacked_weights(seed, depth, d, hidden):
    """Seeded x0.1-normal stacked weights in ORDER, as numpy f32."""
    rng = np.random.default_rng(seed)
    shapes = dict(ln1_g=(depth, d), ln1_b=(depth, d),
                  wqkv=(depth, d, 3 * d), bqkv=(depth, 3 * d),
                  wproj=(depth, d, d), bproj=(depth, d),
                  ln2_g=(depth, d), ln2_b=(depth, d),
                  w1=(depth, d, hidden), b1=(depth, hidden),
                  w2=(depth, hidden, d), b2=(depth, d))
    return [rng.normal(size=shapes[n]).astype(np.float32) * 0.1
            for n in ORDER]


@functools.lru_cache(maxsize=None)
def _case(shape, dtype, unroll=False):
    """(x, weights) as numpy and JAX's interpret-mode output (f32 numpy)."""
    t, d, heads, hidden, b, n_pad, n_valid, group = shape
    w = _stacked_weights(t, t, d, hidden)
    x = np.random.default_rng(100 + t).normal(
        size=(b, n_pad, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _interpret(jax_network, jnp.asarray(x, jdt),
                      *[jnp.asarray(a) for a in w], num_heads=heads,
                      n_valid=n_valid, group=group, unroll=unroll)
    return x, w, np.asarray(want, np.float32)


def _port(x, w, shape, dtype):
    t, d, heads, hidden, b, n_pad, n_valid, group = shape
    with torch.inference_mode():
        out = fused_vit_network(torch.from_numpy(x).to(getattr(torch, dtype)),
                                *[torch.from_numpy(a) for a in w],
                                num_heads=heads, n_valid=n_valid, group=group)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,unroll", [(MASKED, False), (MASKED, True),
                                          (UNMASKED, False)])
def test_plain_network_matches_pallas_kernel(shape, unroll, dtype):
    """Same inputs and stacked weights through JAX's interpret-mode
    network kernel and the port's CPU path (its plain version). f32 x:
    atol 1e-4; bf16 x: the final rounding may differ by one bf16 ulp."""
    x, w, want = _case(shape, dtype, unroll)
    got = _port(x, w, shape, dtype)
    err = np.abs(got - want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        assert err.max() <= BF16_MAX and err.mean() <= BF16_MEAN, (
            err.max(), err.mean())


def test_bf16_residual_between_blocks_fails_the_f32_bound():
    """Planted fault: chaining one-block stacks on bf16 x rounds the
    residual between blocks, as chained bf16 blocks would. The f32 bound
    must catch it (scratch runs gave a max error of 2.2e-2)."""
    x, w, want = _case(MASKED, "float32", False)
    t, d, heads, hidden, b, n_pad, n_valid, group = MASKED
    xb = torch.from_numpy(x).bfloat16()
    with torch.inference_mode():
        for i in range(t):
            xb = fused_vit_network(xb, *[torch.from_numpy(a[i:i + 1])
                                         for a in w],
                                   num_heads=heads, n_valid=n_valid)
    err = np.abs(xb.float().numpy() - want).max()
    assert err > 10 * F32_ATOL, err


def _port_blocks(depth, d, heads, seed):
    """Port Blocks with every parameter perturbed from a seed."""
    g = torch.Generator().manual_seed(seed)
    blocks = [Block(d, heads, 4.0, 1e-6) for _ in range(depth)]
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return blocks


def test_plain_network_is_chained_bf16_operand_blocks_bitwise():
    """At f32 x the plain version is T chained blocks of the port's plain
    block with bf16 operands on an f32 residual, bit for bit (the port's
    form of tests/test_fused_network.py's bitwise property)."""
    blocks = _port_blocks(3, 64, 4, seed=1)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 16, 64)).astype(np.float32))
    with torch.inference_mode():
        want = x
        for blk in blocks:
            want = fused_vit_block_reference(want, blk, num_heads=4,
                                             n_valid=13,
                                             operand_dtype=torch.bfloat16)
        got = fused_vit_network_reference(x, *stack_blocks(blocks),
                                          num_heads=4, n_valid=13)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_plain_network_rounds_the_residual_once():
    """bf16 x: the residual is never rounded mid-stack, so the bf16 result
    is the f32-residual result rounded once."""
    blocks = _port_blocks(3, 64, 4, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, 64)).astype(np.float32)).bfloat16()
    ws = stack_blocks(blocks)
    with torch.inference_mode():
        got = fused_vit_network_reference(x, *ws, num_heads=4, n_valid=11)
        want = fused_vit_network_reference(x.float(), *ws, num_heads=4,
                                           n_valid=11).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_stacked_weights_match_the_jax_leaves():
    """stack_blocks of port Blocks loaded from flax Block params equals
    stacked_blocks_from_jax of the same params and jnp.stack of the JAX
    leaves; it is made once per parameter version."""
    rng = np.random.default_rng(3)
    jblk = JaxBlock(num_heads=2, mlp_ratio=4.0, qkv_bias=True, ln_eps=1e-6)
    params = {}
    for i in range(3):
        p = jblk.init(jax.random.PRNGKey(i), jnp.zeros((1, 8, 64)))["params"]
        params[f"block{i}"] = jax.tree.map(
            lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
            p)
    blocks = []
    for i in range(3):
        blk = Block(64, 2, 4.0, 1e-6)
        blk.load_state_dict(block_state_dict_from_jax(params[f"block{i}"]))
        blocks.append(blk)
    ours = stack_blocks(blocks)
    bridged = stacked_blocks_from_jax(params)
    paths = [("norm1", "scale"), ("norm1", "bias"),
             ("attn", "qkv", "kernel"), ("attn", "qkv", "bias"),
             ("attn", "proj", "kernel"), ("attn", "proj", "bias"),
             ("norm2", "scale"), ("norm2", "bias"),
             ("mlp", "fc1", "kernel"), ("mlp", "fc1", "bias"),
             ("mlp", "fc2", "kernel"), ("mlp", "fc2", "bias")]
    leaf = lambda p, path: functools.reduce(lambda a, k: a[k], path, p)
    assert len(ours) == len(bridged) == len(ORDER)
    for name, a, b, path in zip(ORDER, ours, bridged, paths):
        want = np.asarray(jnp.stack([leaf(params[f"block{i}"], path)
                                     for i in range(3)]))
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), want, err_msg=name)
    assert stack_blocks(blocks) is ours
    blocks[1].load_state_dict({k: v + 1 for k, v in
                               blocks[1].state_dict().items()})
    again = stack_blocks(blocks)
    assert again is not ours
    assert torch.equal(again[2][1], blocks[1].attn.qkv.weight.detach().t())


def test_kernel_weights_cast_once_per_version():
    """The kernel's copies (bf16 GEMM weights in [T, out, in], f32
    vectors) are made once per version of the stacked inputs; inference
    tensors carry no version, so theirs are made on every call."""
    ws = stack_blocks(_port_blocks(2, 64, 2, seed=4))
    dev = torch.device("cpu")
    first = fnw._kernel_weights(ws, dev)
    assert fnw._kernel_weights(ws, dev) is first
    assert [t.dtype for t in first] == [
        torch.bfloat16 if w.dim() == 3 else torch.float32 for w in ws]
    assert torch.equal(first[2], ws[2].transpose(1, 2).bfloat16())
    with torch.no_grad():
        ws[2].add_(1.0)
    again = fnw._kernel_weights(ws, dev)
    assert again is not first
    assert torch.equal(again[2], ws[2].transpose(1, 2).bfloat16())
    with torch.inference_mode():
        frozen = [w.clone() for w in ws]
    assert fnw._kernel_weights(frozen, dev) is not \
        fnw._kernel_weights(frozen, dev)


@pytest.mark.parametrize("b,n_pad,d,heads,group", [
    (2, 12, 64, 4, 2),     # n_pad % 8
    (3, 16, 64, 4, 2),     # B % group
    (2, 16, 64, 3, 1)])    # D % num_heads
def test_contract_checks_raise(b, n_pad, d, heads, group):
    """Where the JAX launcher asserts, the port raises ValueError."""
    w = [torch.from_numpy(a) for a in _stacked_weights(0, 1, d, 4 * d)]
    x = torch.zeros(b, n_pad, d)
    with pytest.raises(ValueError):
        fused_vit_network(x, *w, num_heads=heads, group=group)


@pytest.mark.parametrize("dino,perturb,holds", [(True, 1e-4, True),
                                                (False, 1e-6, False)])
def test_deep_stack_conditioning_of_the_card_test_weights(dino, perturb,
                                                          holds):
    """test_torch_kernels_cuda.py holds the kernel at [2, 264, 384], T 12,
    to 3e-2 + 5e-2 |plain|. That judges the kernel only if the plain
    version stays within the bound when its f32 residual moves by far more
    than a summation order does: true at DINO's init scale (a relative
    1e-4 per block), false with every weight moved by 0.05 std (1e-6)."""
    g = torch.Generator().manual_seed(3)
    blocks = [Block(384, 6, 4.0, 1e-6) for _ in range(12)]
    with torch.no_grad():
        for blk in blocks:
            if dino:
                init_dino_(blk, g)
            for p in blk.parameters():
                if not dino or p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=g)
                           * (0.02 if dino else 0.05))
    ws = stack_blocks(blocks)
    x = torch.randn(2, 264, 384, generator=g)
    noise = torch.Generator().manual_seed(9)

    def run(rel):
        xf = x
        for t in range(12):
            prm = [w[t].t().contiguous() if w.dim() == 3 else w[t]
                   for w in ws]
            xf = block_f32(xf, prm, num_heads=6, n_valid=257, eps=1e-6,
                           cdt=torch.bfloat16)
            xf = xf * (1 + rel * torch.randn(xf.shape, generator=noise))
        return xf.bfloat16().float()

    with torch.inference_mode():
        want, got = run(0.0), run(perturb)
    within = bool(((got - want).abs() <= 3e-2 + 5e-2 * want.abs()).all())
    assert within is holds
