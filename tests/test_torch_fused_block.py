"""The port's fused ViT block (hipt_abmil_atec23_tpu_torch/ops/fused_block.py)
held against the JAX package: its plain version against the Pallas kernel
(interpret mode) and against the flax f32 Block. The CUDA kernel is held
against the plain version on the card in test_torch_kernels_cuda.py."""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models.vit import Block as JaxBlock
from hipt_abmil_atec23_tpu.ops import fused_block as jfb
from hipt_abmil_atec23_tpu_torch.models.convert import (
    block_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.models.vit import Block
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    _kernel_weights, fused_vit_block, fused_vit_block_reference)


def _interpret(fn, *args, **kwargs):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jfb.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _block_pair(d, heads, rng):
    """A flax Block's params with every leaf perturbed (non-zero biases,
    non-unit norms), and the port Block holding the same weights."""
    x0 = jnp.zeros((1, 8, d), jnp.float32)
    params = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                      ln_eps=1e-6).init(jax.random.PRNGKey(0), x0)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    blk = Block(d, heads, 4.0, 1e-6)
    blk.load_state_dict(block_state_dict_from_jax(params["params"]))
    return params, blk


def _inputs(b, n, d, rng):
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    n_pad = (n + 7) // 8 * 8
    return x, np.pad(x, ((0, 0), (0, n_pad - n), (0, 0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,heads", [(2, 16, 64, 2), (3, 9, 96, 3)])
def test_plain_block_matches_pallas_kernel(b, n, d, heads, dtype, rng):
    """Same padded input, n_valid < n_pad for (3, 9): the bands of
    tests/test_fused_block.py (bf16 MXU operands on both sides, or the
    exact f32 port block against the kernel's bf16 operands)."""
    params, blk = _block_pair(d, heads, rng)
    x, xp = _inputs(b, n, d, rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fused = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                     ln_eps=1e-6, dtype=jdt, use_fused_block=True)
    want, _ = _interpret(fused.apply, params, jnp.asarray(xp, jdt),
                         n_valid=n)
    with torch.inference_mode():
        got = fused_vit_block(torch.from_numpy(xp).to(getattr(torch, dtype)),
                              blk, num_heads=heads, n_valid=n)
    assert got.dtype == getattr(torch, dtype) and got.shape == xp.shape
    np.testing.assert_allclose(got.float().numpy()[:, :n],
                               np.asarray(want, np.float32)[:, :n],
                               rtol=5e-2, atol=3e-2)


@pytest.mark.parametrize("b,n,d,heads", [(2, 16, 64, 2), (3, 9, 96, 3)])
def test_plain_block_bf16_operands_match_pallas_kernel_at_f32(b, n, d, heads,
                                                              rng):
    """f32 x with bf16 operands, as the CUDA kernel computes an f32 residual
    stream: the Pallas kernel's arithmetic at f32 x (it reads x as f32 and
    rounds only the GEMM operands), within f32 summation order (atol 1e-4;
    the exact f32 block is 5e-2 away at these shapes)."""
    params, blk = _block_pair(d, heads, rng)
    x, xp = _inputs(b, n, d, rng)
    fused = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                     ln_eps=1e-6, dtype=jnp.float32, use_fused_block=True)
    want, _ = _interpret(fused.apply, params, jnp.asarray(xp), n_valid=n)
    with torch.inference_mode():
        got = fused_vit_block_reference(torch.from_numpy(xp), blk,
                                        num_heads=heads, n_valid=n,
                                        operand_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[:, :n],
                               np.asarray(want)[:, :n], rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,n,d,heads", [(2, 16, 64, 2), (3, 9, 96, 3)])
def test_plain_block_f32_matches_flax_block(b, n, d, heads, rng):
    """f32 I/O: the plain block is the exact f32 block. The flax Block runs
    the unpadded tokens; the port runs them padded with n_valid, so this
    also checks the key mask. atol 1e-4 covers f32 summation order."""
    params, blk = _block_pair(d, heads, rng)
    x, xp = _inputs(b, n, d, rng)
    want, _ = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                       ln_eps=1e-6).apply(params, jnp.asarray(x))
    with torch.inference_mode():
        got = fused_vit_block(torch.from_numpy(xp), blk, num_heads=heads,
                              n_valid=n)
    np.testing.assert_allclose(got.numpy()[:, :n], np.asarray(want),
                               rtol=0, atol=1e-4)


def test_padded_query_rows_do_not_touch_valid_rows(rng):
    """Rows past n_valid are computed but never attended to: the valid
    rows equal a run on the unpadded tokens."""
    params, blk = _block_pair(64, 2, rng)
    x, xp = _inputs(2, 13, 64, rng)
    xp[:, 13:] = 7.0  # garbage in the padding must not leak
    with torch.inference_mode():
        a = fused_vit_block(torch.from_numpy(xp), blk, num_heads=2,
                            n_valid=13)
        b = fused_vit_block(torch.from_numpy(x), blk, num_heads=2)
    np.testing.assert_allclose(a.numpy()[:, :13], b.numpy(), rtol=0,
                               atol=1e-5)


def test_kernel_weights_cast_once_per_parameter_version(rng):
    """The kernel's bf16 / f32 weight copies are made once and made again
    only after a parameter changes, as a load_state_dict changes it."""
    params, blk = _block_pair(64, 2, rng)
    dev = torch.device("cpu")
    with torch.inference_mode():
        first = _kernel_weights(blk, dev)
        assert _kernel_weights(blk, dev) is first
    assert [t.dtype for t in first] == [
        torch.bfloat16 if p.dim() == 2 else torch.float32 for p in
        (blk.norm1.weight, blk.norm1.bias, blk.attn.qkv.weight,
         blk.attn.qkv.bias, blk.attn.proj.weight, blk.attn.proj.bias,
         blk.norm2.weight, blk.norm2.bias, blk.mlp.fc1.weight,
         blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias)]
    assert torch.equal(first[2], blk.attn.qkv.weight.detach().bfloat16())
    sd = {k: v + 1 for k, v in blk.state_dict().items()}
    blk.load_state_dict(sd)
    with torch.inference_mode():
        again = _kernel_weights(blk, dev)
    assert again is not first
    assert torch.equal(again[2], sd["attn.qkv.weight"].bfloat16())
