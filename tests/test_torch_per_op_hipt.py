"""The port's per-op encoder configuration (use_flash + use_fused_mlp) held
against the JAX package's at narrow widths, on weights bridged from one JAX
parameter tree: the whole HIPT_4K against JAX make_hipt_encoder's per-op
configuration with its Pallas kernels in interpret mode, and one Block in
each of the four use_flash x use_fused_mlp combinations."""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models.vit import Block as JaxBlock
from hipt_abmil_atec23_tpu.ops import flash_attention as jfa
from hipt_abmil_atec23_tpu.ops import fused_mlp as jfm
from hipt_abmil_atec23_tpu_torch.models.convert import (
    block_state_dict_from_jax, hipt_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.models.hipt import hipt_eval_normalize
from hipt_abmil_atec23_tpu_torch.models.vit import Block
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa
from hipt_abmil_atec23_tpu_torch.ops import fused_mlp as fm
from test_torch_hipt import narrow_jax_hipt, narrow_params, narrow_port_hipt


def _interpret(fn, *args, **kwargs):
    """Both Pallas modules in interpret mode (the shim of
    tests/test_flash_attention.py)."""
    from jax.experimental import pallas as pl
    run = functools.partial(pl.pallas_call, interpret=True)
    with mock.patch.object(jfa.pl, "pallas_call", run), \
            mock.patch.object(jfm.pl, "pallas_call", run):
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def regions():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, size=(2, 512, 512, 3), dtype=np.uint8)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_narrow_per_op_hipt_matches_jax(dtype, tol, regions):
    """f32 at 1e-4, bf16 at 5e-2 (rtol and atol): the same bridged
    parameters through the JAX per-op encoder (interpret-mode kernels) and
    the port's (the kernels' plain versions on the CPU)."""
    params = narrow_params(seed=5)
    jdt = getattr(jnp, dtype)
    x = jhipt.hipt_eval_normalize(jnp.asarray(regions))
    jmodel = narrow_jax_hipt(jdt, use_flash=True, use_fused_mlp=True)
    want = np.asarray(_interpret(jmodel.apply, params, x))
    model = narrow_port_hipt(getattr(torch, dtype), True, True, False)
    model.load_state_dict(hipt_state_dict_from_jax(params))
    launches = (fa.fused_attention.launches, fm.fused_mlp.launches)
    with torch.inference_mode():
        got = model(hipt_eval_normalize(torch.from_numpy(regions)))
    assert got.dtype == torch.float32 and got.shape == (2, 192)
    assert (fa.fused_attention.launches, fm.fused_mlp.launches) == launches
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_per_op_and_fused_block_share_one_parameter_tree(regions):
    """One state dict loads into the per-op and the fused-block
    configurations; in f32 both compute the same features (1e-4)."""
    sd = hipt_state_dict_from_jax(narrow_params(seed=6))
    models = [narrow_port_hipt(torch.float32, *flags)
              for flags in ((True, True, False), (False, False, True))]
    for m in models:
        m.load_state_dict(sd)
    x = hipt_eval_normalize(torch.from_numpy(regions))
    with torch.inference_mode():
        a, b = (m(x) for m in models)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


# (compute dtype, token dtype): block 0 reads f32 tokens; later bf16
# blocks read bf16 ones where the LN + MLP kernel rounded the stream
@pytest.mark.parametrize("dtype,in_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("use_flash,use_fused_mlp", [
    (False, False), (True, False), (False, True), (True, True)])
def test_block_combinations_match_jax(use_flash, use_fused_mlp, dtype,
                                      in_dtype, rng):
    """Each use_flash x use_fused_mlp Block on 19 unpadded tokens: the same
    output dtype as flax (the residual stream's promotion) and values
    within 1e-4 in f32, 5e-2 in bf16 (bf16 bias adds and roundings on both
    sides, interpret-mode kernels' f32 products)."""
    d, heads = 64, 2
    x0 = jnp.zeros((1, 8, d), jnp.float32)
    params = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                      ln_eps=1e-6).init(jax.random.PRNGKey(0), x0)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    x = rng.normal(size=(3, 19, d)).astype(np.float32)
    jblk = JaxBlock(num_heads=heads, mlp_ratio=4.0, qkv_bias=True,
                    ln_eps=1e-6, dtype=getattr(jnp, dtype),
                    use_flash=use_flash, use_fused_mlp=use_fused_mlp)
    want, _ = _interpret(jblk.apply, params,
                         jnp.asarray(x, getattr(jnp, in_dtype)))
    blk = Block(d, heads, 4.0, 1e-6, dtype=getattr(torch, dtype),
                use_flash=use_flash, use_fused_mlp=use_fused_mlp)
    blk.load_state_dict(block_state_dict_from_jax(params["params"]))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x).to(getattr(torch, in_dtype)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
