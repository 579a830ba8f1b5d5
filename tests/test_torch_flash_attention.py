"""The port's attention ops (hipt_abmil_atec23_tpu_torch/ops/flash_attention.py)
held against the JAX package on the same seeded inputs: the plain versions
of fused_attention and flash_attention against JAX's attention_reference and
its Pallas kernels in interpret mode, and the dispatcher's branch choice
against the JAX dispatcher's. The CUDA kernels are held against the plain
versions on the card in test_torch_kernels_cuda.py."""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.ops import flash_attention as jfa
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa


def _interpret(fn, *args, **kwargs):
    """Pallas kernels in interpret mode (the shim of
    tests/test_flash_attention.py)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jfa.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _qkv(bh, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3)]


def _both(arrs, dtype="float32"):
    """The same arrays as JAX and torch inputs in ``dtype``."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("n,valid", [(257, 257), (384, 257), (128, 100)])
def test_fused_attention_matches_jax(n, valid):
    """f32: the plain fused_attention against the interpret-mode kernel
    and the oracle at 2e-5, every query row (padded keys masked)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(4, n, 64, seed=n))
    got = _np(fa.fused_attention(q, k, v, valid))
    kernel = _np(_interpret(jfa.fused_attention, jq, jk, jv,
                            valid_len=valid))
    oracle = _np(jfa.attention_reference(jq, jk, jv, valid_len=valid))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(fa.attention_reference(q, k, v, valid)), oracle, rtol=2e-5,
        atol=2e-5)


@pytest.mark.parametrize("n,valid", [(512, 512), (768, 700)])
def test_flash_attention_matches_jax(n, valid):
    """f32: the plain flash recurrence (128-key blocks) against the
    interpret-mode flash kernel and the oracle at 2e-5."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, n, 64, seed=n))
    got = _np(fa.flash_attention(q, k, v, valid, block_q=128, block_k=128))
    kernel = _np(_interpret(jfa.flash_attention, jq, jk, jv,
                            valid_len=valid, block_q=128, block_k=128))
    oracle = _np(jfa.attention_reference(jq, jk, jv, valid_len=valid))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_fused_attention_query_tiled_matches_jax():
    """The medium-N branch's arguments (group 1, 256-row query tiles)
    against the interpret-mode kernel at 2e-5."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(4, 1000, 64, seed=3))
    got = _np(fa.fused_attention(q, k, v, 990, group=1, block_q=256))
    kernel = _np(_interpret(jfa.fused_attention, jq, jk, jv, valid_len=990,
                            group=1, block_q=256))
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fn", ["fused_attention", "flash_attention"])
def test_bf16_matches_jax_kernel(fn):
    """bf16 storage: the plain version against the interpret-mode kernel
    with the same rounding points; 1e-2 allows a bf16 rounding flip of the
    output or of a probability in another summation order."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 256, 64, seed=7), "bfloat16")
    kw = {"block_q": 128, "block_k": 128} if fn == "flash_attention" else {}
    got = getattr(fa, fn)(q, k, v, 250, **kw)
    want = _interpret(getattr(jfa, fn), jq, jk, jv, valid_len=250, **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


def test_head_size_32_matches_jax():
    """ViT-4K's head size (192 / 6 heads) through the grouped branch."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(12, 257, 32, seed=32))
    got = _np(fa.attention(q, k, v))
    want = _np(_interpret(jfa.attention, jq, jk, jv))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [8, 257, 1024, 1025, 4096, 24576, 24577,
                               49152, 49153, 70000])
def test_dispatcher_takes_the_jax_branch(n, d, dtype):
    """At every shape the port's attention() calls the counterpart of the
    TPU kernel the JAX dispatcher calls."""
    seen = {}

    def recorder(pkg, name):
        def rec(q, k, v, valid_len=None, **kw):
            seen[pkg] = name
            return q
        return rec

    jq = jax.ShapeDtypeStruct((1, n, d), getattr(jnp, dtype))
    with mock.patch.object(jfa, "fused_attention",
                           recorder("jax", "fused")), \
            mock.patch.object(jfa, "flash_attention",
                              recorder("jax", "flash")):
        jfa.attention(jq, jq, jq)
    q = torch.empty((1, n, d), dtype=getattr(torch, dtype), device="meta")
    with mock.patch.object(fa, "fused_attention",
                           recorder("port", "fused")), \
            mock.patch.object(fa, "flash_attention",
                              recorder("port", "flash")):
        fa.attention(q, q, q)
    assert seen["port"] == seen["jax"]
    assert fa.attention_branch(n, d, q.element_size()) == seen["jax"]
