"""The port's gated-attention pooling (hipt_abmil_atec23_tpu_torch/ops/
gated_attention_pool.py) held against the JAX package: the plain version
against the Pallas kernel (interpret mode) and its jnp oracle, CLAM_SB, and
apply_pooled's routing. The CUDA kernel is held against the plain version
on the card in test_torch_kernels_cuda.py."""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import CLAM_SB as JaxCLAM
from hipt_abmil_atec23_tpu.ops import gated_attention_pool as jgap
from hipt_abmil_atec23_tpu_torch.models.abmil import CLAM_SB
from hipt_abmil_atec23_tpu_torch.models.convert import (
    clam_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap


def _interpret(fn, *args, **kwargs):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jgap.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _params(rng, d_in=192, l=16, d=8, c=2):
    arrs = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in [
        ("w_f", (d_in, l)), ("b_f", (l,)), ("w_a", (l, d)), ("b_a", (d,)),
        ("w_b", (l, d)), ("b_b", (d,)), ("w_c", (d, 1)), ("b_c", (1,)),
        ("w_cls", (l, c)), ("b_cls", (c,))]}
    return (jgap.GatedPoolParams(**{k: jnp.asarray(v)
                                    for k, v in arrs.items()}),
            gap.GatedPoolParams(**{k: torch.from_numpy(v)
                                   for k, v in arrs.items()}))


def _clam_pair(rng, n=8):
    model = JaxCLAM(size_arg="hipt_smaller", n_classes=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((n, 192)), None)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params)
    port = CLAM_SB("hipt_smaller", n_classes=2)
    port.load_state_dict(clam_state_dict_from_jax(params))
    return model, params, port.eval()


@pytest.mark.parametrize("n,valid,tile", [(128, 128, 64), (300, 280, 128),
                                          (75, 75, 128)])
def test_plain_pool_matches_pallas_kernel_and_oracle(n, valid, tile, rng):
    jp, tp = _params(rng)
    bag = rng.normal(size=(n, 192)).astype(np.float32)
    k_logits, k_scores = _interpret(jgap.gated_attention_pool,
                                    jnp.asarray(bag), jp, n_valid=valid,
                                    tile=tile)
    o_logits, o_scores = jgap.gated_attention_pool_reference(
        jnp.asarray(bag), jnp.arange(n) < valid, jp)
    logits, scores = gap.gated_attention_pool(torch.from_numpy(bag), tp,
                                              n_valid=valid)
    assert logits.shape == (1, 2) and scores.shape == (n,)
    for want_l, want_s in ((np.asarray(k_logits)[0], k_scores),
                           (np.asarray(o_logits), o_scores)):
        np.testing.assert_allclose(logits.numpy()[0], want_l,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(scores.numpy()[:valid],
                                   np.asarray(want_s)[:valid],
                                   rtol=1e-5, atol=1e-5)
    # masked rows carry the kernel's sentinel
    assert np.all(scores.numpy()[valid:] == gap.NEG_INF)


def test_plain_pool_matches_clam_sb(rng):
    """Pooling the port CLAM_SB's weights reproduces the JAX CLAM_SB
    forward (logits and raw attention scores)."""
    model, params, port = _clam_pair(rng)
    bag = rng.normal(size=(200, 192)).astype(np.float32)
    out = model.apply(params, jnp.asarray(bag), None)
    with torch.inference_mode():
        logits, scores = gap.gated_attention_pool(
            torch.from_numpy(bag), gap.params_from_clam(port))
    np.testing.assert_allclose(logits.numpy(), np.asarray(out.logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(out.a_raw)[0],
                               rtol=1e-4, atol=1e-5)


def test_all_masked_bag_gives_bias_logits(rng):
    """Masked rows weigh exactly 0 (TPU kernel semantics): an all-masked
    bag pools nothing and returns the classifier bias, as the Pallas
    kernel does."""
    jp, tp = _params(rng)
    bag = rng.normal(size=(256, 192)).astype(np.float32)
    mask = np.zeros(256, bool)
    k_logits, _ = _interpret(jgap.gated_attention_pool, jnp.asarray(bag),
                             jp, mask=jnp.asarray(mask), tile=128)
    logits, scores = gap.gated_attention_pool(
        torch.from_numpy(bag), tp, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(k_logits),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.numpy()[0], tp.b_cls.numpy(),
                               rtol=0, atol=1e-7)
    assert np.all(scores.numpy() == gap.NEG_INF)


@pytest.mark.parametrize("n_pad,n_valid,jax_pooled", [(1024, 1000, True),
                                                      (512, 300, False)])
def test_apply_pooled_routes_like_jax(n_pad, n_valid, jax_pooled, rng,
                                      monkeypatch):
    """The port pools every bag of a gated single-branch head, whether the
    JAX package pools it (inside its TPU size band) or runs the model
    forward (outside it); any other head runs the model forward. Outputs
    agree with the JAX package's apply_pooled either way."""
    model, params, port = _clam_pair(rng)
    bag = np.zeros((n_pad, 192), np.float32)
    bag[:n_valid] = rng.normal(size=(n_valid, 192))
    mask = np.arange(n_pad) < n_valid
    jax_calls = []
    jax_pool = jgap._jnp_pool
    monkeypatch.setattr(jgap, "_jnp_pool", lambda *a: jax_calls.append(1)
                        or jax_pool(*a))
    want = jgap.apply_pooled(model, params, jnp.asarray(bag),
                             jnp.asarray(mask))
    assert bool(jax_calls) == jax_pooled
    calls = []
    real = gap.gated_attention_pool
    monkeypatch.setattr(gap, "gated_attention_pool",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for gated in (True, False):
        calls.clear()
        port.gate = gated  # an ungated head has no pooled path
        with torch.inference_mode():
            got = gap.apply_pooled(port, torch.from_numpy(bag),
                                   torch.from_numpy(mask))
        assert bool(calls) == gated
        np.testing.assert_allclose(got.logits.numpy(),
                                   np.asarray(want.logits),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.y_prob.numpy(),
                                   np.asarray(want.y_prob),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.a_raw.numpy()[:, :n_valid],
                                   np.asarray(want.a_raw)[:, :n_valid],
                                   rtol=1e-4, atol=1e-5)
        assert int(got.y_hat[0]) == int(np.asarray(want.y_hat)[0])
