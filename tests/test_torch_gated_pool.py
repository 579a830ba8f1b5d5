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


def test_k_permuted_pairs_each_eight_columns():
    """k_permuted pads K to a multiple of 8 with zeros and puts columns 2t
    and 2t + 1 of every 8 at t and t + 4: a tf32 A fragment's (t, t + 4)."""
    w = torch.arange(3 * 13, dtype=torch.float32).reshape(3, 13)
    got = gap.k_permuted(w)
    assert got.shape == (3, 16)
    padded = torch.nn.functional.pad(w, (0, 3))
    for b in range(2):
        for t in range(4):
            assert torch.equal(got[:, 8 * b + t], padded[:, 8 * b + 2 * t])
            assert torch.equal(got[:, 8 * b + t + 4],
                               padded[:, 8 * b + 2 * t + 1])


def test_tf32_split_keeps_22_bits(rng):
    """hi = tf32(x) clears the low 13 mantissa bits (nearest, ties away);
    hi + tf32(x - hi) is x to ~2^-22 of |x|."""
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 3)
    hi = gap._tf32(x)
    lo = gap._tf32(x - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    assert gap._tf32(torch.tensor([1 + 2.0 ** -11]))[0] == 1 + 2.0 ** -10


def _tensor_core_pool(bag, mask, p):
    """The tensor-core pass 1 emulated on the CPU from ``split_weights``:
    A permuted and split like the kernel's registers, three tf32 products
    per GEMM, z_a and z_b de-interleaved; then the plain softmax pooling."""
    wf2, wz2 = gap.split_weights(p)

    def product(a, w2):
        a = gap.k_permuted(a)
        hi = gap._tf32(a)
        lo = gap._tf32(a - hi)
        return hi @ w2[0].T + hi @ w2[1].T + lo @ w2[0].T

    h = torch.relu(product(bag, wf2) + p.b_f)
    z = product(h, wz2)
    s = ((torch.tanh(z[:, 0::2] + p.b_a) * torch.sigmoid(z[:, 1::2] + p.b_b))
         @ p.w_c + p.b_c)[:, 0]
    s = torch.where(mask, s, torch.full_like(s, gap.NEG_INF))
    e = torch.exp(s - s.max())
    return (e @ h) / e.sum() @ p.w_cls + p.b_cls, s


@pytest.mark.parametrize("d_in,l,d", [(1024, 512, 256), (130, 72, 20)])
def test_split_weights_reproduce_the_pallas_kernel(d_in, l, d, rng):
    """The kernel-layout weights the tensor-core pass reads (W_f^T and the
    interleaved [W_a | W_b]^T, K permuted, tf32 hi / lo), through the
    kernel's arithmetic on the CPU, give the interpret-mode Pallas kernel's
    logits and scores within the card's 1e-4: the CLAM 'small' head and a
    ragged one (D_in and L past a multiple of 8 and 32)."""
    jp, tp = _params(rng, d_in=d_in, l=l, d=d)
    n, valid = 200, 181
    bag = rng.normal(size=(n, d_in)).astype(np.float32)
    k_logits, k_scores = _interpret(jgap.gated_attention_pool,
                                    jnp.asarray(bag), jp, n_valid=valid,
                                    tile=128)
    wf2, wz2 = gap.split_weights(tp)
    assert wf2.shape == (2, l, -(-d_in // 8) * 8)
    assert wz2.shape == (2, 2 * d, -(-l // 8) * 8)
    assert gap.split_weights(tp)[0] is wf2  # made once
    logits, scores = _tensor_core_pool(torch.from_numpy(bag),
                                       torch.arange(n) < valid, tp)
    np.testing.assert_allclose(logits.numpy(), np.asarray(k_logits)[0],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy()[:valid],
                               np.asarray(k_scores)[:valid], rtol=0,
                               atol=1e-4)


def test_params_from_clam_kept_until_a_parameter_changes(rng):
    """apply_pooled asks for the pool weights on every call; they (and
    the split weights made from them) are made once per parameter
    version."""
    _, _, port = _clam_pair(rng)
    first = gap.params_from_clam(port)
    assert gap.params_from_clam(port) is first
    with torch.no_grad():
        port.attention_net[0].weight.add_(1.0)
    again = gap.params_from_clam(port)
    assert again is not first
    assert torch.equal(again.w_f,
                       port.attention_net[0].weight.detach().t())
