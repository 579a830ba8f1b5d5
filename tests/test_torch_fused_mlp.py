"""The port's fused MLP (hipt_abmil_atec23_tpu_torch/ops/fused_mlp.py) held
against the JAX package on the same seeded inputs and weights: its plain
version against the Pallas kernel in interpret mode (both modes, f32 and
bf16), and the port's Mlp / LN + MLP + residual against the flax Dense path
on one parameter tree. The CUDA kernel is held against the plain version on
the card in test_torch_kernels_cuda.py."""
import functools
import unittest.mock as mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models.vit import Mlp as JaxMlp
from hipt_abmil_atec23_tpu.ops import fused_mlp as jfm
from hipt_abmil_atec23_tpu_torch.models.vit import Mlp
from hipt_abmil_atec23_tpu_torch.ops import fused_mlp as fm


def _interpret(fn, *args, **kwargs):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jfm.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _arrays(shape, d, h, seed=0):
    """x [..., D], gamma, beta [D], w1 [D, H], b1 [H], w2 [H, D], b2 [D]."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    return (f(*shape, d), 1 + f(d, scale=0.1), f(d, scale=0.1),
            f(d, h, scale=d ** -0.5), f(h, scale=0.1),
            f(h, d, scale=h ** -0.5), f(d, scale=0.1))


def _cast(arrs, dtype):
    """x and the weight matrices in ``dtype``, vectors f32 (as the JAX
    model hands them to the kernel)."""
    x, g, be, w1, b1, w2, b2 = arrs
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(be),
         jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
         jnp.asarray(b2)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(g),
         torch.from_numpy(be), torch.from_numpy(w1).to(tdt),
         torch.from_numpy(b1), torch.from_numpy(w2).to(tdt),
         torch.from_numpy(b2)]
    return j, t


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("shape,d,h", [((5, 37), 384, 1536),
                                       ((3, 9), 64, 256)])
def test_plain_matches_pallas_kernel(shape, d, h, with_ln, dtype, tol):
    """Both modes against the interpret-mode kernel (f32 products on both
    sides). f32 at 2e-5 covers the kernel's A&S erf (<= 1.5e-7) and
    summation order; bf16 output at 1e-2 covers a rounding flip."""
    (jx, jg, jbe, jw1, jb1, jw2, jb2), (x, g, be, w1, b1, w2, b2) = \
        _cast(_arrays(shape, d, h, seed=d), dtype)
    if with_ln:
        want = _interpret(jfm.fused_ln_mlp_residual, jx, jg, jbe, jw1, jb1,
                          jw2, jb2, eps=1e-6)
        got = fm.fused_ln_mlp_residual(x, g, be, w1, b1, w2, b2, eps=1e-6)
    else:
        want = _interpret(jfm.fused_mlp, jx, jw1, jb1, jw2, jb2)
        got = fm.fused_mlp(x, w1, b1, w2, b2)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _mlp_params(d, h, seed=0):
    p = JaxMlp(hidden=h, out=d).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, d)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)


def _port_mlp(params, d, h, use_fused):
    p = params["params"]
    m = Mlp(d, h, use_fused=use_fused)
    sd = {}
    for n in ("fc1", "fc2"):
        sd[f"{n}.weight"] = torch.tensor(np.array(p[n]["kernel"]).T)
        sd[f"{n}.bias"] = torch.tensor(np.array(p[n]["bias"]))
    m.load_state_dict(sd)
    return m


@pytest.mark.parametrize("use_fused", [True, False])
def test_port_mlp_matches_flax_dense_path(use_fused):
    """One parameter tree drives the flax Dense MLP and the port's Mlp,
    fused (the kernel's plain version) or not, f32 at 2e-5."""
    d, h = 96, 384
    params = _mlp_params(d, h)
    x = np.random.default_rng(1).normal(size=(4, 11, d)).astype(np.float32)
    want = np.asarray(JaxMlp(hidden=h, out=d).apply(params, jnp.asarray(x)))
    mlp = _port_mlp(params, d, h, use_fused)
    with torch.inference_mode():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ln_mlp_residual_matches_flax_layers():
    """fused_ln_mlp_residual == x + Mlp(LayerNorm(x)) of flax on the same
    parameters (f32, 2e-5)."""
    d, h = 64, 256
    params = _mlp_params(d, h, seed=2)
    rng = np.random.default_rng(2)
    g = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    be = (0.1 * rng.normal(size=d)).astype(np.float32)
    x = rng.normal(size=(3, 17, d)).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(be)}},
        jnp.asarray(x))
    want = x + np.asarray(JaxMlp(hidden=h, out=d).apply(params, ln))
    p = params["params"]
    w = [torch.tensor(np.array(p[n][k])) for n in ("fc1", "fc2")
         for k in ("kernel", "bias")]
    got = fm.fused_ln_mlp_residual(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(be), *w, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_mlp_weights_follow_the_parameters():
    """The kernel's [D, H] / [H, D] weight copies are made once per
    parameter version and dtype, in the JAX layout."""
    m = Mlp(64, 256)
    dev = torch.device("cpu")
    with torch.inference_mode():
        first = fm.mlp_weights(m, torch.bfloat16, dev)
        assert fm.mlp_weights(m, torch.bfloat16, dev) is first
    assert torch.equal(first[0], m.fc1.weight.detach().t().bfloat16())
    assert first[0].is_contiguous() and first[1].dtype == torch.float32
    with torch.no_grad():
        m.fc2.weight.add_(1.0)
    with torch.inference_mode():
        again = fm.mlp_weights(m, torch.bfloat16, dev)
        assert again is not first
        assert torch.equal(again[2], m.fc2.weight.detach().t().bfloat16())
        assert fm.mlp_weights(m, torch.float32, dev)[0].dtype == \
            torch.float32


def test_k_major_weights_reproduce_the_pallas_kernel():
    """The kernel reads W1^T and W2^T (K-major): ``_k_major`` copies of the
    JAX-layout weights through the kernel's products on the CPU give the
    interpret-mode kernel's LN + MLP + residual (f32, 2e-5); the copy is
    made once per weight version, and mlp_weights attaches it."""
    d, h = 96, 384
    (jx, jg, jbe, jw1, jb1, jw2, jb2), (x, g, be, w1, b1, w2, b2) = \
        _cast(_arrays((7, 13), d, h, seed=3), "float32")
    want = _interpret(jfm.fused_ln_mlp_residual, jx, jg, jbe, jw1, jb1, jw2,
                      jb2, eps=1e-6)
    w1t, w2t = fm._k_major(w1), fm._k_major(w2)
    assert w1t.shape == (h, d) and w2t.shape == (d, h)
    assert fm._k_major(w1) is w1t
    xn = torch.nn.functional.layer_norm(x, (d,), g, be, eps=1e-6)
    got = torch.nn.functional.gelu(xn @ w1t.T + b1) @ w2t.T + b2 + x
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    with torch.no_grad():
        w1.add_(1.0)
    assert fm._k_major(w1) is not w1t
    assert torch.equal(fm._k_major(w1), w1.t())
    m = Mlp(64, 256)
    with torch.inference_mode():
        ww = fm.mlp_weights(m, torch.bfloat16, torch.device("cpu"))
        assert torch.equal(fm._k_major(ww[0]),
                           m.fc1.weight.detach().bfloat16())
        assert torch.equal(fm._k_major(ww[2]),
                           m.fc2.weight.detach().bfloat16())
