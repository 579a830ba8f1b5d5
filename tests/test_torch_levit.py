"""The port's LeViT (hipt_abmil_atec23_tpu_torch/models/levit.py) held
against the JAX package's LeViT on the CPU, both specs.

Two ways in: the JAX package's folded params bridged with
levit_state_dict_from_jax, and an original-layout state dict (the torch
oracle of tests/test_levit_parity.py, BatchNorm statistics randomized)
folded by the port's levit_state_dict_from_torch and by the JAX package's
levit_params_from_torch. Tolerances: in f32 1e-5 of max(1, the largest
|feature|) (float rounding of one fold, another summation order); the
port in bf16 against the JAX package in f32 at cosine >= 0.999 and
relative L2 <= 2e-2 (the JAX package's own bf16 LeViT does not run: its
conv biases stay f32 and promote the next conv's input)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models.levit import (
    LeViT as JaxLeViT, SPECS as JAX_SPECS, levit_params_from_torch)
from hipt_abmil_atec23_tpu_torch.models import levit
from test_levit_parity import TorchLeViT, _randomize_bn_stats

F32_TOL = 1e-5
BF16_COS, BF16_REL = 0.999, 2e-2


def _jax_params(spec, seed):
    """The JAX package's seeded folded params with non-zero biases and
    bias tables."""
    params = JaxLeViT(spec).init(seed)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a if a.dtype.kind == "i" else
        (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32), params)


def _close_f32(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=F32_TOL * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module", params=["levit_128s", "levit_256"])
def spec(request):
    return request.param


def _jax_apply(spec, params, x):
    return np.asarray(jax.jit(JaxLeViT(spec).apply)(params, jnp.asarray(x)))


def test_levit_matches_jax_through_the_bridge(spec):
    """Both dtypes of the port, the 224 px input, and a 256 px one the
    forward centre-crops as the JAX encoder does (engine/encode.py:380)."""
    params = _jax_params(spec, 1)
    x = np.random.default_rng(2).normal(0, 1, (2, 256, 256, 3)
                                        ).astype(np.float32)
    want = _jax_apply(spec, params, x[:, 16:240, 16:240])
    sd = levit.levit_state_dict_from_jax(params)
    f32 = levit.LeViT(spec).eval()
    f32.load_state_dict(sd)
    bf16 = levit.LeViT(spec, torch.bfloat16).eval()
    bf16.load_state_dict(sd)
    with torch.inference_mode():
        got = f32(torch.from_numpy(x)).numpy()
        low = bf16(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, JAX_SPECS[spec]["embed_dim"][-1])
    _close_f32(got, want)
    cos = (low * want).sum(1) / (np.linalg.norm(low, axis=1)
                                 * np.linalg.norm(want, axis=1))
    rel = np.linalg.norm(low - want, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= BF16_COS and rel.max() <= BF16_REL, (cos, rel)
    assert bf16.input_dtype == torch.bfloat16


def test_original_layout_folds_like_jax(spec):
    """The oracle's original-layout state dict through the port's fold and
    the JAX package's levit_params_from_torch: f32 within 1e-5."""
    gen = np.random.default_rng(0)
    torch.manual_seed(0)
    oracle = TorchLeViT(JAX_SPECS[spec]).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.normal_(0, 0.02)
    _randomize_bn_stats(oracle, gen)
    x = gen.normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    want = _jax_apply(spec, levit_params_from_torch(
        {k: v.numpy() for k, v in oracle.state_dict().items()}, spec=spec),
        x)
    model = levit.LeViT(spec).eval()
    model.load_state_dict(levit.levit_state_dict_from_torch(
        oracle.state_dict(), spec))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close_f32(got, want)


def test_bias_tables_and_plan_match_jax(spec):
    """The port's stage plan and bias-index tables are the JAX package's:
    the state dict holds every folded layer and no index buffer."""
    from hipt_abmil_atec23_tpu.models import levit as jlevit
    model = levit.LeViT(spec)
    plan = levit.stage_plan(levit.SPECS[spec], 14)
    assert plan == JaxLeViT(spec)._stage_plan()
    for blk, mod in zip(plan, model.blocks):
        if blk["kind"] == "attn":
            want, _ = jlevit._bias_idxs(blk["res"])
        elif blk["kind"] == "sub":
            want, _, _ = jlevit._sub_bias_idxs(blk["res"], blk["stride"])
        else:
            continue
        assert np.array_equal(mod.attention_bias_idxs.numpy(), want)
    assert not any("idxs" in k for k in model.state_dict())
    assert model.feat_dim == {"levit_128s": 384, "levit_256": 512}[spec]
