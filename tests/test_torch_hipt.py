"""The port's HIPT_4K encoder (hipt_abmil_atec23_tpu_torch/models/{vit,hipt}.py)
held against the JAX package at narrow widths, on weights bridged from the
JAX parameter tree; plus the checkpoint bridges and pos-embed
interpolation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models import vit as jvit
from hipt_abmil_atec23_tpu.models.convert import hipt_params_from_torch
from hipt_abmil_atec23_tpu.ops.interpolate import (
    interpolate_pos_embed as jax_interpolate)
from hipt_abmil_atec23_tpu_torch.models import vit
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_state_dict_from_jax, load_dino_, load_torch_state_dict)
from hipt_abmil_atec23_tpu_torch.models.hipt import (
    hipt_eval_normalize, make_hipt_encoder)
from hipt_abmil_atec23_tpu_torch.ops.interpolate import interpolate_pos_embed

# ViT-256 D=64, depth 2, 2 heads; ViT-4K 64 -> 192, depth 2, 2 heads: the
# features stay 192-d, so CLAM_SB hipt_smaller fits
NARROW_256 = dict(embed_dim=64, depth=2, num_heads=2)
NARROW_4K = dict(input_embed_dim=64, output_embed_dim=192, depth=2,
                 num_heads=2)


def narrow_jax_hipt(dtype, **flags):
    return jhipt.HIPT4K(
        vit256_config=dataclasses.replace(jvit.VIT_CONFIGS["vit_small"],
                                          dtype=dtype, **NARROW_256, **flags),
        vit4k_config=jvit.ViT4KConfig(dtype=dtype, **NARROW_4K, **flags))


def narrow_port_hipt(dtype, use_flash=False, use_fused_mlp=False,
                     use_fused_block=True):
    """The port's narrow HIPT; by default every block is the fused block,
    as build_encoder makes it."""
    return make_hipt_encoder(
        dtype, use_flash, use_fused_mlp, use_fused_block,
        vit256_cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                       **NARROW_256),
        vit4k_cfg=vit.ViT4KConfig(**NARROW_4K))


def narrow_params(seed=0):
    """JAX variables of the narrow HIPT with every leaf perturbed (so
    biases, norms and both pos-embeds are non-trivial)."""
    rng = np.random.default_rng(seed)
    v = narrow_jax_hipt(jnp.float32).init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, 256, 256, 3)))
    return jax.tree.map(
        lambda a: a + 0.02 * rng.normal(size=a.shape).astype(np.float32), v)


@pytest.fixture(scope="module")
def regions():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, size=(2, 512, 512, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def params():
    return narrow_params()


@pytest.mark.parametrize("dtype,tol", [("float32", (0.0, 1e-4)),
                                       ("bfloat16", (5e-2, 5e-2))])
def test_narrow_hipt_matches_jax(dtype, tol, regions, params):
    """f32 port against JAX f32 (XLA) at atol 1e-4; bf16 port (the fused
    block's rounding points) against JAX bf16 at rtol/atol 5e-2."""
    jdt = getattr(jnp, dtype)
    x = jhipt.hipt_eval_normalize(jnp.asarray(regions))
    want = np.asarray(narrow_jax_hipt(jdt).apply(params, x))
    model = narrow_port_hipt(getattr(torch, dtype))
    model.load_state_dict(hipt_state_dict_from_jax(params))
    with torch.inference_mode():
        got = model(hipt_eval_normalize(torch.from_numpy(regions)))
    assert got.dtype == torch.float32 and got.shape == (2, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol[0], atol=tol[1])


def test_state_dict_round_trip():
    """port state dict -> hipt_params_from_torch -> hipt_state_dict_from_jax
    gives back the same tensors (full depth, which the JAX converter
    assumes; narrow widths)."""
    model = make_hipt_encoder(
        torch.float32,
        vit256_cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                       embed_dim=32, num_heads=2),
        vit4k_cfg=vit.ViT4KConfig(input_embed_dim=32, output_embed_dim=32,
                                  num_heads=2),
        generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    split = {p: {k[len(p) + 1:]: v.numpy() for k, v in sd.items()
                 if k.startswith(p + ".")} for p in ("vit256", "vit4k")}
    back = hipt_state_dict_from_jax(
        hipt_params_from_torch(split["vit256"], split["vit4k"]))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("grid", [(16, 16), (2, 2), (14, 14), (3, 5)])
def test_pos_embed_interpolation_matches_jax(grid, rng):
    """torch bicubic with the +0.1 scale fudge against the JAX package's
    hand-written torch-semantics resize."""
    pe = rng.normal(size=(1, 197, 24)).astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(pe), grid))
    got = interpolate_pos_embed(torch.from_numpy(pe), *grid)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pos_embed_cache_follows_the_parameter():
    """Interpolated once per grid shape, and recomputed after the
    parameter is reloaded."""
    net = vit.VisionTransformer(dataclasses.replace(
        vit.VIT_CONFIGS["vit_small"], embed_dim=16, depth=1, num_heads=2))
    a = net._pe.get(net.pos_embed, 16, 16)
    assert net._pe.get(net.pos_embed, 16, 16) is a
    sd = net.state_dict()
    sd["pos_embed"] = torch.ones_like(sd["pos_embed"])
    net.load_state_dict(sd)
    b = net._pe.get(net.pos_embed, 16, 16)
    assert b is not a
    np.testing.assert_allclose(b.numpy(), 1.0, atol=1e-6)


def test_dino_checkpoints_load_into_the_port(tmp_path):
    """Reference DINO files ('teacher' entry, stacked 'module.backbone.'
    prefixes, a projection head the ViTs do not hold) load as they are; a
    checkpoint missing a ViT key raises."""
    src = narrow_port_hipt(torch.float32)
    vit.init_dino_(src, torch.Generator().manual_seed(4))
    paths = []
    for name, net in (("vit256", src.vit256), ("vit4k", src.vit4k)):
        sd = {f"module.backbone.{k}": v for k, v in net.state_dict().items()}
        sd["module.head.last_layer.weight"] = torch.zeros(3, 3)
        paths.append(str(tmp_path / f"{name}.pth"))
        torch.save({"teacher": sd, "student": {}}, paths[-1])
    dst = narrow_port_hipt(torch.float32)
    load_dino_(dst, *(load_torch_state_dict(p) for p in paths))
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        assert torch.equal(v, want[k]), k
    partial = load_torch_state_dict(paths[0])
    del partial["norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        load_dino_(dst, partial, load_torch_state_dict(paths[1]))
