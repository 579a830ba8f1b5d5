"""The port's ResNet and LeViT encoders through its encode and explain
entry points (engine/encode.py build_encoder / encode_slide,
explain/driver.py run_heatmap_job) held against the JAX package on the CPU
in f32, at full width on a few 256 px patches.

Both packages load one set of weights from one file: a reference-layout
ResNet-18 .pth (randomized BatchNorm statistics) and an original-layout
LeViT-128S .pth (the torch oracle of tests/test_levit_parity.py). The
slide is the port's in-memory JPEG-coefficient slide
(slideio/synthetic.DctMemorySlide), which offers all three rungs to both
packages' streams. Tolerances: per-patch relative L2 <= 1e-4 on the RGB
and plane rungs (f32 colour arithmetic in another order), 1e-2 on the DCT
rung (the two decodes' planes differ by up to 1 LSB on a few samples,
ROADMAP §C "IDCT"); heatmap probabilities and scores within 1e-5 of
max(1, |value|)."""
import dataclasses
import json
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.explain import driver as jdriver
from hipt_abmil_atec23_tpu.models.levit import SPECS as LEVIT_SPECS
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import save_params
from hipt_abmil_atec23_tpu_torch.explain import driver
from hipt_abmil_atec23_tpu_torch.explain.heatmaps import load_blockmap
from hipt_abmil_atec23_tpu_torch.models import resnet
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    build_mil_model, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
    DctMemorySlide, he_like_planes)
from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, ModelConfig, SegConfig)
from test_levit_parity import TorchLeViT, _randomize_bn_stats

REL = {"rgb": 1e-4, "yuv": 1e-4, "dct": 1e-2}
COORDS = np.array([[0, 0], [256, 0], [0, 256], [256, 256], [8, 24]])
BATCH = 2


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A reference-layout ResNet-18 .pth and an original-layout LeViT-128S
    .pth, seeded."""
    d = tmp_path_factory.mktemp("encoders")
    r18 = resnet.resnet18(generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in r18.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5),
                                  (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(
                        lo, hi, t.shape).astype(np.float32)))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(rng.normal(
                        0, 0.1, t.shape).astype(np.float32)))
    torch.save(r18.state_dict(), str(d / "r18.pth"))
    torch.manual_seed(1)
    lev = TorchLeViT(LEVIT_SPECS["levit_128s"])
    with torch.no_grad():
        for p in lev.parameters():
            p.normal_(0, 0.02)
    _randomize_bn_stats(lev.eval(), rng)
    torch.save(lev.state_dict(), str(d / "levit.pth"))
    return str(d / "r18.pth"), str(d / "levit.pth")


def jax_resnet18_encoder(ckpt, batch):
    """The JAX package's f32 resnet18 Encoder on a .pth, as its
    build_encoder makes it (engine/encode.py:326-357: the .pth through
    resnet_params_from_torch, the three jitted entries), without the
    eager CPU init that build_encoder runs first and then discards."""
    from hipt_abmil_atec23_tpu.models.convert import (
        load_torch_state_dict, resnet_params_from_torch)
    from hipt_abmil_atec23_tpu.models.resnet import (
        imagenet_normalize, resnet18)
    from hipt_abmil_atec23_tpu.ops.jpegdct import dct_regions_to_rgb
    from hipt_abmil_atec23_tpu.ops.yuv import yuv_planes_to_rgb
    model = resnet18()
    v = jax.device_put(resnet_params_from_torch(
        load_torch_state_dict(ckpt, checkpoint_key=None),
        layers=(2, 2, 2, 2), bottleneck=False))
    fwd = jax.jit(lambda v, x: model.apply(v, imagenet_normalize(x)))
    fwd_yuv = jax.jit(lambda v, y, cb, cr: model.apply(
        v, imagenet_normalize(yuv_planes_to_rgb(y, cb, cr))))
    fwd_dct = jax.jit(lambda v, *pack: model.apply(
        v, imagenet_normalize(dct_regions_to_rgb(*pack))))
    return jenc.Encoder(name="resnet18", apply=partial(fwd, v),
                        batch_size=batch, input_size=256, feat_dim=512,
                        variables=v, apply_yuv=partial(fwd_yuv, v),
                        apply_dct=partial(fwd_dct, v), jit_fwd=fwd,
                        jit_fwd_yuv=fwd_yuv, jit_fwd_dct=fwd_dct)


@pytest.fixture(scope="module")
def jax_r18(ckpts):
    return jax_resnet18_encoder(ckpts[0], BATCH)


@pytest.fixture(scope="module")
def slide():
    return DctMemorySlide(*he_like_planes(21, 512)[1:])


def _rung_calls(enc):
    """Count the port encoder's entries by rung."""
    calls = {"rgb": 0, "yuv": 0, "dct": 0}
    for kind, name in (("rgb", "apply"), ("yuv", "apply_yuv"),
                       ("dct", "apply_dct")):
        def wrapped(*a, _fn=getattr(enc, name), _k=kind):
            calls[_k] += 1
            return _fn(*a)
        setattr(enc, name, wrapped)
    return calls


def _rel(got, want):
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


@pytest.mark.parametrize("rung", ["rgb", "yuv", "dct"])
def test_resnet18_encode_slide_matches_jax(rung, ckpts, jax_r18, slide):
    """encode_slide with resnet18 on one rung in both packages (the other
    rungs switched off: the port's plane_rung / dct_rung, the JAX
    encoder's apply_yuv / apply_dct), 5 patches at batch 2 with one off
    the 16 px MCU lattice."""
    jax_enc = dataclasses.replace(
        jax_r18, apply_yuv=jax_r18.apply_yuv if rung == "yuv" else None,
        apply_dct=jax_r18.apply_dct if rung == "dct" else None)
    enc = encode.build_encoder(EncoderConfig(
        model_type="resnet18", batch_size=BATCH, dtype="float32",
        resnet_ckpt=ckpts[0]), device="cpu")
    assert (enc.input_size, enc.feat_dim, enc.normalize) == \
        (256, 512, "imagenet")
    enc.plane_rung, enc.dct_rung = rung == "yuv", rung == "dct"
    calls = _rung_calls(enc)
    want = jenc.encode_slide(slide, COORDS, jax_enc, region_size=256)
    got = encode.encode_slide(slide, COORDS, enc, region_size=256)
    assert calls == {k: (3 if k == rung else 0) for k in calls}
    assert got.shape == want.shape == (5, 512)
    assert _rel(got, want).max() <= REL[rung], _rel(got, want)


def test_levit_encodes_on_the_rgb_rung_only(ckpts, slide):
    """LeViT-128S from an original-layout .pth (levit_ckpt) on a slide
    that offers planes and DCT packs: the port takes neither (the JAX
    encoder has no apply_yuv / apply_dct), crops the 256 px patches to 224,
    and matches the JAX encoder."""
    cfg = dict(model_type="levit_128s", batch_size=BATCH, dtype="float32",
               levit_ckpt=ckpts[1])
    jax_enc = jenc.build_encoder(jcfg.EncoderConfig(**cfg))
    assert jax_enc.apply_yuv is None and jax_enc.apply_dct is None
    enc = encode.build_encoder(EncoderConfig(**cfg), device="cpu")
    assert (enc.input_size, enc.feat_dim, enc.plane_rung, enc.dct_rung) \
        == (224, 384, False, False)
    calls = _rung_calls(enc)
    stats = {}
    got = dict(encode.encode_stream([("s", slide, COORDS)], enc,
                                    region_size=256, stats=stats))["s"]
    want = jenc.encode_slide(slide, COORDS, jax_enc, region_size=256)
    assert calls == {"rgb": 3, "yuv": 0, "dct": 0}
    assert stats["regions_rgb"] == 5 and "dct_caps" not in stats
    assert got.shape == want.shape == (5, 384)
    assert _rel(got, want).max() <= REL["rgb"], _rel(got, want)


def test_resnet_heatmap_job_matches_jax(ckpts, jax_r18, tmp_path,
                                       monkeypatch):
    """run_heatmap_job (coarse grid, then the fine pass at half a patch's
    step, which encodes the new coords through build_encoder's encoder)
    with resnet18 from resnet_ckpt and a CLAM_SB small_resnet18 head (the
    `small` head's variant for ResNet-18's 512-d features; `small` itself
    takes 1024-d) from a reference-layout .pt: the same predictions,
    blockmap coords and scores as the JAX driver (its encoder the JAX
    package's resnet18 on the same .pth)."""
    monkeypatch.setattr(jenc, "build_encoder", lambda cfg: jax_r18)
    slides = tmp_path / "slides"
    slides.mkdir()
    write_synthetic_slide(str(slides / "r0.tif"), 1024, 1024, n_levels=2,
                          compression=native.COMPRESSION_DEFLATE, seed=0)
    head = init_reference_weights(
        build_mil_model("clam_sb", size_arg="small_resnet18"),
        torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "s_0_checkpoint.pt")
    save_params(ckpt, head)
    seg = dict(use_otsu=True, a_t=1, close=4)
    common = dict(slide_dir=str(slides), ckpt_path=ckpt, patch_size=256,
                  step_size=256, fine_pass=True, fine_step_fraction=0.5,
                  sample_topk=2)
    enc = dict(model_type="resnet18", batch_size=4, dtype="float32",
               resnet_ckpt=ckpts[0])
    model = dict(model_type="clam_sb", model_size="small_resnet18")
    jres = jdriver.run_heatmap_job(jdriver.HeatmapJobConfig(
        save_dir=str(tmp_path / "jax"), seg=jcfg.SegConfig(**seg),
        encoder=jcfg.EncoderConfig(**enc), model=jcfg.ModelConfig(**model),
        **common), verbose=False)
    tres = driver.run_heatmap_job(driver.HeatmapJobConfig(
        save_dir=str(tmp_path / "port"), seg=SegConfig(**seg),
        encoder=EncoderConfig(**enc), model=ModelConfig(**model), **common),
        device="cpu", verbose=False)
    assert len(tres) == len(jres) == 1
    t, j = tres[0], jres[0]
    assert (t["y_hat"], t["n_patches"]) == (j["y_hat"], j["n_patches"])
    assert t["n_patches"] >= 2
    np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=1e-5)
    (tc, ts), (jc, js) = [load_blockmap(str(tmp_path / k / "r0" /
                                            "r0_blockmap.h5"))
                          for k in ("port", "jax")]
    assert np.array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(js).max()))
    for k in ("port", "jax"):
        assert os.path.exists(tmp_path / k / "r0" / "r0_heatmap_fine.jpg")
    assert json.load(open(tmp_path / "port" / "predictions.json")) == tres
