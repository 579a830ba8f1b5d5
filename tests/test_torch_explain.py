"""The port's explain stage held against the JAX package on the CPU.

- The ViTs' last-block attention (``get_last_selfattention`` of both ViTs,
  ``get_intermediate_layers``, ``HIPT4K.region_attention``) at narrow widths
  on weights bridged from the JAX tree: f32 plain at atol 1e-5; bf16
  ``use_fused_block`` against the JAX fused block in interpret mode at
  tests/test_fused_block.py's attention band (rtol 5e-2, atol 3e-2); and
  the port's shared-prefix ``region_attention`` bit for bit against its own
  ``get_last_selfattention`` and ``forward`` run separately.
- Given the same scores or CLS maps, every rasterizer and gallery of
  explain/heatmaps.py and explain/hierarchical.py gives the JAX package's
  uint8 images bit for bit (each package's ``*_cls_maps`` monkeypatched to
  the same maps), and the colour tables equal matplotlib's ``cm(x)``.
- ``infer_attention`` against the JAX package's at 1e-5.
"""
import dataclasses
import functools
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.explain import heatmaps as jhm
from hipt_abmil_atec23_tpu.explain import hierarchical as jhier
from hipt_abmil_atec23_tpu.models import build_mil_model as jax_mil
from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models import vit as jvit
from hipt_abmil_atec23_tpu.ops import fused_block as jfb
from hipt_abmil_atec23_tpu.slideio.reader import ImageSlide as JaxImageSlide
from hipt_abmil_atec23_tpu.slideio.seg import segment_tissue as jax_seg
from hipt_abmil_atec23_tpu_torch.explain import colormaps
from hipt_abmil_atec23_tpu_torch.explain import heatmaps as hm
from hipt_abmil_atec23_tpu_torch.explain import hierarchical as hier
from hipt_abmil_atec23_tpu_torch.models import hipt, vit
from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_state_dict_from_jax, mil_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.slideio.reader import ImageSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue
from hipt_abmil_atec23_tpu_torch.utils.config import SegConfig
from test_torch_hipt import narrow_jax_hipt, narrow_port_hipt

F32_TOL = 1e-5
BF16_TOL = dict(rtol=5e-2, atol=3e-2)   # tests/test_fused_block.py's band


def _interpret(fn, *args, **kwargs):
    """Run a JAX call with the fused block's pallas_call in interpret mode."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jfb.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _apply(fused, module, variables, *args, method, **kw):
    """``module.apply(variables, *args, method=method, **kw)`` jitted, the
    fused block in interpret mode when ``fused``."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, method=method, **kw))
    return _interpret(fn, variables, *args) if fused else fn(variables, *args)


def seeded_params(seed: int):
    """Variables of the narrow JAX HIPT drawn from a numpy seed on the tree
    jax.eval_shape gives (an eager init of it takes seconds): LayerNorm
    scales 1 + 0.02 n, kernels lecun-normal, every other leaf 0.02 n."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: narrow_jax_hipt(jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        n = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1 + 0.02 * n
        if name.endswith("kernel']"):
            return n / np.float32(np.sqrt(leaf.shape[0]))
        return 0.02 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def params():
    return seeded_params(4)


@pytest.fixture(scope="module")
def regions():
    """Two 512^2 uint8 regions: 4 tiles each."""
    return np.random.default_rng(5).integers(0, 256, size=(2, 512, 512, 3),
                                             dtype=np.uint8)


def _port(dtype, params, fused):
    model = narrow_port_hipt(dtype, use_fused_block=fused)
    model.load_state_dict(hipt_state_dict_from_jax(params))
    return model.eval()


def _jax(dtype, fused):
    return (narrow_jax_hipt(dtype, use_fused_block=True) if fused
            else narrow_jax_hipt(dtype))


CASES = [("float32", False), ("bfloat16", True)]


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("dtype,fused", CASES)
def test_last_selfattention_matches_jax(dtype, fused, params, regions):
    """Both ViTs' last-block probabilities and ViT-256's intermediate
    layers against JAX, on one region's tiles and its CLS grid; the
    probabilities come back in the block's dtype."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm, model = _jax(jdt, fused), _port(tdt, params, fused)
    tiles = regions[0].reshape(2, 256, 2, 256, 3).transpose(
        0, 2, 1, 3, 4).reshape(4, 256, 256, 3)
    x = jhipt.hipt_eval_normalize(jnp.asarray(tiles))
    xt = hipt.hipt_eval_normalize(torch.from_numpy(tiles))
    v256 = {"params": params["params"]["vit256"]}
    v4k = {"params": params["params"]["vit4k"]}
    j256 = jvit.VisionTransformer(jm.vit256_config)
    j4k = jvit.VisionTransformer4K(jm.vit4k_config)
    want = _apply(fused, j256, v256, x, method=j256.get_last_selfattention)
    want_mid = _apply(fused, j256, v256, x, n=2,
                      method=j256.get_intermediate_layers)
    grid = np.random.default_rng(6).normal(size=(2, 3, 4, 64)).astype(
        np.float32)
    want4k = _apply(fused, j4k, v4k, jnp.asarray(grid),
                    method=j4k.get_last_selfattention)
    with torch.inference_mode():
        got = model.vit256.get_last_selfattention(xt)
        got_mid = model.vit256.get_intermediate_layers(xt, n=2)
        got4k = model.vit4k.get_last_selfattention(torch.from_numpy(grid))
    assert got.dtype == tdt and got.shape == (4, 2, 257, 257)
    assert got4k.dtype == tdt and got4k.shape == (2, 2, 13, 13)
    _close(got, want, dtype)
    _close(got4k, want4k, dtype)
    assert len(got_mid) == len(want_mid) == 2
    for g, w in zip(got_mid, want_mid):
        assert g.dtype == torch.float32
        _close(g, w, dtype)
    # the patch galleries' extraction: the CLS rows as f32 [P, heads, 16, 16]
    cls = hier.patch_attention_cls_maps(model.vit256, tiles)
    assert cls.dtype == np.float32
    _close(cls, np.asarray(want, np.float32)[:, :, 0, 1:].reshape(
        4, 2, 16, 16), dtype)


@pytest.mark.parametrize("dtype,fused", CASES)
def test_region_attention_matches_jax(dtype, fused, params, regions):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm, model = _jax(jdt, fused), _port(tdt, params, fused)
    w256, w4k = _apply(fused, jm, params,
                       jhipt.hipt_eval_normalize(jnp.asarray(regions)),
                       method=jm.region_attention)
    with torch.inference_mode():
        g256, g4k = model.region_attention(
            hipt.hipt_eval_normalize(torch.from_numpy(regions)))
    assert g256.shape == (8, 2, 257, 257) and g4k.shape == (2, 2, 5, 5)
    _close(g256, w256, dtype)
    _close(g4k, w4k, dtype)
    # the galleries' extraction: only the CLS rows, f32, as JAX's _extract
    c256, c4k = hier.region_attention_cls_maps(model, regions)
    assert c256.dtype == c4k.dtype == np.float32
    w256, w4k = np.asarray(w256, np.float32), np.asarray(w4k, np.float32)
    _close(c256, w256[:, :, 0, 1:].reshape(2, 4, 2, 16, 16), dtype)
    _close(c4k, w4k[:, :, 0, 1:].reshape(2, 2, 2, 2), dtype)


@pytest.mark.parametrize("dtype,fused", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", True)])
def test_region_attention_shares_the_prefix_exactly(dtype, fused, params,
                                                    regions):
    """One shared ViT-256 prefix gives bit for bit what the two separate
    walks give: get_last_selfattention on the tiles, and ViT-4K's
    get_last_selfattention on forward's CLS grid."""
    model = _port(getattr(torch, dtype), params, fused)
    x = hipt.hipt_eval_normalize(torch.from_numpy(regions))
    with torch.inference_mode():
        a256, a4k = model.region_attention(x)
        tiles = model._tiles(x)
        want256 = model.vit256.get_last_selfattention(tiles)
        grid = model.vit256(tiles).reshape(2, 2, 2, -1)
        want4k = model.vit4k.get_last_selfattention(grid)
    assert torch.equal(a256, want256) and torch.equal(a4k, want4k)


def test_fused_region_attention_runs_the_block_op_17_times(monkeypatch):
    """Under use_fused_block a region_attention call at full depth (12 and
    6 blocks, narrow widths) runs ops/fused_block 11 + 1 + 5 times: the
    shared prefix once, the last ViT-256 block once for the CLS, ViT-4K's
    prefix. The two separate walks would run it 28 times."""
    calls = []
    orig = vit.fused_vit_block

    def counting(x, blk, **kw):
        calls.append(tuple(x.shape))
        return orig(x, blk, **kw)

    monkeypatch.setattr(vit, "fused_vit_block", counting)
    model = hipt.make_hipt_encoder(
        torch.float32, use_fused_block=True,
        vit256_cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                       embed_dim=32, num_heads=1),
        vit4k_cfg=vit.ViT4KConfig(input_embed_dim=32, output_embed_dim=32,
                                  num_heads=1),
        generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model.region_attention(torch.zeros(1, 256, 512, 3))
    assert len(calls) == 17
    assert calls[:12] == [(2, 264, 32)] * 12 and calls[12:] == [(1, 8, 32)] * 5


def test_center_crop_multiple_matches_jax(rng):
    x = rng.integers(0, 256, size=(2, 700, 530, 3), dtype=np.uint8)
    for m in (256, 128):
        got = hipt.center_crop_multiple(x, m)
        assert np.array_equal(got, jhipt.center_crop_multiple(x, m))
        assert got.shape[1] % m == 0 and got.shape[2] % m == 0


# --------------------------------------------------------------- colours
GRID = np.concatenate([
    np.linspace(0.0, 1.0, 4097), [0.0, 1.0, np.nextafter(1.0, 0.0),
                                  1 - 1e-12, 0.5, -1e-9, -0.3, 1.0 + 1e-9,
                                  1.7, -np.inf, np.inf, np.nan]])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["coolwarm", "light_jet"])
def test_colour_tables_equal_matplotlib(name, dtype):
    """Table lookups equal matplotlib's cm(x) at every point of a grid
    with 0, 1, values just under 1, values outside [0, 1] and NaN, in both
    float widths, and on a 500 x 500 draw."""
    from matplotlib import colormaps as mpl
    ref = (mpl.get_cmap("coolwarm") if name == "coolwarm"
           else jhier.light_jet_cmap())
    cm = colormaps.get_cmap(name)
    assert cm.N == ref.N
    x = GRID.astype(dtype)
    np.testing.assert_array_equal(cm(x), ref(x))
    draw = np.random.default_rng(0).random((500, 500)).astype(dtype)
    np.testing.assert_array_equal(cm(draw), ref(draw))
    with pytest.raises(ValueError, match="coolwarm"):
        colormaps.get_cmap("viridis")


# --------------------------------------------------------------- rasters
@pytest.fixture(scope="module")
def slide_pair():
    """One tissue image as each package's ImageSlide, with each package's
    segmentation of it."""
    from hipt_abmil_atec23_tpu.slideio.synthetic import make_tissue_image
    img = make_tissue_image(2048, 1536, seed=2)
    cfg = SegConfig(use_otsu=True, a_t=1)
    from hipt_abmil_atec23_tpu.utils.config import SegConfig as JaxSeg
    js, ts = JaxImageSlide(img), ImageSlide(img)
    return (js, jax_seg(js, JaxSeg(use_otsu=True, a_t=1)), ts,
            segment_tissue(ts, cfg))


@pytest.fixture(scope="module")
def bag_scores():
    rng = np.random.default_rng(8)
    coords = np.stack(np.meshgrid(np.arange(0, 2048, 256),
                                  np.arange(0, 1536, 256)), -1).reshape(-1, 2)
    scores = rng.normal(size=len(coords)).astype(np.float32)
    scores[3] = scores[5]  # a tie for the midrank
    return coords, scores


@pytest.mark.parametrize("kw", [
    dict(),
    dict(seg=True, alpha=0.6),
    dict(use_percentiles=False, blank_canvas=True),
    dict(binarize=True, thresh=0.3, vis_level=1, seg=True),
    dict(patch_level=1)])
def test_draw_heatmap_bit_equal(kw, slide_pair, bag_scores):
    js, jseg, ts, tseg = slide_pair
    coords, scores = bag_scores
    kw = dict(kw)
    seg = kw.pop("seg", False)
    want = jhm.draw_heatmap(js, coords, scores, 256,
                            seg=jseg if seg else None, **kw)
    got = hm.draw_heatmap(ts, coords, scores, 256,
                          seg=tseg if seg else None, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_seg_mask_and_percentiles_equal(slide_pair, bag_scores):
    js, jseg, ts, tseg = slide_pair
    for lvl in (1, 2):
        dims, ds = ts.level_dimensions[lvl], ts.level_downsamples[lvl]
        assert np.array_equal(hm.get_seg_mask(tseg, dims, ds),
                              jhm.get_seg_mask(jseg, dims, ds))
    _, scores = bag_scores
    assert np.array_equal(hm.to_percentiles(scores),
                          jhm.to_percentiles(scores))


@pytest.mark.parametrize("mode,kw", [
    ("topk", dict(k=5)), ("reverse_topk", dict(k=7)),
    ("range_sample", dict(k=4, seed=3)),
    ("range_sample", dict(k=50, score_range=(0.1, 0.9)))])
def test_sample_rois_equal(mode, kw, bag_scores):
    coords, scores = bag_scores
    got = hm.sample_rois(coords, scores, mode=mode, **kw)
    want = jhm.sample_rois(coords, scores, mode=mode, **kw)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="unknown sample mode"):
        hm.sample_rois(coords, scores, mode="best")


def test_vit_and_hierarchical_region_heatmaps_equal(rng):
    attn = rng.random((3, 2, 257, 257)).astype(np.float32)
    assert np.array_equal(hm.vit_attention_heatmaps(attn, (16, 16)),
                          jhm.vit_attention_heatmaps(attn, (16, 16)))
    a256 = rng.random((8, 2, 257, 257)).astype(np.float32)
    a4k = rng.random((2, 3, 5, 5)).astype(np.float32)
    got = hm.hierarchical_region_heatmaps(a256, a4k, (2, 2))
    want = jhm.hierarchical_region_heatmaps(a256, a4k, (2, 2))
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_hierarchical_helpers_equal(rng):
    from matplotlib import colormaps as mpl
    img = rng.integers(0, 256, size=(96, 64, 3), dtype=np.uint8)
    assert np.array_equal(hier.shift_pad(img, 7), jhier.shift_pad(img, 7))
    ims = [img, img[:40], img[:, :30]]
    for how in ("horizontal", "vertical"):
        assert np.array_equal(hier.concat_images(ims, how, gap=3),
                              jhier.concat_images(ims, how, gap=3))
    assert np.array_equal(hier._label(img, "4k[0]x256[2]"),
                          jhier._label(img, "4k[0]x256[2]"))
    v = rng.random((16, 16)).astype(np.float32)
    v[0, :4] = v[1, 0]
    assert np.array_equal(hier._rank100(v), jhier._rank100(v))
    tiles = rng.random((6, 16, 16)).astype(np.float32)
    assert np.array_equal(hier.concat_scores256(tiles, 2, 3, 64),
                          jhier.concat_scores256(tiles, 2, 3, 64))
    grid = rng.random((2, 3)).astype(np.float32)
    assert np.array_equal(hier.concat_scores4k(grid, (128, 192)),
                          jhier.concat_scores4k(grid, (128, 192)))
    maps = [rng.random((64, 64)) * 100 for _ in range(4)]
    for g, w in zip(hier.shift_average(maps, [0, 5, 10, 15]),
                    jhier.shift_average(maps, [0, 5, 10, 15])):
        assert np.array_equal(g, w)
    score = rng.random((96, 64)) * 1.2 - 0.1
    for ours, theirs in ((colormaps.light_jet_cmap(), jhier.light_jet_cmap()),
                         (colormaps.get_cmap("coolwarm"),
                          mpl.get_cmap("coolwarm"))):
        assert np.array_equal(hier.blend(score, img, 0.5, ours),
                              jhier.blend(score, img, 0.5, theirs))
        assert np.array_equal(
            hier.threshold_blend(score, img, 0.4, 0.5, ours),
            jhier.threshold_blend(score, img, 0.4, 0.5, theirs))


# ------------------------------------------------------------- galleries
@pytest.fixture
def same_maps(monkeypatch, rng):
    """Both packages' region and patch CLS extractors replaced by one that
    checks the variants it is handed are the same in both packages and
    returns the same seeded maps (6 heads at each level)."""
    seen = {}

    def maps(variants, kind):
        key = (kind, variants.tobytes())
        if key not in seen:
            r, h, w = variants.shape[:3]
            g = np.random.default_rng(len(seen))
            if kind == "region":
                seen[key] = (
                    g.random((r, (h // 256) * (w // 256), 6, 16, 16),
                             np.float32),
                    g.random((r, 6, h // 256, w // 256), np.float32))
            else:
                seen[key] = g.random((r, 6, 16, 16), np.float32)
        return seen[key]

    monkeypatch.setattr(jhier, "region_attention_cls_maps",
                        lambda m, v, x: maps(x, "region"))
    monkeypatch.setattr(hier, "region_attention_cls_maps",
                        lambda m, x: maps(x, "region"))
    monkeypatch.setattr(jhier, "patch_attention_cls_maps",
                        lambda m, v, x: maps(x, "patch"))
    monkeypatch.setattr(hier, "patch_attention_cls_maps",
                        lambda m, x: maps(x, "patch"))
    return seen


def _same_files(got, want):
    import cv2
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert np.array_equal(cv2.imread(g), cv2.imread(w)), g


def test_region_attention_heatmaps_equal(same_maps, rng):
    region = rng.integers(0, 256, size=(512, 768, 3), dtype=np.uint8)
    got = hier.region_attention_heatmaps(region, None, offset=64,
                                         threshold=0.5)
    want = jhier.region_attention_heatmaps(region, None, None, offset=64,
                                           threshold=0.5)
    assert len(same_maps) == 1   # both packages asked for the same variants
    for fam in want:
        assert len(got[fam]) == len(want[fam])
        for g, w in zip(got[fam], want[fam]):
            assert g.dtype == np.uint8 and np.array_equal(g, w), fam


@pytest.mark.parametrize("mode,kw", [
    ("indiv", dict(threshold=0.5)), ("concat", dict()),
    ("concat_select", dict(alpha=0.3))])
def test_hierarchical_gallery_equal(mode, kw, same_maps, rng, tmp_path):
    region = rng.integers(0, 256, size=(512, 512, 3), dtype=np.uint8)
    got = hier.hierarchical_gallery(region, None, str(tmp_path / "port"),
                                    "r0", mode=mode, offset=64, **kw)
    want = jhier.hierarchical_gallery(region, None, None,
                                      str(tmp_path / "jax"), "r0", mode=mode,
                                      offset=64, **kw)
    assert len(want) == {"indiv": 54, "concat": 36, "concat_select": 1}[mode]
    _same_files(got, want)


@pytest.mark.parametrize("mode,threshold", [("indiv", 0.5),
                                            ("concat", 0.5),
                                            ("concat", None)])
def test_patch_gallery_equal(mode, threshold, same_maps, rng, tmp_path):
    patch = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
    got = hier.patch_gallery(patch, None, str(tmp_path / "port"), "p0",
                             mode=mode, threshold=threshold)
    want = jhier.patch_gallery(patch, None, None, str(tmp_path / "jax"),
                               "p0", mode=mode, threshold=threshold)
    _same_files(got, want)


# ----------------------------------------------------------- MIL scores
@pytest.mark.parametrize("model_type,size,n", [
    ("clam_sb", "hipt_smaller", 300), ("clam_sb", "small", 1500),
    ("clam_mb", "hipt_smaller", 200)])
def test_infer_attention_matches_jax(model_type, size, n):
    """Un-normalised first-branch scores: the gated single-branch heads
    through the port's pool (its plain version here), the multi-branch
    head through its forward; JAX's through its apply_pooled."""
    d = 192 if size.startswith("hipt") else 1024
    jm = jax_mil(model_type, size_arg=size, n_classes=3)
    rng = np.random.default_rng(9)
    jp = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) / np.sqrt(a.shape[0])
                   if a.ndim == 2 else 0.05 * rng.normal(size=a.shape)
                   ).astype(np.float32),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(2),
                                       jnp.zeros((8, d)), None)))
    feats = rng.normal(size=(n, d)).astype(np.float32)
    want = jhm.infer_attention(jm, jp, feats)
    model = build_mil_model(model_type, size_arg=size, n_classes=3)
    model.load_state_dict(mil_state_dict_from_jax(jp, model_type, 3))
    got = hm.infer_attention(model.eval(), feats)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_explain_imports_neither_jax_nor_matplotlib():
    """The port's explain modules and CLI, and a heatmap and a gallery blend
    drawn with them, load no jax, no module of the JAX package and no
    matplotlib (a fresh interpreter)."""
    import subprocess
    import sys
    code = """
import sys
import numpy as np
from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.explain import driver, heatmaps, hierarchical
from hipt_abmil_atec23_tpu_torch.explain.colormaps import light_jet_cmap
from hipt_abmil_atec23_tpu_torch.slideio.reader import ImageSlide
img = np.full((512, 512, 3), 200, np.uint8)
coords = np.array([[0, 0], [256, 256]])
heatmaps.draw_heatmap(ImageSlide(img), coords, np.array([0.2, 0.9]), 256)
hierarchical.blend(np.random.rand(64, 64), img[:64, :64], 0.5,
                   light_jet_cmap())
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "hipt_abmil_atec23_tpu",
                "matplotlib"})
assert not bad, bad
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)
