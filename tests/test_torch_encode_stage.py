"""The port's encode stage (engine/encode.py: build_encoder's vit256 and HIPT
feature variants, encode_stream's transform / resize / staged / paced modes,
encode_and_store, encode_many) held against the JAX package, or against the
port's own overlapped stream, at narrow widths on the CPU (f32).

Narrow encoders, one set of weights for both packages (bridged with
models/convert.py): ViT-256 D=64 depth 2 on 256 px patches, and the narrow
HIPT of test_torch_hipt.py. Tolerances: 1e-4 between the packages at f32
(5e-2 at bf16); the staged stream bit for bit against the overlapped one
(the same CPU ops on the same batches)."""
import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.data.bags import FeatureBagStore as JaxStore
from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models import vit as jvit
from hipt_abmil_atec23_tpu.ops import augment as jaug
from hipt_abmil_atec23_tpu.ops.yuv import yuv_planes_to_rgb
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.models import vit
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_state_dict_from_jax, vit256_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.ops import augment as taug
from hipt_abmil_atec23_tpu_torch.ops.yuv import ycc_to_input
from hipt_abmil_atec23_tpu_torch.slideio.patching import (
    coords_attrs, enumerate_coords, save_coords_h5)
from hipt_abmil_atec23_tpu_torch.slideio import reader
from hipt_abmil_atec23_tpu_torch.slideio.reader import TiffSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue
from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, SegConfig, TileConfig)
from test_torch_hipt import (
    NARROW_256, narrow_jax_hipt, narrow_params, narrow_port_hipt)

TOL = 1e-4      # f32, port against the JAX package
BF16_TOL = 5e-2
BATCH = 4


def _jax_vit(dtype=jnp.float32):
    return jvit.VisionTransformer(dataclasses.replace(
        jvit.VIT_CONFIGS["vit_small"], dtype=dtype, **NARROW_256))


@pytest.fixture(scope="module")
def vit_params():
    rng = np.random.default_rng(3)
    v = _jax_vit().init(jax.random.PRNGKey(3), jnp.zeros((1, 256, 256, 3)))
    return jax.tree.map(
        lambda a: a + 0.02 * rng.normal(size=a.shape).astype(np.float32), v)


def jax_vit_encoder(params, batch=BATCH):
    """The JAX package's vit256 Encoder (engine/encode.py:292-325) at the
    narrow width, RGB and plane entries, on the CPU."""
    model = _jax_vit()

    @jax.jit
    def fwd(v, x):
        return model.apply(v, jhipt.hipt_eval_normalize(x))

    @jax.jit
    def fwd_yuv(v, y, cb, cr):
        return model.apply(v, yuv_planes_to_rgb(y, cb, cr) / 127.5 - 1.0)

    v = jax.device_put(params)
    return jenc.Encoder(name="vit256", apply=partial(fwd, v),
                        batch_size=batch, input_size=256, feat_dim=64,
                        variables=v, apply_yuv=partial(fwd_yuv, v),
                        apply_dct=None, jit_fwd=fwd, jit_fwd_yuv=fwd_yuv)


def port_vit_encoder(params, batch=BATCH):
    """build_encoder's vit256 on the narrow ViT-256 (every block the fused
    block op, its plain version on the CPU), the DCT rung off as the JAX
    encoder above has none."""
    model = vit.vit_small(torch.float32, use_fused_block=True,
                          cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                                  **NARROW_256))
    model.load_state_dict(vit256_state_dict_from_jax(params["params"]))
    enc = encode.build_encoder(
        EncoderConfig(model_type="vit256", batch_size=batch,
                      dtype="float32"), device="cpu", model=model)
    assert (enc.input_size, enc.feat_dim) == (256, 64)
    return dataclasses.replace(enc, dct_rung=False)


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    """A YCbCr 4:2:0 JPEG slide (planes offered) and a DEFLATE one, tiled
    at 256 px by the port's tile functions, coords h5s written."""
    d = tmp_path_factory.mktemp("enc_stage")
    out = {}
    for name, size, kw in (
            ("ycc", (1536, 1024), dict(ycbcr420=True, seed=3)),
            ("rgb", (1024, 1280), dict(
                compression=native.COMPRESSION_DEFLATE, seed=4))):
        path = str(d / f"{name}.tif")
        write_synthetic_slide(path, *size, n_levels=3, **kw)
        slide = TiffSlide(path)
        cfg = TileConfig(patch_size=256, step_size=256,
                         seg=SegConfig(use_otsu=True, close=4, a_t=1))
        coords = enumerate_coords(slide, segment_tissue(slide, cfg.seg), cfg)
        h5 = str(d / f"{name}.h5")
        save_coords_h5(h5, coords, coords_attrs(slide, cfg, name, str(d)))
        slide.close()
        assert len(coords) > BATCH
        out[name] = (path, h5, coords)
    return out


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_asset_dict_matches_jax(dtype, tol):
    """HIPT4K.asset_dict's four outputs (cls256, mean256 over a region's
    tiles in f32, cls4k, their concat) against the JAX asset_dict: within
    1e-4 at f32, 5e-2 at bf16 (the fused block's rounding points)."""
    params = narrow_params(seed=4)
    x = np.random.default_rng(2).integers(0, 256, (2, 512, 512, 3),
                                          dtype=np.uint8)
    jm = narrow_jax_hipt(getattr(jnp, dtype))
    want = jax.jit(lambda v, r: jm.apply(v, jhipt.hipt_eval_normalize(r),
                                         method=jm.asset_dict))(
        params, jnp.asarray(x))
    model = narrow_port_hipt(getattr(torch, dtype))
    model.load_state_dict(hipt_state_dict_from_jax(params))
    with torch.inference_mode():
        got = model.asset_dict(((torch.from_numpy(x).float() / 127.5) - 1.0))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, k
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("variant,dim", [("cls4k", 192), ("mean256", 64),
                                         ("concat", 256)])
def test_hipt_feature_variants(variant, dim):
    """build_encoder's hipt_features: apply, apply_yuv and the asset_dict
    entry agree, the concat's tail is the cls4k features bit for bit."""
    params = narrow_params(seed=4)
    model = narrow_port_hipt(torch.float32)
    enc = encode.build_encoder(
        EncoderConfig(batch_size=2, dtype="float32", hipt_features=variant),
        device="cpu", model=model, state_dict=hipt_state_dict_from_jax(params))
    assert enc.feat_dim == dim
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.integers(0, 256, (2, 512, 512), np.uint8))
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (2, 256, 256), np.uint8))
              for _ in range(2))
    planes = enc.apply_yuv(y, cb, cr)
    x = ycc_to_input(y, cb, cr, torch.float32)
    with torch.inference_mode():
        assets = model.asset_dict(x)
        cls4k = model(x)
    assert planes.shape == (2, dim)
    key = encode.HIPT_FEATURES[variant] or "features_cls4k"
    torch.testing.assert_close(planes, assets[key], rtol=0, atol=1e-6)
    assert torch.equal(assets["features_mean256_cls4k"][:, 64:], cls4k)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 512, 512, 3), np.uint8))
    assert enc.apply(rgb).shape == (2, dim)


def test_vit256_encoder_matches_jax(vit_params):
    """build_encoder('vit256') on 256 px patches against the JAX
    VisionTransformer at 1e-4; the full-width default is ViT-S (384-d);
    the ResNet and LeViT encoders build at full width with the JAX
    package's input_size and feat_dim (their features are held against
    the JAX package in test_torch_resnet.py, test_torch_levit.py and
    test_torch_encoders.py)."""
    x = np.random.default_rng(9).integers(0, 256, (3, 256, 256, 3),
                                          dtype=np.uint8)
    want = jax_vit_encoder(vit_params).apply(jnp.asarray(x))
    got = port_vit_encoder(vit_params).apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    full = encode.build_encoder(EncoderConfig(model_type="vit256"),
                                device="cpu")
    assert (full.input_size, full.feat_dim) == (256, 384)
    assert all(b.use_fused_block for b in full.model.blocks)
    for name, size, dim, normalize, rungs in (
            ("resnet50", 256, 1024, "imagenet", (True, True)),
            ("resnet18", 256, 512, "imagenet", (True, True)),
            ("levit_128s", 224, 384, "imagenet", (False, False)),
            ("levit_256", 224, 512, "imagenet", (False, False))):
        enc = encode.build_encoder(EncoderConfig(model_type=name),
                                   device="cpu")
        assert (enc.input_size, enc.feat_dim, enc.normalize,
                (enc.plane_rung, enc.dct_rung)) == (size, dim, normalize,
                                                    rungs), name
        assert enc.model.input_dtype == torch.bfloat16


@pytest.mark.parametrize("preset,tps,rung", [
    ("HIPT_augment_colour", 0, "rgb"), ("none", 224, "rgb"),
    ("HIPT_wang", 224, "rgb"), ("none", 256, "yuv")])
def test_encode_slide_transform_and_resize_match_jax(preset, tps, rung,
                                                     slides, vit_params):
    """encode_stream with a host transform and / or target_patch_size
    against the JAX encode_stream (its rung selector off: a plane-capable
    slide's RGB read upsamples chroma otherwise) on the plane-capable
    slide, and encode_slide taking both: either one
    keeps every batch on the RGB rung (resize with cv2 INTER_AREA, then
    the transform, the presets' generators in step); a resize to the
    patch size is none, so the plane rung stays open. 1e-4."""
    path, _, coords = slides["ycc"]
    stats = {}
    jt, tt = (m.build_transform(preset, seed=3) for m in (jaug, taug))
    slide = TiffSlide(path)
    try:
        want = dict(jenc.encode_stream(
            [("s", slide, coords)], jax_vit_encoder(vit_params),
            region_size=256, transform=jt, target_patch_size=tps,
            adaptive_rungs=False))["s"]
        got = dict(encode.encode_stream(
            [("s", slide, coords)], port_vit_encoder(vit_params),
            region_size=256, transform=tt, target_patch_size=tps,
            stats=stats))["s"]
        assert encode.encode_slide(
            slide, coords[:2], port_vit_encoder(vit_params),
            transform=taug.build_transform(preset, seed=3),
            target_patch_size=tps).shape == (2, 64)
    finally:
        slide.close()
    assert stats[f"regions_{rung}"] == len(coords)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("budget,flushes", [(None, 1), (1, 5),
                                            (3 * BATCH * 256 * 256 * 3, 2)])
def test_staged_stream_equals_overlapped(budget, flushes, slides,
                                         vit_params):
    """stage=True gives the overlapped stream's slides in job order
    (an empty job included) with equal features, bit for bit, at the
    default budget (one flush), a 1-byte budget (one batch per flush) and
    a budget of about three RGB batches."""
    enc = port_vit_encoder(vit_params)
    opened = {n: TiffSlide(p) for n, (p, _, _) in slides.items()}
    try:
        jobs = [("a", opened["ycc"], slides["ycc"][2][:7]),
                ("empty", opened["ycc"], np.zeros((0, 2), np.int64)),
                ("b", opened["rgb"], slides["rgb"][2][:9])]
        want = list(encode.encode_stream(jobs, enc, region_size=256))
        stats = {}
        kw = {} if budget is None else {"stage_budget_bytes": budget}
        got = list(encode.encode_stream(jobs, enc, region_size=256,
                                        stage=True, stats=stats, **kw))
    finally:
        for s in opened.values():
            s.close()
    assert [s for s, _ in got] == [s for s, _ in want] == ["a", "empty", "b"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["stage_flushes"] == flushes


def test_pace_shim_throttles_and_feeds_the_wire_estimate(slides,
                                                         vit_params):
    """pace_put_mbps really throttles the stream (wall >= 0.7 x
    h2d_bytes / pace, as the JAX package's test_encode_stream_pacing_shim
    asks) and the wire estimate reads the pace (wire_mbps_final within
    [0.8, 1.05] x pace, one sample a batch) on a CPU encoder; unpaced, a
    CPU stream takes no sample and keeps the hint, which seeds the rung
    selector from the first batch."""
    path, _, coords = slides["ycc"]
    coords = coords[:8]
    enc = port_vit_encoder(vit_params, batch=2)
    pace = 1.0  # MB/s
    slide = TiffSlide(path)
    try:
        stats = {}
        t0 = time.perf_counter()
        out = dict(encode.encode_stream([("a", slide, coords)], enc,
                                        region_size=256, stats=stats,
                                        wire_mbps_hint=pace,
                                        pace_put_mbps=pace))
        wall = time.perf_counter() - t0
        plain = {}
        ref = dict(encode.encode_stream([("a", slide, coords)], enc,
                                        region_size=256, stats=plain,
                                        wire_mbps_hint=50.0))
    finally:
        slide.close()
    floor_s = stats["h2d_bytes"] / 1e6 / pace
    assert wall >= 0.7 * floor_s, (wall, floor_s)
    assert 0.8 * pace <= stats["wire_mbps_final"] <= 1.05 * pace
    assert len(stats["wire_mbps_samples"]) == 4
    assert stats["rung_decisions"][0][0] == 0
    np.testing.assert_array_equal(out["a"], ref["a"])
    assert "wire_mbps_samples" not in plain
    assert plain["wire_mbps_final"] == 50.0
    assert plain["rung_decisions"][0] == [0, "yuv", 50.0]


def test_encode_and_store_resume(slides, vit_params, tmp_path):
    """encode_and_store writes h5 (features + coords) and pt bags that the
    JAX package's FeatureBagStore reads, equal to encode_slide's features;
    a second call skips the stored slide."""
    path, h5, coords = slides["rgb"]
    enc = port_vit_encoder(vit_params)
    store = FeatureBagStore(str(tmp_path / "feats"))
    assert encode.encode_and_store(path, h5, enc, store, "s1") == \
        store.pt_path("s1")
    slide = TiffSlide(path)
    try:
        want = encode.encode_slide(slide, coords, enc)
    finally:
        slide.close()
    feats, got_coords = JaxStore(str(tmp_path / "feats")).load_with_coords(
        "s1")
    np.testing.assert_array_equal(feats, want)
    np.testing.assert_array_equal(got_coords, coords)
    np.testing.assert_array_equal(store.load_features("s1"), want)
    assert encode.encode_and_store(path, h5, enc, store, "s1") is None


def test_encode_many_matches_jax(slides, vit_params, tmp_path,
                                monkeypatch):
    """encode_many over three slides in one stream against the JAX
    encode_many on the same weights (its streams with the rung selector
    off, so both keep each slide's rung): the same done list, bags within
    1e-4 read by either package's store, equal coords, and a second run
    skipping everything."""
    monkeypatch.setattr(jenc, "encode_stream",
                        partial(jenc.encode_stream, adaptive_rungs=False))
    jobs = [(slides["ycc"][0], slides["ycc"][1], "sA"),
            (slides["rgb"][0], slides["rgb"][1], "sB"),
            (slides["ycc"][0], slides["ycc"][1], "sC")]
    store = FeatureBagStore(str(tmp_path / "port"))
    done, failed = encode.encode_many(jobs, port_vit_encoder(vit_params),
                                      store, verbose=False)
    jdone, jfailed = jenc.encode_many(jobs, jax_vit_encoder(vit_params),
                                      JaxStore(str(tmp_path / "jax")),
                                      verbose=False)
    assert done == jdone == ["sA", "sB", "sC"] and failed == jfailed == []
    port_in_jax = JaxStore(str(tmp_path / "port"))
    for sid, (_, _, coords) in zip(done, (slides["ycc"], slides["rgb"],
                                          slides["ycc"])):
        f, c = port_in_jax.load_with_coords(sid)
        jf, jc = JaxStore(str(tmp_path / "jax")).load_with_coords(sid)
        np.testing.assert_array_equal(c, coords)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(f, jf, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(
            FeatureBagStore(str(tmp_path / "jax")).load_features(sid), jf)
    assert encode.encode_many(jobs, port_vit_encoder(vit_params), store,
                              verbose=False) == ([], [])


def test_encode_many_flushes_writes_on_a_stream_failure(slides, vit_params,
                                                        tmp_path,
                                                        monkeypatch):
    """A stream that dies after its first slide: the error propagates, the
    slide reported done is on disk, every handle is closed (the prefetched
    group's too: nine slides make two groups) and the stage resumes."""
    path, h5, _ = slides["rgb"]
    enc = port_vit_encoder(vit_params)
    store = FeatureBagStore(str(tmp_path / "flush"))
    real = encode.encode_stream
    opened, closed = [], []
    real_open_slide = reader.open_slide

    def tracking_open(p, *a, **k):
        s = real_open_slide(p, *a, **k)
        opened.append(s)
        real_close = s.close
        s.close = lambda: (closed.append(s), real_close())
        return s

    def first_then_boom(jobs, *a, **k):
        it = real(jobs, *a, **k)
        try:
            yield next(it)
        finally:
            it.close()
        raise RuntimeError("device fell over")

    monkeypatch.setattr(reader, "open_slide", tracking_open)
    monkeypatch.setattr(encode, "encode_stream", first_then_boom)
    jobs = [(path, h5, f"f{i}") for i in range(9)]
    with pytest.raises(RuntimeError, match="device fell over"):
        encode.encode_many(jobs, enc, store, verbose=False)
    assert store.exists("f0") and not store.exists("f1")
    assert len(opened) == 9 and set(map(id, closed)) == set(map(id, opened))
    monkeypatch.setattr(encode, "encode_stream", real)
    done, failed = encode.encode_many(jobs[:3], enc, store, verbose=False)
    assert done == ["f1", "f2"] and failed == []


def test_encode_many_isolates_unreadable_slides_and_raises_write_errors(
        slides, vit_params, tmp_path):
    """A missing slide and a missing coords h5 are reported in ``failed``
    while the others are encoded; a store whose writes fail raises after
    the loop, naming the first slide."""
    path, h5, _ = slides["rgb"]
    enc = port_vit_encoder(vit_params)
    store = FeatureBagStore(str(tmp_path / "skip"))
    jobs = [(path, h5, "g1"), (str(tmp_path / "nope.tif"), h5, "bad"),
            (path, str(tmp_path / "nope.h5"), "bad_h5"), (path, h5, "g2")]
    done, failed = encode.encode_many(jobs, enc, store, verbose=False)
    assert done == ["g1", "g2"]
    assert [s for s, _ in failed] == ["bad", "bad_h5"]
    assert all(isinstance(e, Exception) for _, e in failed)
    assert not store.exists("bad") and store.exists("g2")

    class Broken(FeatureBagStore):
        def save(self, *a, **k):
            raise OSError("disk full")

    with pytest.raises(IOError, match="g1: disk full"):
        encode.encode_many(jobs[:1] + jobs[3:], enc,
                           Broken(str(tmp_path / "broken")), verbose=False)
