"""The port's heatmap job (explain/driver.py) and the CLI's ``heatmap``
held against the JAX package on the CPU.

``run_heatmap_job`` (coarse and fine pass, one slide's bag read from the
feature cache, the other encoded) runs in both packages on two synthetic
TIFFs with the vit256 encoder in f32 (ViT-256 D=192 depth 2, one set of
weights bridged with models/convert.py) and one reference-layout .pt
CLAM_SB head: probabilities and blockmap scores within 1e-5; once both
packages' scores rank alike, the heatmaps and ROI exports are the same
files byte for byte. The CLI's single-slide path writes the JAX CLI's
files; ``--hierarchical --patch_gallery`` with DINO-layout torch ViT
checkpoints and ``--config`` run end to end, also from a flax
``.msgpack`` of the head."""
import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu import cli as jcli
from hipt_abmil_atec23_tpu.engine import encode as jenc
from hipt_abmil_atec23_tpu.explain import driver as jdriver
from hipt_abmil_atec23_tpu.models import hipt as jhipt
from hipt_abmil_atec23_tpu.models import vit as jvit
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
from hipt_abmil_atec23_tpu_torch.engine import encode
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import save_params
from hipt_abmil_atec23_tpu_torch.explain import driver
from hipt_abmil_atec23_tpu_torch.explain.heatmaps import (
    load_blockmap, to_percentiles)
from hipt_abmil_atec23_tpu_torch.models import vit
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    build_mil_model, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.models.convert import (
    vit256_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.slideio.patching import (
    coords_attrs, enumerate_coords, save_coords_h5)
from hipt_abmil_atec23_tpu_torch.slideio.reader import TiffSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue
from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, SegConfig, TileConfig)

TOL = 1e-5
WIDTH = dict(embed_dim=192, depth=2, num_heads=3)   # hipt_smaller's input
SEG = dict(use_otsu=True, a_t=1, close=4)


def _jax_vit():
    return jvit.VisionTransformer(dataclasses.replace(
        jvit.VIT_CONFIGS["vit_small"], dtype=jnp.float32, **WIDTH))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Two DEFLATE slides, a seeded reference-layout CLAM_SB hipt_smaller
    .pt, and ViT-256 weights drawn on the JAX tree's shapes."""
    d = tmp_path_factory.mktemp("explain_driver")
    slides = d / "slides"
    slides.mkdir()
    for i, size in enumerate(((1024, 1024), (1280, 1024))):
        write_synthetic_slide(str(slides / f"hm{i}.tif"), *size, n_levels=3,
                              compression=native.COMPRESSION_DEFLATE,
                              seed=i)
    head = init_reference_weights(
        build_mil_model("clam_sb", size_arg="hipt_smaller"),
        torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(p.numel())))
    ckpt = str(d / "s_0_checkpoint.pt")
    save_params(ckpt, head)
    rng = np.random.default_rng(11)
    vit_params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            1 + 0.02 * rng.normal(size=leaf.shape) if
            jax.tree_util.keystr(path).endswith("['scale']") else
            rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0]) if
            jax.tree_util.keystr(path).endswith("kernel']") else
            0.02 * rng.normal(size=leaf.shape)).astype(np.float32),
        jax.eval_shape(lambda: _jax_vit().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))))
    return d, slides, ckpt, vit_params


def _encoders(vit_params, batch=8):
    """The vit256 encoder of each package on the same weights: JAX's
    (engine/encode.py:292-325 at this width, RGB entry) and the port's
    build_encoder (every block the fused block op, its plain version on
    the CPU)."""
    model = _jax_vit()

    @jax.jit
    def fwd(v, x):
        return model.apply(v, jhipt.hipt_eval_normalize(x))

    v = jax.device_put(vit_params)
    jax_enc = jenc.Encoder(name="vit256", apply=partial(fwd, v),
                           batch_size=batch, input_size=256, feat_dim=192,
                           variables=v, jit_fwd=fwd)
    port = vit.vit_small(torch.float32, use_fused_block=True,
                         cfg=dataclasses.replace(vit.VIT_CONFIGS["vit_small"],
                                                 **WIDTH))
    port.load_state_dict(vit256_state_dict_from_jax(vit_params["params"]))
    port_enc = dataclasses.replace(encode.build_encoder(
        EncoderConfig(model_type="vit256", batch_size=batch,
                      dtype="float32"), device="cpu", model=port),
        dct_rung=False)
    return jax_enc, port_enc


def _cached_bag(slides, feat_dir, sid="hm1"):
    """A seeded 192-d bag for one slide in the feature cache, one row per
    coarse coordinate, readable by both packages' stores."""
    slide = TiffSlide(str(slides / f"{sid}.tif"))
    cfg = TileConfig(patch_size=256, step_size=256, seg=SegConfig(**SEG))
    n = len(enumerate_coords(slide, segment_tissue(slide, cfg.seg), cfg))
    slide.close()
    feats = np.random.default_rng(12).normal(size=(n, 192)).astype(np.float32)
    FeatureBagStore(str(feat_dir)).save(sid, feats, formats=("pt",))


def test_run_heatmap_job_matches_jax(work, tmp_path, monkeypatch):
    _, slides, ckpt, vit_params = work
    jax_enc, port_enc = _encoders(vit_params)
    monkeypatch.setattr(jenc, "build_encoder", lambda cfg: jax_enc)
    monkeypatch.setattr(encode, "build_encoder",
                        lambda cfg, device: port_enc)
    feat_dir = tmp_path / "feats"
    _cached_bag(slides, feat_dir)
    common = dict(slide_dir=str(slides), ckpt_path=ckpt,
                  feat_dir=str(feat_dir), patch_size=256, step_size=256,
                  fine_pass=True, fine_step_fraction=0.5, sample_topk=3)
    jres = jdriver.run_heatmap_job(jdriver.HeatmapJobConfig(
        save_dir=str(tmp_path / "jax"), seg=jcfg.SegConfig(**SEG),
        encoder=jcfg.EncoderConfig(model_type="vit256", dtype="float32"),
        **common), verbose=False)
    tres = driver.run_heatmap_job(driver.HeatmapJobConfig(
        save_dir=str(tmp_path / "port"), seg=SegConfig(**SEG),
        encoder=EncoderConfig(model_type="vit256", dtype="float32"),
        **common), device="cpu", verbose=False)

    preds = [json.load(open(tmp_path / k / "predictions.json"))
             for k in ("port", "jax")]
    assert preds == [tres, jres] and len(tres) == 2
    for t, j in zip(*preds):
        assert (t["slide_id"], t["y_hat"], t["n_patches"]) == \
            (j["slide_id"], j["y_hat"], j["n_patches"])
        np.testing.assert_allclose(t["p"], j["p"], rtol=0, atol=TOL)
    for sid in ("hm0", "hm1"):
        dirs = [tmp_path / k / sid for k in ("port", "jax")]
        files = [sorted(os.listdir(p)) for p in dirs]
        assert files[0] == files[1], files
        assert {f"{sid}_heatmap.jpg", f"{sid}_heatmap_fine.jpg",
                f"{sid}_blockmap.h5", f"{sid}_seg.pkl"} <= set(files[0])
        assert sum(f.startswith("roi_") for f in files[0]) == 3
        (tc, ts), (jc, js) = [load_blockmap(str(p / f"{sid}_blockmap.h5"))
                              for p in dirs]
        assert np.array_equal(tc, jc)
        np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
        assert np.array_equal(to_percentiles(ts), to_percentiles(js))
        for f in files[0]:
            if f.endswith((".jpg", ".png")):
                assert (dirs[0] / f).read_bytes() == \
                    (dirs[1] / f).read_bytes(), f


@pytest.fixture(scope="module")
def one_slide(work):
    """hm0's coarse coords h5 and a seeded 192-d bag for it, as .npy."""
    d, slides, _, _ = work
    path = str(slides / "hm0.tif")
    slide = TiffSlide(path)
    cfg = TileConfig(patch_size=512, step_size=512, seg=SegConfig(**SEG))
    coords = enumerate_coords(slide, segment_tissue(slide, cfg.seg), cfg)
    h5 = str(d / "hm0_coords.h5")
    save_coords_h5(h5, coords, coords_attrs(slide, cfg, "hm0", str(d)))
    slide.close()
    feats = str(d / "hm0.npy")
    np.save(feats, np.random.default_rng(13).normal(
        size=(len(coords), 192)).astype(np.float32))
    return path, h5, feats


def test_cli_heatmap_single_slide_matches_jax(work, one_slide, tmp_path):
    """--features with a .pt head: the JAX CLI's files (heatmap jpg,
    blockmap, ROI pngs), the same bytes once the scores rank alike."""
    _, _, ckpt, _ = work
    slide, h5, feats = one_slide
    argv = ["heatmap", "--slide", slide, "--coords_h5", h5, "--features",
            feats, "--ckpt", ckpt, "--sample_topk", "2"]
    jcli.main(argv + ["--save_dir", str(tmp_path / "jax")])
    assert cli.main(argv + ["--save_dir", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    files = [sorted(os.listdir(tmp_path / k)) for k in ("port", "jax")]
    assert files[0] == files[1] and len(files[0]) == 4, files
    (_, ts), (_, js) = [load_blockmap(str(tmp_path / k / "hm0_blockmap.h5"))
                        for k in ("port", "jax")]
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    assert np.array_equal(to_percentiles(ts), to_percentiles(js))
    for f in files[0]:
        if not f.endswith(".h5"):
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), f


def test_cli_heatmap_galleries_from_torch_checkpoints(work, one_slide,
                                                      tmp_path):
    """--hierarchical --patch_gallery: full-width HIPT_4K in f32 from
    DINO-layout ViT-256 / ViT-4K checkpoints on two 512 px ROI regions;
    the gallery names are the JAX CLI's (_heatmap_galleries: one
    concat_select canvas per region, the top region's patch grids)."""
    from hipt_abmil_atec23_tpu_torch.models.hipt import make_hipt_encoder
    _, _, ckpt, _ = work
    slide, h5, feats = one_slide
    sd = make_hipt_encoder(torch.float32,
                           generator=torch.Generator().manual_seed(5)
                           ).state_dict()
    paths = {}
    for part in ("vit256", "vit4k"):
        paths[part] = str(tmp_path / f"{part}.pth")
        torch.save({"teacher": {f"backbone.{k[len(part) + 1:]}": v
                                for k, v in sd.items()
                                if k.startswith(part + ".")}},
                   paths[part])
    out = tmp_path / "hm"
    assert cli.main(["heatmap", "--slide", slide, "--coords_h5", h5,
                     "--features", feats, "--ckpt", ckpt, "--save_dir",
                     str(out), "--sample_topk", "2", "--hierarchical",
                     "--hier_regions", "2", "--patch_gallery",
                     "--vit256_ckpt", paths["vit256"], "--vit4k_ckpt",
                     paths["vit4k"], "--device", "cpu"]) == 0
    assert sorted(os.listdir(out / "galleries")) == [
        "hm0_roi0_heatmap.png", "hm0_roi0_patch_256hm.png",
        "hm0_roi0_patch_256th.png", "hm0_roi1_heatmap.png"]


def test_cli_heatmap_config_mode(work, tmp_path, monkeypatch, capsys):
    """--config runs the batch job on --device (every bag from the
    feature cache); --confirm prints the config and 'N' stops before any
    work; a flax .msgpack of the same head gives the same predictions
    within 1e-6."""
    _, slides, ckpt, _ = work
    feat_dir = tmp_path / "feats"
    _cached_bag(slides, feat_dir, "hm0")
    job = {"slide_dir": str(slides), "slides": ["hm0.tif"],
           "save_dir": str(tmp_path / "out"), "ckpt_path": ckpt,
           "feat_dir": str(feat_dir), "patch_size": 256, "step_size": 256,
           "seg": SEG, "model": {"model_size": "hipt_smaller"},
           "encoder": {"model_type": "vit256", "dtype": "float32"},
           "sample_topk": 2}
    cfg = tmp_path / "job.json"
    cfg.write_text(json.dumps(job))
    monkeypatch.setattr("builtins.input", lambda prompt: "N")
    with pytest.raises(SystemExit) as stop:
        cli.main(["heatmap", "--config", str(cfg), "--confirm",
                  "--device", "cpu"])
    assert stop.value.code == 0 and not (tmp_path / "out").exists()
    assert "ckpt_path : " + ckpt in capsys.readouterr().out
    assert cli.main(["heatmap", "--config", str(cfg), "--device",
                     "cpu"]) == 0
    files = set(os.listdir(tmp_path / "out" / "hm0"))
    assert {"hm0_heatmap.jpg", "hm0_blockmap.h5", "hm0_seg.pkl"} <= files
    pred = json.load(open(tmp_path / "out" / "predictions.json"))
    assert pred[0]["slide_id"] == "hm0" and abs(sum(pred[0]["p"]) - 1) < 1e-5

    # the same head as a flax checkpoint (the JAX package's format,
    # written here without flax): the same predictions
    from hipt_abmil_atec23_tpu_torch.engine.flax_ckpt import save_params
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        load_torch_state_dict, mil_params_to_jax)
    flax_head = str(tmp_path / "head.msgpack")
    save_params(flax_head, mil_params_to_jax(
        load_torch_state_dict(ckpt, checkpoint_key=None)))
    cfg.write_text(json.dumps({**job, "ckpt_path": flax_head,
                               "save_dir": str(tmp_path / "flax")}))
    assert cli.main(["heatmap", "--config", str(cfg), "--device",
                     "cpu"]) == 0
    again = json.load(open(tmp_path / "flax" / "predictions.json"))
    np.testing.assert_allclose(again[0]["p"], pred[0]["p"], rtol=0,
                               atol=1e-6)


def test_load_with_coords_matches_jax(tmp_path):
    """FeatureBagStore.load_with_coords reads a bag's features and coords
    from its h5, as the JAX package's store does, whichever wrote it."""
    from hipt_abmil_atec23_tpu.data.bags import FeatureBagStore as JaxStore
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(9, 192)).astype(np.float32)
    coords = rng.integers(0, 8192, size=(9, 2))
    FeatureBagStore(str(tmp_path / "port")).save("s", feats, coords=coords)
    JaxStore(str(tmp_path / "jax")).save("s", feats, coords=coords)
    for d in ("port", "jax"):
        got = FeatureBagStore(str(tmp_path / d)).load_with_coords("s")
        want = JaxStore(str(tmp_path / d)).load_with_coords("s")
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(got[0], feats) and np.array_equal(got[1],
                                                                coords)
