"""The port's CLI (hipt_abmil_atec23_tpu_torch/cli.py) end to end on the CPU,
held against the JAX package's CLI on the same folder of synthetic slides:
``tile`` (the same coords h5s and process list), ``encode --model_type
vit256`` with one DINO-layout checkpoint passed to both (bags within 1e-4,
f32 on both sides, each package's store reading the other's), and ``serve
--once`` on a reference-layout .pt CLAM head (its serve_config.json equal to
the JAX package's write_config output for the same flags)."""
import csv
import dataclasses
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hipt_abmil_atec23_tpu import cli as jcli
from hipt_abmil_atec23_tpu.data.bags import FeatureBagStore as JaxStore
from hipt_abmil_atec23_tpu.engine import serve as jserve
from hipt_abmil_atec23_tpu.slideio import native
from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
from hipt_abmil_atec23_tpu_torch.models.vit import vit_small

TOL = 1e-4  # f32 features, port against the JAX package
TILE = ["--patch_size", "256", "--step_size", "256", "--use_otsu",
        "--a_t", "1"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Two DEFLATE slides (RGB reads, so both packages ride one rung) and
    a DINO-layout ViT-S checkpoint (teacher entry, 'backbone.' prefixes,
    a head key the ViT ignores)."""
    d = tmp_path_factory.mktemp("cli")
    src = d / "slides"
    src.mkdir()
    for name, size, seed in (("a", (1536, 1024), 3), ("b", (1024, 1280), 4)):
        write_synthetic_slide(str(src / f"{name}.tif"), *size, n_levels=3,
                              compression=native.COMPRESSION_DEFLATE,
                              seed=seed)
    sd = vit_small(generator=torch.Generator().manual_seed(7)).state_dict()
    ckpt = str(d / "vit256_small_dino.pth")
    torch.save({"teacher": {**{f"backbone.{k}": v for k, v in sd.items()},
                            "head.last_layer.weight": torch.zeros(4, 4)}},
               ckpt)
    return d, src, ckpt


@pytest.fixture(scope="module")
def tiled(work):
    d, src, _ = work
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        assert main(["tile", "--source", str(src), "--save_dir",
                     str(d / f"tiles_{name}"), *TILE, *extra]) == 0
    return d


def test_cli_tile_matches_jax(tiled):
    """`tile` on a two-slide folder: the JAX CLI's coords and attrs (save
    path aside) and process list."""
    from hipt_abmil_atec23_tpu.slideio.patching import load_coords_h5
    for sid in ("a", "b"):
        tc, ta = load_coords_h5(str(tiled / "tiles_port/patches" /
                                    f"{sid}.h5"))
        jc, ja = load_coords_h5(str(tiled / "tiles_jax/patches" /
                                    f"{sid}.h5"))
        assert len(tc) > 0
        np.testing.assert_array_equal(tc, jc)
        for k in ja:
            if k != "save_path":
                np.testing.assert_array_equal(ta[k], ja[k])
    pd.testing.assert_frame_equal(
        pd.read_csv(tiled / "tiles_port/process_list_autogen.csv"),
        pd.read_csv(tiled / "tiles_jax/process_list_autogen.csv"))


def test_cli_encode_vit256_matches_jax(work, tiled):
    """`encode --model_type vit256 --float32` from the port's tiles with the
    same checkpoint: each slide's bag within 1e-4 of the JAX CLI's, coords
    equal, each store reading the other's bags; a slide whose file is
    missing lands in encode_failures.csv in both."""
    d, src, ckpt = work
    patches = tiled / "tiles_port/patches"
    (patches / "ghost.h5").write_bytes((patches / "a.h5").read_bytes())
    args = ["encode", "--data_h5_dir", str(tiled / "tiles_port"),
            "--data_slide_dir", str(src), "--model_type", "vit256",
            "--vit256_ckpt", ckpt, "--float32", "--batch_size", "8"]
    assert jcli.main(args + ["--feat_dir", str(d / "feats_jax")]) == 0
    assert cli.main(args + ["--feat_dir", str(d / "feats_port"),
                            "--device", "cpu"]) == 0
    for sid in ("a", "b"):
        f, c = JaxStore(str(d / "feats_port")).load_with_coords(sid)
        jf, jc = JaxStore(str(d / "feats_jax")).load_with_coords(sid)
        assert f.shape == (len(c), 384) and np.isfinite(f).all()
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(f, jf, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(
            FeatureBagStore(str(d / "feats_jax")).load_features(sid), jf)
    for name in ("port", "jax"):
        with open(d / f"feats_{name}" / "encode_failures.csv") as fh:
            assert [row[0] for row in csv.reader(fh)] == ["ghost"]
    os.remove(patches / "ghost.h5")


def test_cli_serve_once(work, tmp_path):
    """`serve --once --device cpu` scores a slide with the full-width
    HIPT_4K (f32, 512 px regions) and a .pt CLAM_SB head: its journal,
    result and a serve_config.json equal to the JAX write_config's for the
    same flags."""
    _, src, _ = work
    slide_dir = tmp_path / "inbox"
    slide_dir.mkdir()
    os.link(src / "b.tif", slide_dir / "b.tif")
    head = build_mil_model("clam_sb", size_arg="hipt_smaller")
    ckpt = str(tmp_path / "clam.pt")
    torch.save(head.state_dict(), ckpt)
    out = tmp_path / "out"
    assert cli.main(["serve", "--slide_dir", str(slide_dir), "--out_dir",
                     str(out), "--ckpt", ckpt, "--patch_size", "512",
                     "--use_otsu", "--a_t", "1", "--float32", "--once",
                     "--min_stable_s", "0", "--device", "cpu"]) == 0
    rec = json.load(open(out / "results" / "b.json"))
    assert rec["status"] == "done" and rec["n_regions"] > 0
    assert abs(sum(rec["p"]) - 1) < 1e-5
    with open(out / "serve_journal.csv") as fh:
        assert [(r["slide_id"], r["status"]) for r in csv.DictReader(fh)] \
            == [("b", "done")]
    jc = jserve.ServeConfig(
        slide_dir=str(slide_dir), out_dir=str(tmp_path / "jax"),
        ckpt_path=ckpt, encoder=jcfg.EncoderConfig(batch_size=2,
                                                   dtype="float32"),
        tile=jcfg.TileConfig(patch_size=512, step_size=512,
                             seg=jcfg.SegConfig(use_otsu=True, a_t=1)),
        min_stable_s=0.0)
    jserve.write_config(jc)
    got = json.load(open(out / "serve_config.json"))
    want = json.load(open(tmp_path / "jax" / "serve_config.json"))
    want["out_dir"] = str(out)
    assert got == want


@pytest.mark.parametrize("argv,match", [
    (["encode", "--model_type", "resnet50"], "ROADMAP §A.11"),
    (["encode", "--model_type", "levit_256"], "ROADMAP §A.11"),
    (["serve", "--encoder", "resnet18"], "ROADMAP §A.11"),
    (["serve", "--ckpt", "head.ckpt"], "ROADMAP §A.7")])
def test_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    """Encoders and checkpoint formats the port does not have yet raise
    before any work, naming the ROADMAP item that ports them."""
    base = {"encode": ["--data_h5_dir", str(tmp_path), "--data_slide_dir",
                       str(tmp_path), "--feat_dir", str(tmp_path / "f")],
            "serve": ["--slide_dir", str(tmp_path), "--out_dir",
                      str(tmp_path / "o")]}[argv[0]]
    if argv[0] == "serve" and "--ckpt" not in argv:
        base += ["--ckpt", "head.pt"]
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + base + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "o")
