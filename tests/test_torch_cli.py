"""The port's CLI (hipt_abmil_atec23_tpu_torch/cli.py) end to end on the CPU,
held against the JAX package's CLI on the same inputs: ``tile`` (the same
coords h5s and process list), ``encode --model_type vit256`` with one
DINO-layout checkpoint passed to both (bags within 1e-4, f32 on both
sides, each package's store reading the other's), ``serve --once`` on a
reference-layout .pt CLAM head (its serve_config.json equal to the JAX
package's write_config output for the same flags), and ``splits -> train
-> eval -> bootstrap`` and ``count`` on synthetic feature bags (the same
file names and columns; the JAX CLI's eval reads the port's checkpoints).
serve also scores a flax head. The tuning, fold-parallel, export and
parity routes are in test_torch_cli_routes.py and test_torch_flax_ckpt.py."""
import contextlib
import csv
import dataclasses
import io
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


@pytest.mark.parametrize("argv,error,match", [
    (["serve", "--model_type", "transmil"], ValueError,
     "unknown model_type 'transmil'"),
    (["serve", "--model_type", "clam_mb"], None, None),
    (["serve", "--ckpt", "head.ckpt"], None, None)])
def test_cli_serve_head_kinds(argv, error, match, tmp_path, work):
    """A head type that does not exist is refused before the first drain
    with build_mil_model's ValueError (a daemon would log a failed drain
    and poll again). A clam_mb head is served from a reference-layout .pt;
    a flax checkpoint (any name but .pt, here ``head.ckpt``, written by the
    port's flax writer as the JAX package writes it) is served too. Each
    scores a slide through HIPT_4K (f32, 512 px regions) with the
    probabilities of the head itself on the bag serve kept (within
    1e-6)."""
    if error is not None:
        with pytest.raises(error, match=match):
            cli.main(argv + ["--slide_dir", str(tmp_path), "--out_dir",
                             str(tmp_path / "o"), "--ckpt", "head.pt",
                             "--device", "cpu"])
        assert not os.path.exists(tmp_path / "o")
        return
    from hipt_abmil_atec23_tpu_torch.engine import serve
    from hipt_abmil_atec23_tpu_torch.engine.flax_ckpt import save_params
    from hipt_abmil_atec23_tpu_torch.models.convert import mil_params_to_jax
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    os.link(work[1] / "b.tif", inbox / "b.tif")
    flax = "--ckpt" in argv
    model_type = "clam_sb" if flax else argv[2]
    head = build_mil_model(model_type, size_arg="hipt_smaller").eval()
    ckpt = str(tmp_path / ("head.ckpt" if flax else "head.pt"))
    if flax:
        save_params(ckpt, mil_params_to_jax(head.state_dict(), model_type))
    else:
        torch.save(head.state_dict(), ckpt)
    out = tmp_path / "o"
    assert cli.main([
        "serve", "--model_type", model_type, "--slide_dir", str(inbox),
        "--out_dir", str(out), "--ckpt", ckpt, "--patch_size", "512",
        "--use_otsu", "--a_t", "1", "--float32", "--once", "--min_stable_s",
        "0", "--save_features", "--device", "cpu"]) == 0
    rec = json.load(open(out / "results" / "b.json"))
    assert rec["status"] == "done" and abs(sum(rec["p"]) - 1) < 1e-5
    # the head itself on the bag serve kept
    feats = FeatureBagStore(str(out / "features")).load_features("b")
    want = serve._mil_bucketed(serve.ServeState(device="cpu", model=head),
                               feats).y_prob[0].numpy()
    np.testing.assert_allclose(rec["p"], want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One 1024^2 DEFLATE slide with a few tissue patches at 256 px, tiled
    by the port's CLI."""
    d = tmp_path_factory.mktemp("cli_tiny")
    src = d / "slides"
    src.mkdir()
    write_synthetic_slide(str(src / "t.tif"), 1024, 1024, n_levels=2,
                          compression=native.COMPRESSION_DEFLATE, seed=0)
    assert cli.main(["tile", "--source", str(src), "--save_dir",
                     str(d / "tiles"), *TILE, "--device", "cpu"]) == 0
    return d, src


@pytest.mark.parametrize("argv,dim", [
    (["encode", "--model_type", "resnet50", "--float32"], 1024),
    (["encode", "--model_type", "levit_256"], 512),
    (["serve", "--encoder", "resnet18", "--float32"], 512)])
def test_cli_runs_the_other_encoders(argv, dim, tiny, tmp_path):
    """`encode` with full-width ResNet50-trunc (f32) and LeViT-256 (bf16),
    and `serve --once` with ResNet-18 (f32) and a reference-layout .pt
    CLAM_SB small_resnet18 head, on the CPU with seeded weights: a bag of
    ``dim``-d finite features per slide over the tile stage's coords, and
    a scored slide."""
    d, src = tiny
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    coords, _ = load_coords_h5(str(d / "tiles" / "patches" / "t.h5"))
    assert len(coords) >= 2
    feat_dir = tmp_path / "f"
    if argv[0] == "encode":
        assert cli.main(argv + [
            "--data_h5_dir", str(d / "tiles"), "--data_slide_dir", str(src),
            "--feat_dir", str(feat_dir), "--batch_size", "4",
            "--device", "cpu"]) == 0
    else:
        inbox = tmp_path / "inbox"
        inbox.mkdir()
        os.link(src / "t.tif", inbox / "t.tif")
        ckpt = str(tmp_path / "head.pt")
        torch.save(build_mil_model("clam_sb", size_arg="small_resnet18")
                   .state_dict(), ckpt)
        out = tmp_path / "o"
        feat_dir = out / "features"
        assert cli.main(argv + [
            "--slide_dir", str(inbox), "--out_dir", str(out), "--ckpt",
            ckpt, "--model_size", "small_resnet18", "--patch_size", "256",
            "--use_otsu", "--a_t", "1", "--batch_size", "4", "--once",
            "--min_stable_s", "0", "--save_features", "--device",
            "cpu"]) == 0
        rec = json.load(open(out / "results" / "t.json"))
        assert rec["status"] == "done" and rec["n_regions"] > 0
        assert abs(sum(rec["p"]) - 1) < 1e-5
        coords = None   # serve tiles the slide itself
    feats, got = FeatureBagStore(str(feat_dir)).load_with_coords("t")
    assert feats.shape == (len(got), dim) and np.isfinite(feats).all()
    if coords is not None:
        np.testing.assert_array_equal(got, coords)
    else:
        assert len(got) == rec["n_regions"]


def test_train_extract_features_needs_the_slide_dirs(tmp_path):
    """`train --extract_features` (online encoding, tests/
    test_torch_online.py) stops before any work without --data_h5_dir and
    --data_slide_dir, as the JAX CLI does."""
    labels = tmp_path / "labels.csv"
    pd.DataFrame({"case_id": ["s0", "s1"], "slide_id": ["s0", "s1"],
                  "label": ["invalid", "effective"]}).to_csv(labels,
                                                            index=False)
    with pytest.raises(SystemExit, match="--data_h5_dir"):
        cli.main(["train", "--csv_path", str(labels), "--feat_dir",
                  str(tmp_path), "--results_dir", str(tmp_path / "o"),
                  "--extract_features", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "o")


def test_serve_loads_every_head(tmp_path):
    """serve_forever refuses an unknown head type before its first drain;
    _ensure_state builds and loads clam_mb and mil heads (binary and
    multi-class) from reference-layout .pt files, and _mil_bucketed scores
    a bag through them (1024-d bags for mil, from a stand-in encoder that
    keeps the test off a full ResNet50-trunc)."""
    from hipt_abmil_atec23_tpu_torch.engine import serve
    from hipt_abmil_atec23_tpu_torch.utils.config import ModelConfig
    cfg = serve.ServeConfig(slide_dir=str(tmp_path), out_dir=str(tmp_path),
                            ckpt_path="head.pt",
                            model=ModelConfig(model_type="transmil"))
    with pytest.raises(ValueError, match="unknown model_type"):
        serve.serve_forever(cfg, device="cpu", max_drains=1)
    for model_type, size, n_classes in (("clam_mb", "hipt_smaller", 2),
                                        ("mil", "small", 2),
                                        ("mil", "small", 3)):
        head = build_mil_model(model_type, size_arg=size,
                               n_classes=n_classes)
        ckpt = str(tmp_path / f"{model_type}{n_classes}.pt")
        torch.save(head.state_dict(), ckpt)
        cfg = serve.ServeConfig(
            slide_dir=str(tmp_path), out_dir=str(tmp_path), ckpt_path=ckpt,
            model=ModelConfig(model_type=model_type, model_size=size),
            n_classes=n_classes)
        encoder = type("Stub", (), {"feat_dim": head.size[0]})()
        state = serve.ServeState(device="cpu", encoder=encoder)
        serve._ensure_state(cfg, state)
        feats = np.random.default_rng(0).normal(
            size=(30, head.size[0])).astype(np.float32)
        out = serve._mil_bucketed(state, feats)
        with torch.no_grad():
            want = head(torch.from_numpy(feats))
        torch.testing.assert_close(out.y_prob, want.y_prob)
        assert out.a_raw.shape[1] == 512


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """24 synthetic 192-d bags (npy) with their labels.csv, and 3 slides'
    coords h5s for count."""
    from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
    d = tmp_path_factory.mktemp("bags")
    make_synthetic_bags(str(d / "feats"), n_slides=24, feat_dim=192,
                        signal=1.5, signal_fraction=0.4, seed=1)
    import h5py
    os.makedirs(d / "patches")
    for i, n in enumerate((5, 9, 2)):
        with h5py.File(d / "patches" / f"synth_{i:04d}.h5", "w") as f:
            f.create_dataset("coords", data=np.zeros((n, 2), np.int64))
    return d


def _run_both(argv_jax, argv_port):
    assert jcli.main(argv_jax) == 0
    assert cli.main(argv_port + ["--device", "cpu"]) == 0


def test_cli_splits_train_eval_bootstrap_count(bags, tmp_path, capsys):
    """splits -> train -> eval -> bootstrap -> count through both CLIs on
    one folder of bags: the split CSVs are the JAX CLI's bytes; train of
    fold 0 of 3 writes the JAX CLI's files and columns (its checkpoint as
    s_0_checkpoint.pt, the partial summary's name); the JAX CLI's eval
    reads the port's .pt and its fold CSV agrees with the port eval's
    within 1e-5; bootstrap gives the JAX CLI's keys, confusion matrix and
    slide count; count prints the JAX CLI's lines."""
    csv_path, feats = str(bags / "feats" / "labels.csv"), str(bags / "feats")
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    _run_both(["splits", "--csv_path", csv_path, "--split_dir",
               out["jax"] + "/splits", "--k", "3"],
              ["splits", "--csv_path", csv_path, "--split_dir",
               out["port"] + "/splits", "--k", "3"])
    names = sorted(os.listdir(out["jax"] + "/splits"))
    assert sorted(os.listdir(out["port"] + "/splits")) == names
    for n in names:
        assert open(f"{out['port']}/splits/{n}").read() == \
            open(f"{out['jax']}/splits/{n}").read()

    train = ["train", "--csv_path", csv_path, "--feat_dir", feats, "--k",
             "3", "--k_end", "1", "--max_epochs", "2", "--min_epochs", "1",
             "--max_patches_per_slide", "32", "--weighted_sample",
             "--exp_code", "cli"]
    _run_both(train + ["--results_dir", out["jax"] + "/results",
                       "--split_dir", out["jax"] + "/splits"],
              train + ["--results_dir", out["port"] + "/results",
                       "--split_dir", out["port"] + "/splits"])
    jfiles = set(os.listdir(out["jax"] + "/results"))
    pfiles = set(os.listdir(out["port"] + "/results"))
    assert {f for f in jfiles if f.endswith(".msgpack")} == \
        {"s_0_checkpoint.msgpack"}
    assert {f for f in pfiles if f.endswith(".pt")} == {"s_0_checkpoint.pt"}
    shared = {"summary_partial_0_1.csv", "experiment_cli.json", "fold_0.csv"}
    assert shared <= jfiles and shared <= pfiles
    for n in ("summary_partial_0_1.csv", "fold_0.csv"):
        assert list(pd.read_csv(f"{out['port']}/results/{n}").columns) == \
            list(pd.read_csv(f"{out['jax']}/results/{n}").columns)
    cfgs = [json.load(open(f"{out[k]}/results/experiment_cli.json"))
            for k in ("port", "jax")]
    for c, k in zip(cfgs, ("port", "jax")):
        c["results_dir"] = c["split_dir"] = ""
    assert cfgs[0] == cfgs[1]

    ev = ["eval", "--csv_path", csv_path, "--feat_dir", feats, "--k", "3",
          "--folds", "0", "--max_patches_per_slide", "32", "--models_dir",
          out["port"] + "/results", "--split_dir", out["port"] + "/splits"]
    _run_both(ev + ["--save_dir", out["jax"] + "/eval"],
              ev + ["--save_dir", out["port"] + "/eval"])
    p = pd.read_csv(f"{out['port']}/eval/fold_0.csv")
    j = pd.read_csv(f"{out['jax']}/eval/fold_0.csv")
    assert list(p.columns) == list(j.columns)
    assert list(p["slide_id"]) == list(j["slide_id"])
    np.testing.assert_allclose(p[["p_0", "p_1"]].values,
                               j[["p_0", "p_1"]].values, atol=1e-5)
    assert list(pd.read_csv(f"{out['port']}/eval/summary.csv").columns) == \
        list(pd.read_csv(f"{out['jax']}/eval/summary.csv").columns)

    boot = ["bootstrap", "--folds", "0", "--bootstraps", "2000"]
    _run_both(boot + ["--dirs", out["port"] + "/eval", "--out",
                      out["jax"] + "/boot.json"],
              boot + ["--dirs", out["port"] + "/eval", "--out",
                      out["port"] + "/boot.json"])
    jb, pb = (json.load(open(f"{out[k]}/boot.json")) for k in ("jax", "port"))
    assert set(pb) == set(jb)
    assert pb["confusion_matrix"] == jb["confusion_matrix"]
    assert pb["n_slides"] == jb["n_slides"] == len(p)

    capsys.readouterr()
    count = ["count", "--patches_dir", str(bags / "patches"), "--csv_path",
             csv_path]
    assert jcli.main(count) == 0
    want = capsys.readouterr().out
    assert cli.main(count + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and "total 16 patches over 3 slides" in got


def test_cli_train_full_bag_sharded(bags, tmp_path):
    """train --full_bag_sharded at world size 1 (a gloo group of one on
    the CPU): a checkpoint, a history and a summary row per fold."""
    res = tmp_path / "res"
    assert cli.main(["train", "--csv_path", str(bags / "feats/labels.csv"),
                     "--feat_dir", str(bags / "feats"), "--results_dir",
                     str(res), "--k", "3", "--max_epochs", "1",
                     "--full_bag_sharded", "--device", "cpu"]) == 0
    for k in range(3):
        assert (res / f"s_{k}_checkpoint.pt").exists()
        hist = pd.read_csv(res / f"history_{k}.csv")
        assert list(hist.columns) == ["epoch", "train_loss", "val_loss",
                                      "val_auc"]
    summary = pd.read_csv(res / "summary.csv")
    assert list(summary["folds"]) == [0, 1, 2]
    assert np.isfinite(summary["val_loss"]).all()


def test_cli_train_and_eval_need_a_card_by_default(tmp_path):
    """Without --device, train and eval run on cuda, and a host without a
    card refuses them before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for argv in (["train", "--results_dir", str(tmp_path / "o")],
                 ["eval", "--models_dir", str(tmp_path), "--save_dir",
                  str(tmp_path / "o")]):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv + ["--csv_path", "x.csv", "--feat_dir",
                             str(tmp_path)])
    assert not os.path.exists(tmp_path / "o")


@pytest.fixture(scope="module")
def dras_bags(tmp_path_factory):
    """12 synthetic 192-d bags of 200 or 201 instances (two shapes for the
    JAX package's HIPT_LGP aggregator to compile) as h5 feature bags with
    256 px grid coords (what --sampling reads), their labels.csv, and a
    16-d texture store (h5) for --texture_model levit_128s."""
    from hipt_abmil_atec23_tpu_torch.data.synthetic import make_synthetic_bags
    d = tmp_path_factory.mktemp("dras")
    manifest, store = make_synthetic_bags(str(d / "feats"), n_slides=12,
                                          feat_dim=192, bag_range=(200, 202),
                                          signal=1.5, signal_fraction=0.4,
                                          seed=2)
    grid = np.stack(np.meshgrid(np.arange(20), np.arange(13)), -1
                    ).reshape(-1, 2) * 256
    tex = FeatureBagStore(str(d / "tex"))
    rng = np.random.default_rng(3)
    for sid in manifest.slide_ids:
        f = store.load_features(sid)
        os.remove(store.npy_path(sid))
        store.save(sid, f, coords=grid[:len(f)], formats=("h5",))
        tex.save(sid, rng.normal(size=(len(f), 16)).astype(np.float32),
                 formats=("h5",))
    return d


DRAS = ["--samples_per_iteration", "16", "--resampling_iterations", "2",
        "--sampling_neighbors", "6", "--final_sample_size", "16"]


def test_cli_sampling_and_knn(dras_bags, tmp_path):
    """train --sampling, eval --use_sampling (host loop, --device_sampling,
    textural over a texture store) and knn (mean, max, hipt_lgp with and
    without --lgp_ckpt) through both CLIs on one folder of h5 bags with
    coords. train writes the JAX CLI's files and columns; eval of one head
    (JAX init, as .msgpack for the JAX CLI and .pt for the port) gives the
    JAX CLI's fold probabilities within 1e-5 and the same patch counts on
    the host loop, finite probabilities on the device loop; knn prints the
    JAX CLI's numbers within 1e-6."""
    import jax
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu.engine.checkpoint import save_params
    from hipt_abmil_atec23_tpu.models import build_mil_model as jbuild
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        hipt_lgp_state_dict_from_jax, mil_state_dict_from_jax)
    from hipt_abmil_atec23_tpu_torch.models.hipt_mil import (
        init_hipt_lgp_params)
    csv_path = str(dras_bags / "feats" / "labels.csv")
    feats = str(dras_bags / "feats")
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    train = ["train", "--csv_path", csv_path, "--feat_dir", feats, "--k",
             "3", "--k_end", "1", "--max_epochs", "2", "--min_epochs", "1",
             "--no_early_stopping", "--sampling", "--no_sampling_epochs",
             "1", *DRAS]
    _run_both(train + ["--results_dir", out["jax"] + "/results"],
              train + ["--results_dir", out["port"] + "/results"])
    assert os.path.exists(out["port"] + "/results/s_0_checkpoint.pt")
    for n in ("summary_partial_0_1.csv", "fold_0.csv"):
        p = pd.read_csv(f"{out['port']}/results/{n}")
        assert list(p.columns) == \
            list(pd.read_csv(f"{out['jax']}/results/{n}").columns)
    assert np.isfinite(p[["p_0", "p_1"]].values).all()

    jm = jbuild("clam_sb", size_arg="hipt_smaller", n_classes=2)
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((8, 192)), None)
    save_params(out["jax"] + "/head/s_0_checkpoint.msgpack", params)
    os.makedirs(out["port"] + "/head")
    torch.save(mil_state_dict_from_jax(params),
               out["port"] + "/head/s_0_checkpoint.pt")
    ev = ["eval", "--use_sampling", "--csv_path", csv_path, "--feat_dir",
          feats, "--splits", "all", "--folds", "0", *DRAS]
    for what, extra in (("spatial", []),
                        ("textural", ["--sampling_type", "textural",
                                      "--texture_model", "levit_128s",
                                      "--texture_feat_dir",
                                      str(dras_bags / "tex")])):
        _run_both(ev + extra + ["--models_dir", out["jax"] + "/head",
                                "--save_dir", f"{out['jax']}/{what}"],
                  ev + extra + ["--models_dir", out["port"] + "/head",
                                "--save_dir", f"{out['port']}/{what}"])
        p, j = (pd.read_csv(f"{out[k]}/{what}/fold_0.csv")
                for k in ("port", "jax"))
        assert list(p.columns) == list(j.columns)
        assert list(p["slide_id"]) == list(j["slide_id"])
        np.testing.assert_allclose(p[["p_0", "p_1"]].values,
                                   j[["p_0", "p_1"]].values, atol=1e-5)
        ps, js = (pd.read_csv(f"{out[k]}/{what}/summary.csv")
                  for k in ("port", "jax"))
        assert list(ps.columns) == list(js.columns)
        assert ps["mean_patches_used"][0] == js["mean_patches_used"][0]
    assert cli.main(ev + ["--device_sampling", "--models_dir",
                          out["port"] + "/head", "--save_dir",
                          out["port"] + "/device", "--device", "cpu"]) == 0
    p = pd.read_csv(out["port"] + "/device/fold_0.csv")
    assert len(p) == 12
    np.testing.assert_allclose(p[["p_0", "p_1"]].values.sum(1), 1, atol=1e-5)
    with pytest.raises(SystemExit, match="texture_feat_dir"):
        cli.main(ev + ["--sampling_type", "textural", "--texture_model",
                       "levit_128s", "--models_dir", out["port"] + "/head",
                       "--save_dir", str(tmp_path / "x"), "--device", "cpu"])

    # a HIPT_LGP_FC checkpoint: xavier-scale global branch (other weights
    # than the checkpoint-free default's) beside a local-branch key; an
    # N(0, 0.1) one makes near-tied embeddings whose neighbour order f32
    # rounding decides (tests/test_torch_knn_probe.py, ROADMAP §C)
    lgp = str(tmp_path / "lgp.pt")
    sd = hipt_lgp_state_dict_from_jax(
        init_hipt_lgp_params(np.random.default_rng(1)))
    sd["local_phi.0.weight"] = torch.zeros(192, 384)
    torch.save(sd, lgp)
    for agg in (["mean"], ["max"], ["hipt_lgp"], ["hipt_lgp", "--lgp_ckpt",
                                                    lgp]):
        knn = ["knn", "--csv_path", csv_path, "--feat_dir", feats, "--k",
               "5", "--folds", "3", "--agg", *agg]
        res = []
        for main, extra in ((jcli.main, []), (cli.main, ["--device",
                                                         "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(knn + extra) == 0
            res.append(json.loads(buf.getvalue()))
        assert res[0].keys() == res[1].keys()
        for key in res[0]:
            assert abs(res[0][key] - res[1][key]) <= 1e-6, (agg, res)


def test_cli_eval_sampling_encodes_the_sampled_patches(tiny, tmp_path):
    """eval --use_sampling --eval_features: only the patches DRAS samples
    are read from the slide and encoded (ResNet-18, f32 on the CPU) for a
    reference-layout .pt CLAM_SB head at ResNet-18 width."""
    d, src = tiny
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    n = len(load_coords_h5(str(d / "tiles" / "patches" / "t.h5"))[0])
    csv_path = str(tmp_path / "labels.csv")
    pd.DataFrame({"case_id": ["c0"], "slide_id": ["t"], "label": [1]}
                 ).to_csv(csv_path, index=False)
    heads = tmp_path / "heads"
    heads.mkdir()
    torch.save(build_mil_model("clam_sb", size_arg="tinier2_resnet18")
               .state_dict(), heads / "s_0_checkpoint.pt")
    assert n >= 6
    assert cli.main([
        "eval", "--use_sampling", "--eval_features", "--csv_path", csv_path,
        "--feat_dir", str(tmp_path / "none"), "--models_dir", str(heads),
        "--save_dir", str(tmp_path / "o"), "--splits", "all", "--folds", "0",
        "--model_size", "tinier2_resnet18", "--eval_encoder", "resnet18",
        "--data_slide_dir", str(src), "--data_h5_dir", str(d / "tiles"),
        "--samples_per_iteration", "1", "--resampling_iterations", "2",
        "--sampling_neighbors", "3", "--final_sample_size", "2",
        "--device", "cpu"]) == 0
    row = pd.read_csv(tmp_path / "o" / "fold_0.csv").iloc[0]
    assert row["slide_id"] == "t" and abs(row["p_0"] + row["p_1"] - 1) < 1e-5
    used = pd.read_csv(tmp_path / "o" / "summary.csv")["mean_patches_used"][0]
    assert used == 4 < n
