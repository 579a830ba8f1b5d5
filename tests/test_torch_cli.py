"""The port's CLI (hipt_abmil_atec23_tpu_torch/cli.py) end to end on the CPU,
held against the JAX package's CLI on the same inputs: ``tile`` (the same
coords h5s and process list), ``encode --model_type vit256`` with one
DINO-layout checkpoint passed to both (bags within 1e-4, f32 on both
sides, each package's store reading the other's), ``serve --once`` on a
reference-layout .pt CLAM head (its serve_config.json equal to the JAX
package's write_config output for the same flags), and ``splits -> train
-> eval -> bootstrap`` and ``count`` on synthetic feature bags (the same
file names and columns; the JAX CLI's eval reads the port's checkpoints).
Every refusal names the ROADMAP item that ports what is refused."""
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


@pytest.mark.parametrize("argv,error,match", [
    (["serve", "--ckpt", "head.ckpt"], NotImplementedError, "ROADMAP §A.7"),
    (["serve", "--model_type", "transmil"], ValueError,
     "unknown model_type 'transmil'"),
    (["serve", "--model_type", "clam_mb"], None, None),
    (["train", "--tuning"], NotImplementedError, "ROADMAP §A.10"),
    (["train", "--trial_parallel"], NotImplementedError, "ROADMAP §A.10"),
    (["train", "--fold_parallel"], NotImplementedError, "ROADMAP §A.10"),
    (["train", "--sampling"], NotImplementedError, "ROADMAP §A.9"),
    (["eval", "--use_sampling"], NotImplementedError, "ROADMAP §A.9")])
def test_cli_refuses_what_is_not_ported(argv, error, match, tmp_path, work):
    """Checkpoint formats and train / eval routes the port does not have
    yet raise before any work, naming the ROADMAP item that ports them
    (every encoder runs: test_cli_runs_the_other_encoders); a head type
    that does not exist is refused before the first drain
    with build_mil_model's ValueError (a daemon would log a failed drain
    and poll again). A clam_mb head is served now (``error`` None): a
    slide scored through HIPT_4K (f32, 512 px regions) from a
    reference-layout .pt of that head."""
    if error is None:
        inbox = tmp_path / "inbox"
        inbox.mkdir()
        os.link(work[1] / "b.tif", inbox / "b.tif")
        ckpt = str(tmp_path / "head.pt")
        torch.save(build_mil_model(argv[2], size_arg="hipt_smaller")
                   .state_dict(), ckpt)
        assert cli.main(argv + [
            "--slide_dir", str(inbox), "--out_dir", str(tmp_path / "o"),
            "--ckpt", ckpt, "--patch_size", "512", "--use_otsu", "--a_t",
            "1", "--float32", "--once", "--min_stable_s", "0",
            "--device", "cpu"]) == 0
        rec = json.load(open(tmp_path / "o" / "results" / "b.json"))
        assert rec["status"] == "done" and abs(sum(rec["p"]) - 1) < 1e-5
        return
    base = {"encode": ["--data_h5_dir", str(tmp_path), "--data_slide_dir",
                       str(tmp_path), "--feat_dir", str(tmp_path / "f")],
            "serve": ["--slide_dir", str(tmp_path), "--out_dir",
                      str(tmp_path / "o")],
            "train": ["--csv_path", "x.csv", "--feat_dir", str(tmp_path),
                      "--results_dir", str(tmp_path / "o")],
            "eval": ["--csv_path", "x.csv", "--feat_dir", str(tmp_path),
                     "--models_dir", str(tmp_path), "--save_dir",
                     str(tmp_path / "o")]}[argv[0]]
    if argv[0] == "serve" and "--ckpt" not in argv:
        base += ["--ckpt", "head.pt"]
    with pytest.raises(error, match=match):
        cli.main(argv + base + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "o")


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
