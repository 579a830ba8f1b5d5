"""The port's CLI routes for tuning, fold-parallel training and the parity
recipe, run end to end on the CPU on tiny data (what the JAX CLI's
``train --tuning [--trial_parallel]``, ``train --fold_parallel``,
``eval --use_sampling --tune_sampling`` and ``parity`` do).

- ``train --tuning`` (also under ``--sampling``, which it precedes, as in
  the JAX CLI): the JAX package's sampled trials in tuning_results.csv with
  its columns, per-trial checkpoints; ``--resume_tuning`` keeps the rows
  written and adds the rest. ``--trial_parallel``: the JAX CLI's lr / reg
  draws and columns.
- ``train --fold_parallel``: summary.csv with the JAX CLI's columns.
- ``eval --use_sampling --tune_sampling`` from the JAX package's own
  ``.msgpack`` head: the JAX CLI's sampling_tuning.csv (AUC within 1e-6,
  equal mean_patches) and fold probabilities within 1e-5.
- ``parity``: the JAX CLI's stage command lines (``main`` patched in both
  packages), then the whole recipe on 9 synthetic slides with DINO-layout
  checkpoints of seeded weights.
"""
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hipt_abmil_atec23_tpu import cli as jcli
from hipt_abmil_atec23_tpu.engine import tune as jtune
from hipt_abmil_atec23_tpu_torch import cli


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """24 synthetic 192-d npy bags and their labels.csv."""
    from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
    d = tmp_path_factory.mktemp("route_bags")
    make_synthetic_bags(str(d), n_slides=24, feat_dim=192,
                        bag_range=(30, 80), signal=1.5, signal_fraction=0.4,
                        seed=1)
    return d


def _train(bags, results, *flags):
    return ["train", "--csv_path", str(bags / "labels.csv"), "--feat_dir",
            str(bags), "--results_dir", str(results), "--k", "3",
            "--max_epochs", "2", "--min_epochs", "1",
            "--max_patches_per_slide", "32", "--seed", "0", *flags,
            "--device", "cpu"]


@pytest.mark.parametrize("first", [[], ["--sampling"]],
                         ids=["tuning", "sampling+tuning"])
def test_cli_train_tuning(bags, tmp_path, first):
    out = tmp_path / "r"
    tune = ["--tuning", "--num_tuning_samples", "2", "--grace_period", "1",
            "--checkpoint_trials"]
    assert cli.main(_train(bags, out, *first, *tune)) == 0
    df = pd.read_csv(out / "tuning_results.csv", float_precision="round_trip")
    configs = jtune.sample_configs(jtune.DEFAULT_SEARCH_SPACE, 2, 0)
    assert list(df.columns) == list(configs[0]) + [
        "epochs", "best_val_loss", "last10_val_loss", "final_val_auc"]
    for row, c in zip(df.to_dict("records"), configs):
        assert {k: row[k] for k in c} == c
    for t in range(2):
        assert os.listdir(out / f"trial_{t}" / "ckpts")
    assert not (out / "fold_0.csv").exists()   # no sampling training ran
    assert cli.main(_train(bags, out, *tune[:1], "--num_tuning_samples", "3",
                           "--resume_tuning")) == 0
    again = pd.read_csv(out / "tuning_results.csv",
                        float_precision="round_trip")
    assert len(again) == 3
    pd.testing.assert_frame_equal(again.iloc[:2], df)


def test_cli_train_tuning_trial_parallel(bags, tmp_path):
    out = tmp_path / "r"
    assert cli.main(_train(bags, out, "--tuning", "--trial_parallel",
                           "--num_tuning_samples", "3")) == 0
    df = pd.read_csv(out / "tuning_results.csv")
    assert list(df.columns) == ["lr", "reg", "last10_val_loss"]
    trials = jtune.sample_configs({"lr": jtune.LogUniform(1e-5, 1e-2),
                                   "reg": jtune.LogUniform(1e-5, 1e-1)}, 3, 0)
    for k in ("lr", "reg"):
        np.testing.assert_array_equal(
            df[k].values.astype(np.float32),
            np.array([t[k] for t in trials], np.float32))
    assert np.isfinite(df["last10_val_loss"]).all()


def test_cli_train_fold_parallel(bags, tmp_path):
    out = tmp_path / "r"
    assert cli.main(_train(bags, out, "--fold_parallel")) == 0
    df = pd.read_csv(out / "summary.csv")
    assert list(df.columns) == ["folds", "val_auc", "test_auc", "val_acc",
                                "test_acc"]
    assert list(df["folds"]) == [0, 1, 2]
    assert ((df[["val_acc", "test_acc"]] >= 0) &
            (df[["val_acc", "test_acc"]] <= 1)).all().all()


def test_cli_eval_tune_sampling(tmp_path):
    """Twelve h5 bags with grid coords and one head the JAX package
    saved as s_0_checkpoint.msgpack: eval --use_sampling --tune_sampling
    through both CLIs (the port reads the .msgpack itself)."""
    import jax
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu.engine.checkpoint import save_params
    from hipt_abmil_atec23_tpu.models import build_mil_model as jbuild
    from hipt_abmil_atec23_tpu_torch.data.synthetic import make_synthetic_bags
    manifest, store = make_synthetic_bags(str(tmp_path / "feats"),
                                          n_slides=12, feat_dim=192,
                                          bag_range=(200, 202), signal=1.5,
                                          signal_fraction=0.4, seed=2)
    grid = np.stack(np.meshgrid(np.arange(20), np.arange(13)), -1
                    ).reshape(-1, 2) * 256
    for sid in manifest.slide_ids:
        f = store.load_features(sid)
        os.remove(store.npy_path(sid))
        store.save(sid, f, coords=grid[:len(f)], formats=("h5",))
    jm = jbuild("clam_sb", size_arg="hipt_smaller", n_classes=2)
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((8, 192)), None)
    save_params(str(tmp_path / "head" / "s_0_checkpoint.msgpack"), params)
    ev = ["eval", "--use_sampling", "--tune_sampling",
          "--num_tuning_samples", "2", "--csv_path",
          str(tmp_path / "feats" / "labels.csv"), "--feat_dir",
          str(tmp_path / "feats"), "--models_dir", str(tmp_path / "head"),
          "--splits", "all", "--folds", "0", "--k", "3",
          "--samples_per_iteration", "16", "--resampling_iterations", "2",
          "--sampling_neighbors", "6", "--final_sample_size", "16"]
    assert jcli.main(ev + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert cli.main(ev + ["--save_dir", str(tmp_path / "port"),
                          "--device", "cpu"]) == 0
    p, j = (pd.read_csv(tmp_path / k / "sampling_tuning.csv")
            for k in ("port", "jax"))
    assert list(p.columns) == list(j.columns) and len(p) == 2
    np.testing.assert_allclose(p["auc"], j["auc"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p["mean_patches"], j["mean_patches"])
    np.testing.assert_array_equal(p.drop(columns=["auc", "mean_patches"]),
                                  j.drop(columns=["auc", "mean_patches"]))
    p, j = (pd.read_csv(tmp_path / k / "fold_0.csv") for k in ("port", "jax"))
    assert list(p["slide_id"]) == list(j["slide_id"])
    np.testing.assert_allclose(p[["p_0", "p_1"]].values,
                               j[["p_0", "p_1"]].values, atol=1e-5)


def _parity_args(tmp_path, slide_dir, csv_path, ckpts):
    return ["parity", "--slide_dir", str(slide_dir), "--csv_path", csv_path,
            "--vit256_ckpt", ckpts[0], "--vit4k_ckpt", ckpts[1],
            "--work_dir", str(tmp_path / "work"), "--slide_ext", ".tif",
            # k = 3: the smallest k whose val = next-fold splits leave a
            # train partition
            "--region_size", "512", "--k", "3", "--max_epochs", "2",
            "--min_epochs", "1", "--encode_batch_size", "2",
            "--bootstraps", "500", "--use_otsu", "--a_t", "1",
            "--extra_train_args=--no_early_stopping"]


def test_cli_parity_stages_match_jax(tmp_path, monkeypatch):
    """Both CLIs' parity with ``main`` patched to record each stage's argv
    (the last stage's nonzero code ends the recipe there): the port's
    stages are the JAX CLI's, each with --device appended."""
    args = _parity_args(tmp_path, tmp_path, "d.csv", ("a.pth", "b.pth"))
    seen = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("port", cli, ["--device", "cpu"])):
        real, seen[name] = mod.main, []

        def record(argv, _seen=seen[name]):
            _seen.append(list(argv))
            return 3 if argv[0] == "train" else 0
        monkeypatch.setattr(mod, "main", record)
        with pytest.raises(SystemExit) as stop:
            real(args + extra)
        assert stop.value.code == 3
    assert [s[0] for s in seen["jax"]] == ["tile", "encode", "splits",
                                           "train"]
    assert seen["port"] == [s + ["--device", "cpu"] for s in seen["jax"]]


def test_cli_parity_recipe_runs(tmp_path):
    """tile -> encode (HIPT_4K, bf16, from DINO-layout ViT-256 / ViT-4K
    checkpoints of seeded weights) -> splits -> train -> bootstrap on 9
    synthetic 1024^2 slides, 512 px regions, k = 3, on the CPU, at two
    threads (bf16 on a CPU under several test workers slows by far more
    than their count with a thread per core): every stage's artifact and
    parity_summary.json."""
    from hipt_abmil_atec23_tpu_torch.models.hipt import make_hipt_encoder
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        write_synthetic_slide)
    sd = make_hipt_encoder(torch.float32,
                           generator=torch.Generator().manual_seed(5)
                           ).state_dict()
    ckpts = []
    for part in ("vit256", "vit4k"):
        path = str(tmp_path / f"{part}_dino.pth")
        torch.save({"teacher": {f"module.backbone.{k[len(part) + 1:]}": v
                                for k, v in sd.items()
                                if k.startswith(part + ".")},
                    "student": {"junk": torch.zeros(1)}}, path)
        ckpts.append(path)
    slide_dir = tmp_path / "slides"
    slide_dir.mkdir()
    rows = ["slide_id,label"]
    for i in range(9):
        rng = np.random.default_rng(i)
        img = np.clip(np.array([199, 124, 180], np.int16)
                      + rng.integers(-25, 25, (1024, 1024, 3),
                                     dtype=np.int16), 0, 255).astype(np.uint8)
        write_synthetic_slide(str(slide_dir / f"s{i}.tif"), 1024, 1024,
                              n_levels=2, ycbcr420=True, image=img)
        rows.append(f"s{i},{'effective' if i % 2 else 'invalid'}")
    csv_path = str(tmp_path / "dataset.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert cli.main(_parity_args(tmp_path, slide_dir, csv_path, ckpts)
                        + ["--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    work = tmp_path / "work"
    assert (work / "tiles" / "patches" / "s0.h5").exists()
    assert (work / "splits" / "splits_2.csv").exists()
    assert (work / "results" / "fold_2.csv").exists()
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    f = FeatureBagStore(str(work / "feats")).load_features("s0")
    assert f.shape[1] == 192 and np.isfinite(f).all()
    summary = json.load(open(work / "parity_summary.json"))
    assert {"auc", "auc_std", "target_auc", "within_band"} <= set(summary)
    assert 0.0 <= summary["auc"] <= 1.0 and summary["target_auc"] == 0.6462
