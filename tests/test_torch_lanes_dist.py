"""The port's stacked lanes split over a DeviceMesh's ``fold`` axis: 2 gloo
ranks on the CPU against one process.

Each rank runs ``run_trials_parallel`` (4 lanes, one of them padding, ASHA
at grace 1: 2 lanes per rank), ``train_folds_parallel`` (k = 4 with early
stopping: 2 folds per rank) and ``run_tuning_hetero`` (2 buckets of 3
trials, each padded to 4) with the mesh; the test process runs the same
without one. Every rank's results equal the single process's: validation
losses within 1e-5, the same ASHA kills, stops and best trial, fold
summaries within 1e-6. The ranks are spawned processes that import no jax.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TOL = 1e-5
CFG = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
       "bags": {"max_patches_per_slide": 32},
       "model": {"model_type": "clam_sb", "model_size": "hipt_smaller",
                 "no_inst_cluster": False, "k_sample": 4},
       "train": {"max_epochs": 4, "min_epochs": 1, "patience": 1,
                 "stop_epoch": 1, "k": 4, "seed": 0,
                 "weighted_sample": True}}


def _run_all(bag_dir, mesh):
    """The three stacked runs on the bags in ``bag_dir``."""
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.engine import tune
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.engine.tune_parallel import (
        run_trials_parallel, run_tuning_hetero)
    from hipt_abmil_atec23_tpu_torch.parallel.fold_parallel import (
        train_folds_parallel)
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    cfg = ExperimentConfig.from_dict(CFG)
    manifest = SlideManifest.from_csv(os.path.join(bag_dir, "labels.csv"),
                                      cfg.task.label_dict)
    store = FeatureBagStore(bag_dir)
    counts = manifest.class_counts()
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, early_stopping=False))
    trials = run_trials_parallel(
        tcfg, make_fold_datasets(manifest, store, tcfg, 0), counts,
        np.array([1e-3, 4e-3, 2e-2, 2e-2], np.float32),
        np.array([1e-5, 1e-3, 1e-4, 1e-4], np.float32), max_epochs=3,
        asha=tune.ASHAScheduler(max_t=3, grace_period=1), n_real=3,
        mesh=mesh, verbose=False, device="cpu")
    folds = train_folds_parallel(
        cfg, [make_fold_datasets(manifest, store, cfg, f) for f in range(4)],
        counts, mesh, verbose=False, device="cpu")
    space = {"lr": tune.LogUniform(1e-4, 1e-2),
             "reg": tune.LogUniform(1e-5, 1e-2),
             "model_size": tune.GridSearch(["hipt_smaller", "hipt_small"])}
    best, rows = run_tuning_hetero(
        tcfg, manifest, store, counts, space=space, num_samples=3,
        max_epochs=2, grace_period=1, seed=2, mesh=mesh, verbose=False,
        device="cpu")
    return {"trials": trials, "folds": (folds.summary, folds.histories),
            "hetero": (best, rows)}


def _worker(rank, world, store_path, bag_dir, out_dir):
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = _run_all(bag_dir, make_mesh([("fold", world)], "cpu"))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's results, each of 2 ranks' results)."""
    from hipt_abmil_atec23_tpu_torch.data.synthetic import make_synthetic_bags
    tmp = tmp_path_factory.mktemp("lanes")
    bag_dir = str(tmp / "bags")
    make_synthetic_bags(bag_dir, n_slides=20, feat_dim=192,
                        bag_range=(40, 90), signal=1.5, signal_fraction=0.4,
                        seed=4)
    mp.spawn(_worker, args=(2, str(tmp / "store"), bag_dir, str(tmp)),
             nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return _run_all(bag_dir, None), ranks


@pytest.mark.parametrize("rank", [0, 1])
def test_trial_lanes_over_two_ranks(runs, rank):
    want, got = runs[0]["trials"], runs[1][rank]["trials"]
    assert np.array_equal(np.isnan(got.val_loss), np.isnan(want.val_loss))
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.stopped_epoch, want.stopped_epoch)
    assert got.best_trial == want.best_trial


@pytest.mark.parametrize("rank", [0, 1])
def test_fold_lanes_over_two_ranks(runs, rank):
    (want_sum, want_hist), (got_sum, got_hist) = \
        runs[0]["folds"], runs[1][rank]["folds"]
    assert [len(h) for h in got_hist] == [len(h) for h in want_hist]
    for g, w in zip(got_hist, want_hist):
        for a, b in zip(g, w):
            for k in ("val_loss", "train_loss"):
                assert abs(a[k] - b[k]) <= TOL, (k, a, b)
    for k in want_sum:
        np.testing.assert_allclose(got_sum[k], want_sum[k], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_hetero_buckets_over_two_ranks(runs, rank):
    (want_best, want_rows), (got_best, got_rows) = \
        runs[0]["hetero"], runs[1][rank]["hetero"]
    assert got_best == want_best and len(got_rows) == len(want_rows) == 6
    for g, w in zip(got_rows, want_rows):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= TOL, (k, g, w)
            else:
                assert g[k] == w[k]
