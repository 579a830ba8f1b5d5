"""The port's eval stage (hipt_abmil_atec23_tpu_torch/engine/evaluate.py,
engine/metrics.py, data/splits.py, engine/experiment.py) held against the
JAX package's on the CPU.

- ``evaluate_fold`` on a port-written ``s_0_checkpoint.pt`` against the
  JAX package's ``evaluate_fold`` reading the same file through its torch
  fallback: the subsampled route (both draw the same bags) and the
  full-bag route (the port's pool, B.2's plain version here, against the
  JAX package's padded forward), probabilities and loss within 1e-5.
- The bootstrap chunk on one shared index matrix against the JAX
  package's ``_bootstrap_chunk``, within 1e-6; the CIs of
  ``bootstrap_from_fold_csvs`` (different resample streams) within 0.01.
- Split and fold CSVs byte for byte equal to the JAX package's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.data import bags as jbags
from hipt_abmil_atec23_tpu.data import splits as jsplits
from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
from hipt_abmil_atec23_tpu.engine import evaluate as jeval
from hipt_abmil_atec23_tpu.engine import experiment as jexp
from hipt_abmil_atec23_tpu.engine import metrics as jmetrics
from hipt_abmil_atec23_tpu.engine.train import FoldResult as JaxFoldResult
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.data import bags as pbags
from hipt_abmil_atec23_tpu_torch.data import splits as psplits
from hipt_abmil_atec23_tpu_torch.engine import evaluate as peval
from hipt_abmil_atec23_tpu_torch.engine import experiment as pexp
from hipt_abmil_atec23_tpu_torch.engine import metrics as pmetrics
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import ckpt_path, save_params
from hipt_abmil_atec23_tpu_torch.engine.train import build_step_fns
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg

TOL = 1e-5


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_bags(str(tmp_path_factory.mktemp("synth")),
                               n_slides=10, feat_dim=192,
                               bag_range=(40, 400), seed=4)


@pytest.mark.parametrize("max_patches", [32, None],
                         ids=["subsampled", "full-bag"])
def test_evaluate_fold_matches_jax(synth, tmp_path, max_patches):
    """A head saved by the port, evaluated by both packages: the port
    routes full bags of a gated clam_sb through apply_pooled (the pool's
    plain version on the CPU); the JAX package pads them below its TPU
    size band and runs the head."""
    manifest, jstore = synth
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": max_patches},
         "model": {"model_type": "clam_sb", "model_size": "hipt_smaller"},
         "train": {"seed": 2}}
    jc, pc = jcfg.ExperimentConfig.from_dict(d), \
        pcfg.ExperimentConfig.from_dict(d)
    ids, labels = list(manifest.slide_ids), manifest.labels
    counts = manifest.class_counts()
    model = build_step_fns(pc, counts, 8, 192, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    save_params(ckpt_path(str(tmp_path), 0), model)
    pds = pbags.BagDataset(ids, labels, pbags.FeatureBagStore(jstore.feat_dir),
                           pc.bags)
    jds = jbags.BagDataset(ids, labels, jstore, jc.bags)
    calls = []
    real = gap.gated_attention_pool
    gap.gated_attention_pool = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = peval.evaluate_fold(pc, 0, pds, counts, str(tmp_path),
                                  device="cpu")
    finally:
        gap.gated_attention_pool = real
    want = jeval.evaluate_fold(jc, 0, jds, counts, str(tmp_path))
    assert len(calls) == (len(ids) if max_patches is None else 0)
    np.testing.assert_allclose(got.test_probs, want.test_probs, rtol=TOL,
                               atol=TOL)
    assert abs(got.test_loss - want.test_loss) <= TOL
    assert abs(got.test_auc - want.test_auc) <= 1e-6


def test_evaluate_fold_refuses_a_flax_checkpoint(synth, tmp_path):
    manifest, jstore = synth
    pc = pcfg.ExperimentConfig()
    open(tmp_path / "s_0_checkpoint.msgpack", "wb").close()
    ds = pbags.BagDataset(list(manifest.slide_ids), manifest.labels,
                          pbags.FeatureBagStore(jstore.feat_dir), pc.bags)
    with pytest.raises(NotImplementedError, match="ROADMAP §A.7"):
        peval.evaluate_fold(pc, 0, ds, manifest.class_counts(),
                            str(tmp_path), device="cpu")


@pytest.mark.parametrize("n_classes", [2, 3])
def test_bootstrap_chunk_matches_jax(n_classes):
    """One [b, n] index matrix through both chunk functions: AUC (scores
    with ties, so the tie groups count), F1, accuracy and balanced
    accuracy per resample within 1e-6 (NaN where a resample lacks a
    class, in both)."""
    rng = np.random.default_rng(n_classes)
    n = 23
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    probs = rng.dirichlet(np.ones(n_classes), n).astype(np.float32)
    probs[5] = probs[3]
    probs[9] = probs[3]
    probs = np.round(probs, 2)
    preds = probs.argmax(1).astype(np.int32)
    idx = rng.integers(0, n, (400, n))
    idx[0] = np.where(labels == labels[0])[0][0]   # one class only
    want = jmetrics._bootstrap_chunk(jnp.asarray(labels), jnp.asarray(probs),
                                     jnp.asarray(preds), jnp.asarray(idx),
                                     n_classes)
    got = pmetrics.bootstrap_chunk(torch.from_numpy(labels).long(),
                                   torch.from_numpy(probs),
                                   torch.from_numpy(preds).long(),
                                   torch.from_numpy(idx), n_classes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _fold_result(mod, fold, rng, n=30, n_classes=2):
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    logits = rng.normal(size=(n, n_classes)) + 1.5 * np.eye(n_classes)[labels]
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    return mod(fold=fold, val_auc=np.nan, test_auc=np.nan, val_acc=np.nan,
               test_acc=np.nan, val_loss=np.nan, test_loss=np.nan,
               stopped_epoch=0, test_probs=probs, test_labels=labels,
               test_slide_ids=[f"f{fold}_s{i}" for i in range(n)])


def test_fold_csvs_and_bootstrap_match_jax(tmp_path):
    """_write_fold_csv writes the JAX package's bytes (pandas' layout);
    bootstrap_from_fold_csvs over two folds gives the JAX package's
    confusion matrix, slide count and mean CE exactly and its bootstrap
    means and stds within 0.01 (torch draws other resamples)."""
    from hipt_abmil_atec23_tpu_torch.engine.train import FoldResult
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
    for fold in (0, 1):
        jexp._write_fold_csv(str(tmp_path / "jax"), _fold_result(
            JaxFoldResult, fold, np.random.default_rng(fold)))
        pexp._write_fold_csv(str(tmp_path / "port"), _fold_result(
            FoldResult, fold, np.random.default_rng(fold)))
        assert (tmp_path / "port" / f"fold_{fold}.csv").read_bytes() == \
            (tmp_path / "jax" / f"fold_{fold}.csv").read_bytes()
    want = jeval.bootstrap_from_fold_csvs([str(tmp_path / "jax")], [0, 1],
                                          n_bootstraps=20_000)
    got = peval.bootstrap_from_fold_csvs([str(tmp_path / "port")], [0, 1],
                                         n_bootstraps=20_000, device="cpu")
    for k in ("confusion_matrix", "n_slides"):
        assert got[k] == want[k]
    assert abs(got["mean_ce_loss"] - want["mean_ce_loss"]) <= 1e-6
    for metric in ("auc", "f1", "acc", "balanced_acc"):
        for stat in ("mean", "std"):
            assert abs(got[metric][stat] - want[metric][stat]) <= 0.01
    labels, probs = peval.read_fold_csvs([str(tmp_path / "port")], [0, 1])
    fpr, tpr = peval.roc_curve_points(labels, probs[:, 1])
    assert fpr[0] == tpr[0] == 0 and fpr[-1] == tpr[-1] == 1


@pytest.mark.parametrize("n_classes,k,seed", [(2, 5, 1), (3, 4, 7),
                                              (2, 2, 3)])
def test_splits_match_jax(tmp_path, n_classes, k, seed):
    """generate_kfold_splits (numpy alone) draws scikit-learn's folds, and
    the split, boolean and descriptor CSVs are the JAX package's bytes;
    load_split_csv reads them back."""
    labels = np.random.default_rng(seed).integers(0, n_classes, 37)
    ids = [f"slide_{i}" for i in range(37)]
    want = jsplits.generate_kfold_splits(labels, k, seed=seed)
    got = psplits.generate_kfold_splits(labels, k, seed=seed)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
        psplits.check_split_disjoint(g)
    for name, pw, jw, args in (
            ("s", psplits.save_split_csv, jsplits.save_split_csv, (ids,)),
            ("b", psplits.save_split_bool_csv, jsplits.save_split_bool_csv,
             (ids,)),
            ("d", psplits.save_split_descriptor,
             jsplits.save_split_descriptor, (labels,))):
        extra = (n_classes,) if name == "d" else ()
        pw(str(tmp_path / f"{name}_port.csv"), *args, got[0], *extra)
        jw(str(tmp_path / f"{name}_jax.csv"), *args, want[0], *extra)
        assert (tmp_path / f"{name}_port.csv").read_bytes() == \
            (tmp_path / f"{name}_jax.csv").read_bytes()
    assert psplits.load_split_csv(str(tmp_path / "s_jax.csv")) == \
        jsplits.load_split_csv(str(tmp_path / "s_jax.csv"))
    with pytest.raises(ValueError, match="overlap"):
        psplits.check_split_disjoint((np.array([1]), np.array([1]),
                                      np.array([2])))
