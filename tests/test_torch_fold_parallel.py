"""The port's fold-parallel training (parallel/fold_parallel.py) held
against the JAX package's and against the port's own sequential
``train_fold`` on the CPU: k = 3 folds of CLAM_SB hipt_smaller with the
instance loss, dropout 0, early stopping at min_epochs 1 / patience 1 so
that a fold stops before the others.

- From the JAX package's initial heads (the port's fold init patched to
  load them): per-fold histories within 1e-5, the same stopped pattern,
  summary AUC and accuracy within 1e-6.
- From the port's own init: each fold's history within 1e-5 of
  ``train_fold`` on that fold, the same stop, its best head computing what
  the checkpoint ``train_fold`` kept computes (logits, probabilities,
  instance loss within 1e-5), and the summary of every fold that ran to the last
  epoch equal to train_fold's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.parallel import fold_parallel as jfp
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.parallel import fold_parallel as pfp
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg

TOL = 1e-5
D = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
     "bags": {"max_patches_per_slide": 32},
     "model": {"model_type": "clam_sb", "model_size": "hipt_smaller",
               "no_inst_cluster": False, "k_sample": 4},
     "train": {"max_epochs": 6, "min_epochs": 1, "patience": 1,
               "stop_epoch": 1, "k": 3, "seed": 0, "weighted_sample": True}}


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """30 bags: every fold's train, val and test split holds 10."""
    from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
    return make_synthetic_bags(str(tmp_path_factory.mktemp("fp")),
                               n_slides=30, feat_dim=192, bag_range=(40, 90),
                               signal=1.5, signal_fraction=0.4, seed=1)


def _port_folds(manifest, store, cfg):
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    pman = SlideManifest(manifest.df, manifest.label_dict, manifest.n_classes)
    pstore = FeatureBagStore(store.feat_dir)
    return [make_fold_datasets(pman, pstore, cfg, f)
            for f in range(cfg.train.k)]


def _jax_fold_heads(fns, seed, folds):
    """The port's fold init replaced by the JAX package's (JAX
    fold_parallel.py:67-70: flax init from jax_key(seed, fold))."""
    from hipt_abmil_atec23_tpu.engine.train import build_step_fns
    from hipt_abmil_atec23_tpu.utils.seeding import jax_key
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax)
    jfns = build_step_fns(jcfg.ExperimentConfig.from_dict(D),
                          np.array([15, 15]), 8, 192)
    heads = []
    for f in folds:
        head = fns.init_params()
        head.load_state_dict(mil_state_dict_from_jax(
            jfns.init_params(jax_key(seed, f))))
        heads.append(head)
    return heads


def test_train_folds_parallel_matches_jax(bags, monkeypatch):
    from hipt_abmil_atec23_tpu.engine.experiment import make_fold_datasets
    monkeypatch.setattr(pfp, "_fold_heads", _jax_fold_heads)
    manifest, store = bags
    jc, pc = jcfg.ExperimentConfig.from_dict(D), \
        pcfg.ExperimentConfig.from_dict(D)
    counts = manifest.class_counts()
    want = jfp.train_folds_parallel(
        jc, [make_fold_datasets(manifest, store, jc, f) for f in range(3)],
        counts, None, verbose=False)
    got = pfp.train_folds_parallel(pc, _port_folds(manifest, store, pc),
                                   counts, None, verbose=False, device="cpu")
    lengths = [len(h) for h in got.histories]
    assert lengths == [len(h) for h in want.histories]
    assert len(set(lengths)) > 1          # one fold stopped before another
    for g, w in zip(got.histories, want.histories):
        for a, b in zip(g, w):
            assert a["epoch"] == b["epoch"]
            for k in ("val_loss", "train_loss"):
                assert abs(a[k] - b[k]) <= TOL, (k, a, b)
    for k in ("val_auc", "test_auc", "val_acc", "test_acc"):
        np.testing.assert_allclose(got.summary[k], want.summary[k], rtol=0,
                                   atol=1e-6)


def test_each_fold_matches_train_fold(bags, tmp_path):
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import ckpt_path
    from hipt_abmil_atec23_tpu_torch.engine.train import train_fold
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    manifest, store = bags
    pc = pcfg.ExperimentConfig.from_dict(D)
    counts = manifest.class_counts()
    folds = _port_folds(manifest, store, pc)
    got = pfp.train_folds_parallel(pc, folds, counts, None, verbose=False,
                                   device="cpu")
    last = max(len(h) for h in got.histories)
    for f in range(3):
        cfg = dataclasses.replace(pc, results_dir=str(tmp_path / str(f)))
        res = train_fold(cfg, f, *_port_folds(manifest, store, cfg)[f],
                         counts, verbose=False, device="cpu")
        assert len(res.history) == len(got.histories[f])
        for a, b in zip(res.history, got.histories[f]):
            for k in ("val_loss", "train_loss"):
                assert abs(a[k] - b[k]) <= TOL, (f, k, a, b)
        # the kept heads compute the same function: the scorer's bias has
        # a zero gradient (the softmax ignores a shift), so Adam's step on
        # its rounding noise moves it by ~lr in either run; compare outputs
        heads = []
        for sd in (got.best_params[f], torch.load(
                ckpt_path(cfg.results_dir, f), weights_only=True)):
            head = build_mil_model("clam_sb", size_arg="hipt_smaller",
                                   k_sample=4)
            head.load_state_dict(sd)
            heads.append(head)
        b = folds[f][2].make_batch(list(range(10)), np.random.default_rng(0),
                                   n_pad=96, train=False)
        x, m = torch.from_numpy(b.features), torch.from_numpy(b.mask)
        y = torch.from_numpy(b.labels).long()
        with torch.no_grad():
            outs = [h(x, m, label=y, instance_eval=True) for h in heads]
        for k in ("logits", "y_prob"):
            torch.testing.assert_close(getattr(outs[0], k),
                                       getattr(outs[1], k), rtol=0, atol=TOL)
        torch.testing.assert_close(outs[0].extras["instance_loss"],
                                   outs[1].extras["instance_loss"], rtol=0,
                                   atol=TOL)
        if len(res.history) == last:
            # the same host stream up to the final evaluation
            assert abs(got.summary["val_auc"][f] - res.val_auc) <= 1e-6
            assert abs(got.summary["test_auc"][f] - res.test_auc) <= 1e-6
