"""The port's training engine (hipt_abmil_atec23_tpu_torch/engine/train.py,
data/bags.py) held against the JAX package's on the CPU.

- Batch assembly: ``get_bag`` (augmentation variants, subsampling with and
  without replacement, perturbation), ``make_batch``, ``_epoch_tensors``
  and ``_chunk_tensors`` are bit-equal to the JAX package's from the same
  numpy Generator, which is left in the same state.
- Lockstep steps: ``train_epoch`` + ``eval_batch`` from one set of weights
  on the same batches for 6 epochs. Tolerance 1e-5 (absolute) on the
  epoch's mean bag loss, instance loss and accuracy and on every eval
  probability, per-slide loss and instance loss; the largest gap measured
  when this was written was 2.9e-6. Adam's first steps move each weight by
  about lr * sign(g), so a gradient that rounds to zero differently in the
  two packages would show as a 2 lr gap in the weights; the outputs stay
  within the tolerance. (The JAX package also decays the instance
  classifiers of a head trained without the instance loss, whose gradient
  is zero; torch's Adam leaves parameters without a gradient alone. Those
  weights do not reach any output.)
- Whole fold: JAX's init carried into a ``.pt`` and a ``.msgpack``, both
  packages' ``train_fold`` with ``continue_training``, dropout off and one
  seed, early stopping on, ``epoch_chunk`` 1 and 3: the same stopped epoch,
  val / test AUC within 1e-6, per-epoch losses and test probabilities
  within 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.data import bags as jbags
from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
from hipt_abmil_atec23_tpu.engine import checkpoint as jckpt
from hipt_abmil_atec23_tpu.engine import train as jtrain
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.data import bags as pbags
from hipt_abmil_atec23_tpu_torch.engine import train as ptrain
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
    ckpt_path, load_train_state, save_train_state)
from hipt_abmil_atec23_tpu_torch.models.convert import mil_state_dict_from_jax
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg

TOL = 1e-5


def _cfgs(**over):
    """The same configuration in both packages' dataclasses."""
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": 24, "batch_size": 1},
         "model": {"model_type": "clam_sb", "model_size": "hipt_smaller",
                   "k_sample": 4, "no_inst_cluster": True},
         "train": {"lr": 1e-3, "reg": 1e-5, "bag_loss": "ce", "seed": 3}}
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v} if isinstance(v, dict) else v
    return jcfg.ExperimentConfig.from_dict(d), pcfg.ExperimentConfig.from_dict(d)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """Eight 16-d bags of 10-60 instances, two augmentation variants each
    (one longer than every original), as npy."""
    d = tmp_path_factory.mktemp("bags")
    rng = np.random.default_rng(0)
    store = jbags.FeatureBagStore(str(d))
    for i in range(8):
        store.save(f"s{i}", rng.normal(size=(rng.integers(10, 60), 16))
                   .astype(np.float32), formats=("npy",))
        for a in (1, 2):
            n = 70 if (i, a) == (3, 2) else int(rng.integers(10, 60))
            store.save(f"s{i}aug{a}", rng.normal(size=(n, 16)).astype(
                np.float32), formats=("npy",))
    return str(d)


@pytest.mark.parametrize("bag_cfg", [
    dict(max_patches_per_slide=24, number_of_augs=2, perturb_variance=0.1),
    dict(max_patches_per_slide=24, sampling_with_replacement=False),
    dict(max_patches_per_slide=None)], ids=["augs-perturb", "no-repl",
                                            "full"])
def test_batches_bit_equal_to_jax(store_dir, bag_cfg):
    """get_bag (train and eval draws), make_batch, pad_size,
    _epoch_tensors at B 1 and 3, and _chunk_tensors of 2 epochs, each from
    one seeded Generator per package: equal arrays, equal Generator state
    after."""
    jc, pc = _cfgs(bags=bag_cfg)
    ids = [f"s{i}" for i in range(8)]
    labels = np.arange(8) % 2
    jds = jbags.BagDataset(ids, labels, jbags.FeatureBagStore(store_dir),
                           jc.bags)
    pds = pbags.BagDataset(ids, labels, pbags.FeatureBagStore(store_dir),
                           pc.bags)
    assert pds.pad_size() == jds.pad_size()
    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(8):
        for train in (True, False):
            np.testing.assert_array_equal(pds.get_bag(i, pr, train=train),
                                          jds.get_bag(i, jr, train=train))
    for a, b in zip(dataclasses.astuple(pds.make_batch([3, 1, 6], pr)),
                    dataclasses.astuple(jds.make_batch([3, 1, 6], jr))):
        np.testing.assert_array_equal(a, b)
    n_pad = jds.pad_size()
    for ds in (jds, pds):
        ds._feat_dim = 16
    for bs in (1, 3):
        order = jbags.epoch_order(labels, 2, jr, True)
        np.testing.assert_array_equal(pbags.epoch_order(labels, 2, pr, True),
                                      order)
        for a, b in zip(ptrain._epoch_tensors(pds, order, bs, n_pad, pr),
                        jtrain._epoch_tensors(jds, order, bs, n_pad, jr)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ptrain._chunk_tensors(pds, pds, pc, 2, 2, n_pad, pr,
                                          pc.train),
                    jtrain._chunk_tensors(jds, jds, jc, 2, 2, n_pad, jr,
                                          jc.train)):
        np.testing.assert_array_equal(a, b)
    assert pr.bit_generator.state == jr.bit_generator.state


def test_early_stopping_schedule():
    """The reference's schedule (the JAX package's test_engine.py:101):
    warmup saves, patience past stop_epoch, improvement and EQUAL loss
    reset the counter."""
    es = ptrain.EarlyStopper(min_epochs=3, patience=2, stop_epoch=4)
    assert es.update(0, 1.0) and es.update(1, 2.0) and es.update(2, 1.5)
    assert not es.early_stop
    assert es.update(3, 1.2)
    assert not es.update(4, 1.3)
    assert not es.early_stop
    assert not es.update(5, 1.4)
    assert es.early_stop
    es2 = ptrain.EarlyStopper(min_epochs=0, patience=2, stop_epoch=0)
    es2.update(0, 1.0)
    es2.update(1, 2.0)
    assert es2.update(2, 0.5) and es2.counter == 0
    es3 = ptrain.EarlyStopper(min_epochs=0, patience=2, stop_epoch=0)
    es3.update(0, 1.0)
    for e in range(1, 6):
        assert es3.update(e, 1.0) and es3.counter == 0
    assert not es3.early_stop


@pytest.mark.parametrize("model_type,bs,inst,n_classes", [
    ("clam_sb", 1, False, 2), ("clam_sb", 4, True, 2),
    ("clam_mb", 1, True, 3), ("clam_mb", 4, True, 2)])
def test_step_fns_lockstep_with_jax(model_type, bs, inst, n_classes):
    """6 epochs of 6 steps of B bags through both packages' train_epoch
    from the JAX init, each followed by eval_batch on a held-out batch:
    losses, accuracy and eval outputs within 1e-5 every epoch."""
    jc, pc = _cfgs(task={"n_classes": n_classes,
                         "label_dict": {str(c): c for c in range(n_classes)}},
                   model={"model_type": model_type, "no_inst_cluster": not inst,
                          "subtyping": n_classes > 2},
                   train={"bag_loss": "balanced_ce" if bs > 1 else "ce"})
    n, d = 24, 192
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(7, 6, bs, n, d)).astype(np.float32)
    mask = rng.random((7, 6, bs, n)) > 0.2
    labels = rng.integers(0, n_classes, (7, 6, bs)).astype(np.int32)
    counts = np.bincount(labels.ravel(), minlength=n_classes)
    jf = jtrain.build_step_fns(jc, counts, n, d)
    params = jf.init_params(jax.random.PRNGKey(0))
    opt = jf.tx.init(params)
    pf = ptrain.build_step_fns(pc, counts, n, d, device="cpu")
    model = pf.init_params()
    model.load_state_dict(mil_state_dict_from_jax(params, model_type,
                                                  n_classes))
    popt = pf.tx(model.parameters())
    ev = (feats[6, 0], mask[6, 0], labels[6, 0])
    for e in range(6):
        params, opt, *want = jf.train_epoch(
            params, opt, jnp.asarray(feats[e]), jnp.asarray(mask[e]),
            jnp.asarray(labels[e]), jax.random.PRNGKey(e))
        got = pf.train_epoch(model, popt, feats[e], mask[e], labels[e])
        np.testing.assert_allclose(got, [float(w) for w in want], atol=TOL)
        jout = jf.eval_batch(params, *map(jnp.asarray, ev))
        pout = pf.eval_batch(model, *ev)
        for g, w in zip(pout, jout):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_bags(str(tmp_path_factory.mktemp("synth")),
                               n_slides=24, feat_dim=192, signal=1.5,
                               signal_fraction=0.4, seed=1)


@pytest.mark.parametrize("chunk", [1, 3])
def test_train_fold_matches_jax(synth, tmp_path, chunk):
    """Both packages' train_fold from one init (JAX's, carried into a .pt
    and a .msgpack; continue_training), dropout off, early stopping on:
    the same stopped epoch and history length, per-epoch losses and test
    probabilities within 1e-5, val / test AUC within 1e-6; the fold's .pt
    reloads. With epoch_chunk 3 the host draws three epochs at once, in
    the JAX package's order (the JAX package's test_engine.py:199 checks
    only the schedule; this checks the numbers too)."""
    manifest, jstore = synth
    train = {"max_epochs": 7, "min_epochs": 2, "patience": 2,
             "stop_epoch": 2, "early_stopping": True, "epoch_chunk": chunk,
             "continue_training": True, "weighted_sample": True}
    jc, pc = _cfgs(bags={"max_patches_per_slide": 32}, train=train)
    jc.results_dir, pc.results_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ids, labels = list(manifest.slide_ids), manifest.labels
    sel = (np.arange(0, 14), np.arange(14, 19), np.arange(19, 24))
    mk = lambda mod, store, cfg: [mod.BagDataset([ids[i] for i in s],
                                                 labels[s], store, cfg.bags)
                                  for s in sel]
    jds = mk(jbags, jstore, jc)
    pds = mk(pbags, pbags.FeatureBagStore(jstore.feat_dir), pc)
    counts = manifest.class_counts()
    n_pad = jds[0].pad_size()
    params = jtrain.build_step_fns(jc, counts, n_pad, 192).init_params(
        jax.random.PRNGKey(11))
    jckpt.save_params(jckpt.ckpt_path(jc.results_dir, 0), params)
    os.makedirs(pc.results_dir)
    torch.save(mil_state_dict_from_jax(params), ckpt_path(pc.results_dir, 0))

    want = jtrain.train_fold(jc, 0, *jds, counts, verbose=False)
    got = ptrain.train_fold(pc, 0, *pds, counts, verbose=False, device="cpu")
    assert got.stopped_epoch == want.stopped_epoch < 6
    assert len(got.history) == len(want.history) == got.stopped_epoch + 1
    for g, w in zip(got.history, want.history):
        for k in ("train_loss", "val_loss", "train_acc"):
            assert abs(g[k] - w[k]) <= TOL, (k, g, w)
    assert abs(got.val_auc - want.val_auc) <= 1e-6
    assert abs(got.test_auc - want.test_auc) <= 1e-6
    np.testing.assert_allclose(got.test_probs, want.test_probs, atol=TOL)
    assert got.test_slide_ids == want.test_slide_ids


def test_dropout_run_is_seeded_and_train_state_round_trips(synth, tmp_path):
    """train_fold with dropout 0.5 twice from one seed gives the same fold;
    save_train_state / load_train_state restore the head, the optimizer
    and the epoch."""
    manifest, jstore = synth
    _, pc = _cfgs(model={"drop_out": 0.5, "no_inst_cluster": False},
                  train={"max_epochs": 2, "early_stopping": False})
    ids, labels = list(manifest.slide_ids), manifest.labels
    store = pbags.FeatureBagStore(jstore.feat_dir)
    sel = (np.arange(0, 12), np.arange(12, 18), np.arange(18, 24))
    runs = []
    for r in range(2):
        pc.results_dir = str(tmp_path / f"r{r}")
        dss = [pbags.BagDataset([ids[i] for i in s], labels[s], store,
                                pc.bags) for s in sel]
        runs.append(ptrain.train_fold(pc, 0, *dss, manifest.class_counts(),
                                      verbose=False, device="cpu"))
    assert runs[0].history == runs[1].history
    np.testing.assert_array_equal(runs[0].test_probs, runs[1].test_probs)
    fns = ptrain.build_step_fns(pc, manifest.class_counts(), 32, 192,
                                device="cpu")
    model = fns.init_params(torch.Generator().manual_seed(0))
    opt = fns.tx(model.parameters())
    fns.train_epoch(model, opt, np.ones((1, 1, 8, 192), np.float32),
                    np.ones((1, 1, 8), bool), np.zeros((1, 1), np.int32))
    path = str(tmp_path / "state.pt")
    save_train_state(path, model, opt, 4)
    other = fns.init_params(torch.Generator().manual_seed(1))
    other_opt = fns.tx(other.parameters())
    assert load_train_state(path, other, other_opt) == 4
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    assert other_opt.state_dict()["state"][0]["step"] == 1


def test_entry_points_need_a_card_unless_asked():
    """build_step_fns (so train_fold and evaluate_fold) default to cuda and
    raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, pc = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        ptrain.build_step_fns(pc, np.array([1, 1]), 8, 192)
