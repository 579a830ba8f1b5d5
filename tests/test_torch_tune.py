"""The port's tuning (engine/tune.py, engine/checkpoint.TrainStateCheckpointer)
held against the JAX package's engine/tune.py on the CPU.

- ``sample_configs``: the same trials as the JAX package's for several
  seeds, with and without GridSearch axes (one numpy Generator, one draw
  order).
- ``TrialPlateauStopper`` and ``ASHAScheduler``: the same decisions on
  seeded loss sequences.
- ``run_tuning`` in both packages with one fake ``train_fold`` patched in:
  the same CSV bytes and best configuration; on ``resume`` the same best
  configuration and rows.
- A real small ``run_tuning`` on the CPU with ``checkpoint_trials``: the
  newest two epochs kept per trial, the last restoring the trial's final
  validation loss.
- ``tune_sampling_params`` with the JAX head's weights carried across:
  the same rows (AUC within 1e-6, equal mean_patches) and best trial.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import tune as jtune
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu_torch.engine import tune as ptune
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg


def _port_space(space):
    """A JAX search space rebuilt from the port's classes."""
    return {k: getattr(ptune, type(v).__name__)(*dataclasses.astuple(v))
            for k, v in space.items()}


GRID_SPACE = {"lr": jtune.LogUniform(1e-5, 1e-2),
              "model_size": jtune.GridSearch(["hipt_smaller", "hipt_small"]),
              "B": jtune.GridSearch([4, 8, 16]),
              "drop_out": jtune.Uniform(0.0, 0.9)}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("space", ["default", "sampling", "grid"])
def test_sample_configs_match_jax(space, seed):
    jspace = {"default": jtune.DEFAULT_SEARCH_SPACE,
              "sampling": jtune.SAMPLING_SEARCH_SPACE,
              "grid": GRID_SPACE}[space]
    want = jtune.sample_configs(jspace, 7, seed)
    got = ptune.sample_configs(_port_space(jspace), 7, seed)
    assert got == want
    assert len(got) == 7 * (6 if space == "grid" else 1)


def test_stoppers_match_jax():
    """Plateau (window std, mean rises, threshold) and ASHA (rungs at 2,
    4, 8; reduction 2 and 3) decisions on seeded noisy loss curves."""
    rng = np.random.default_rng(0)
    for trial in range(12):
        curve = 1.0 / (1 + np.arange(30)) + rng.normal(0, 0.01 * trial, 30)
        if trial % 3 == 0:
            curve = np.round(curve, 2)   # flat stretches: the std rule
        kw = dict(std=0.002, metric_threshold=0.9 if trial % 4 == 1 else None)
        a, b = jtune.TrialPlateauStopper(**kw), ptune.TrialPlateauStopper(**kw)
        assert [a(v) for v in curve] == [b(v) for v in curve]
    for rf in (2, 3):
        a = jtune.ASHAScheduler(max_t=12, grace_period=2, reduction_factor=rf)
        b = ptune.ASHAScheduler(max_t=12, grace_period=2, reduction_factor=rf)
        assert a.rungs == b.rungs
        losses = rng.uniform(0.2, 1.0, (10, 12))
        for t in range(10):
            assert [a.should_stop(e, losses[t, e]) for e in range(12)] == \
                [b.should_stop(e, losses[t, e]) for e in range(12)]


def _fake_train_fold(cfg, fold, *datasets, log_cb=None, state_cb=None,
                     **_):
    """A deterministic stand-in for train_fold: a loss curve set by the
    trial's fields, stopped where log_cb says."""
    hist = []
    lr, reg, p = cfg.train.lr, cfg.train.reg, cfg.model.drop_out
    for e in range(cfg.train.max_epochs):
        v = (0.4 + 0.08 * abs(np.log10(lr) + 3) + reg + 0.1 * p
             + 0.5 / (e + 1) + 0.02 * np.sin(3.0 * e * (1 + p)))
        rec = dict(epoch=e, train_loss=v, val_loss=float(v),
                   val_auc=float(1 - v / 2))
        hist.append(rec)
        if state_cb is not None:
            state_cb(e, None, None)
        if log_cb and log_cb(e, rec):
            break
    return SimpleNamespace(history=hist)


def test_run_tuning_matches_jax_with_a_shared_train_fold(tmp_path,
                                                         monkeypatch):
    """Six trials over the default space, max_epochs 12, grace 2: the JAX
    package's CSV byte for byte, its best configuration and epoch counts;
    then resume to ten trials in both: the same configuration, epochs and
    rows."""
    monkeypatch.setattr("hipt_abmil_atec23_tpu.engine.train.train_fold",
                        _fake_train_fold)
    monkeypatch.setattr("hipt_abmil_atec23_tpu_torch.engine.train."
                        "train_fold", _fake_train_fold)
    out = {}
    for n, resume in ((6, False), (10, True)):
        for name, mod, cfgmod in (("jax", jtune, jcfg), ("port", ptune,
                                                          pcfg)):
            base = cfgmod.ExperimentConfig(
                results_dir=str(tmp_path / name),
                train=cfgmod.TrainConfig(max_epochs=12))
            kw = dict(num_samples=n, grace_period=2, seed=3, verbose=False,
                      output_csv=str(tmp_path / f"{name}.csv"),
                      resume=resume)
            if name == "port":
                kw["device"] = "cpu"
            best, _, trials = mod.run_tuning(base, (None, None, None),
                                             np.array([5, 5]), **kw)
            out[name] = (best, [len(t.history) for t in trials],
                         open(tmp_path / f"{name}.csv").read())
        assert out["port"][:2] == out["jax"][:2]
        assert len(out["port"][2].splitlines()) == n + 1
        if not resume:
            assert out["port"][2] == out["jax"][2]
        else:
            # the JAX package reads its CSV back through pandas' fast
            # float parser, which may round the last digit or two
            pd.testing.assert_frame_equal(
                pd.read_csv(tmp_path / "port.csv"),
                pd.read_csv(tmp_path / "jax.csv"), rtol=1e-12)
    # trials stopped early (ASHA or plateau) and ran to the end
    assert min(out["port"][1]) < 12


def _bags(tmp_path, n_slides=18, bag_range=(40, 90), seed=5):
    from hipt_abmil_atec23_tpu_torch.data.synthetic import make_synthetic_bags
    return make_synthetic_bags(str(tmp_path / "bags"), n_slides=n_slides,
                               feat_dim=192, bag_range=bag_range, signal=1.5,
                               signal_fraction=0.4, seed=seed)


def test_run_tuning_with_trial_checkpoints(tmp_path):
    """Two trials of three epochs through the port's train_fold on the
    CPU, each keeping its newest two train states; the last restores to
    the trial's final validation loss (bags not subsampled, so the
    validation pass draws nothing)."""
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        TrainStateCheckpointer)
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        build_step_fns, evaluate_split)
    manifest, store = _bags(tmp_path)
    cfg = pcfg.ExperimentConfig(
        results_dir=str(tmp_path / "tune"),
        task=pcfg.TaskConfig(n_classes=2, label_dict={"0": 0, "1": 1}),
        bags=pcfg.BagConfig(max_patches_per_slide=None),
        model=pcfg.ModelConfig(model_size="hipt_smaller"),
        train=pcfg.TrainConfig(max_epochs=3, k=3, seed=2))
    folds = make_fold_datasets(manifest, store, cfg, 0)
    space = {"lr": ptune.Choice([1e-3, 3e-3]), "reg": ptune.Choice([1e-5])}
    best, rows, trials = ptune.run_tuning(
        cfg, folds, manifest.class_counts(), space=space, num_samples=2,
        grace_period=1, checkpoint_trials=True, verbose=False,
        output_csv=str(tmp_path / "t.csv"), device="cpu")
    assert best in [t.config for t in trials] and len(rows) == 2
    for ti, trial in enumerate(trials):
        ck = TrainStateCheckpointer(str(tmp_path / "tune" / f"trial_{ti}"
                                        / "ckpts"))
        last = len(trial.history) - 1
        assert ck.all_steps() == list(range(max(0, last - 1), last + 1))
        tcfg = ptune.apply_trial_config(cfg, trial.config)
        fns = build_step_fns(tcfg, manifest.class_counts(), 8, 192,
                             device="cpu")
        model = fns.init_params()
        opt = fns.tx(model.parameters())
        _, _, step = ck.restore(model, opt)
        assert step == last and opt.state_dict()["state"]
        _, loss = evaluate_split(fns, model, folds[1], folds[1].pad_size(),
                                 np.random.default_rng(0))
        assert abs(loss - trial.history[-1]["val_loss"]) <= 1e-6
        ck.close()


def test_checkpointer_keeps_the_newest(tmp_path):
    """save / latest_step / restore(step) / retention, written by the
    background thread and joined by close."""
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        TrainStateCheckpointer)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    ck = TrainStateCheckpointer(str(tmp_path / "c"), max_to_keep=3)
    weights = {}
    for step in range(5):
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        weights[step] = model.weight.detach().clone()
        ck.save(step, model, opt)
    ck.close()
    assert ck.all_steps() == [2, 3, 4] and ck.latest_step() == 4
    fresh = torch.nn.Linear(3, 2)
    _, _, step = ck.restore(fresh, step=3)
    assert step == 3 and torch.equal(fresh.weight, weights[3])


@pytest.fixture(scope="module")
def dras(tmp_path_factory):
    """Eight 192-d bags of 300-500 instances on square 256 px grids."""
    d = tmp_path_factory.mktemp("tune_dras")
    manifest, store = _bags(d, n_slides=8, bag_range=(300, 500), seed=9)
    coords = {}
    for sid in manifest.slide_ids:
        n = len(store.load_features(sid))
        side = int(np.ceil(np.sqrt(n)))
        yx = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                  indexing="ij"), -1).reshape(-1, 2)[:n]
        coords[sid] = (yx[:, ::-1] * 256).astype(np.int64)
    return manifest, store, coords


def test_tune_sampling_params_matches_jax(dras, tmp_path):
    """Three trials of DRAS parameters (iterations 2-4, the rest from the
    default space) on eight slides, the JAX head's weights in both: AUC
    within 1e-6, equal mean_patches, the same best trial."""
    import jax
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu.data.bags import BagDataset as JaxDataset
    from hipt_abmil_atec23_tpu.models import build_mil_model as jbuild
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax)
    manifest, store, coords = dras
    space = dict(jtune.SAMPLING_SEARCH_SPACE,
                 resampling_iterations=jtune.Choice([2, 3, 4]))
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": 0},
         "model": {"model_type": "clam_sb", "model_size": "hipt_smaller"}}
    jc, pc = jcfg.ExperimentConfig.from_dict(d), \
        pcfg.ExperimentConfig.from_dict(d)
    ids, labels = list(manifest.slide_ids), manifest.labels
    jm = jbuild("clam_sb", size_arg="hipt_smaller", n_classes=2)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((8, 192)), None)
    head = build_mil_model("clam_sb", size_arg="hipt_smaller")
    head.load_state_dict(mil_state_dict_from_jax(params))
    jbest, jdf = jtune.tune_sampling_params(
        jc, JaxDataset(ids, labels, store, jc.bags), params, jm,
        coords_lookup=coords, space=space, num_samples=3, seed=4,
        verbose=False)
    pbest, rows = ptune.tune_sampling_params(
        pc, BagDataset(ids, labels, store, pc.bags), head,
        coords_lookup=coords, space=_port_space(space), num_samples=3,
        seed=4, verbose=False, output_csv=str(tmp_path / "s.csv"),
        device="cpu")
    assert pbest == jbest
    want = jdf.to_dict("records")
    assert len(rows) == len(want) == 3
    for r, w in zip(rows, want):
        assert {k: v for k, v in r.items() if k not in ("auc",
                                                        "mean_patches")} \
            == {k: v for k, v in w.items() if k not in ("auc",
                                                        "mean_patches")}
        assert abs(r["auc"] - w["auc"]) <= 1e-6
        assert r["mean_patches"] == w["mean_patches"]
    got = pd.read_csv(tmp_path / "s.csv")
    assert list(got.columns) == list(jdf.columns) and len(got) == 3
