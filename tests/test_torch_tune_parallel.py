"""The port's trial-parallel tuning (engine/tune_parallel.py, over
engine/stacked.py) held against the JAX package's on the CPU.

- ``adam_l2_update`` on stacked lanes with per-lane lr and reg: within
  1e-6 of the JAX package's (one lane at a time) and of
  ``torch.optim.Adam(weight_decay=reg)`` over 5 steps.
- ``run_trials_parallel`` at T = 4 (CLAM_SB hipt_smaller with the instance
  loss, dropout 0, ASHA at grace 1) from the JAX package's initial lanes
  (the port's lane init patched to load them): per-epoch validation
  losses within 1e-5, the same ASHA kills and best trial; with and without
  a padding lane.
- ``run_tuning_hetero``: the JAX package's buckets and rows (within 1e-5)
  for 8 trials in 2 buckets over 3 epochs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import tune as jtune
from hipt_abmil_atec23_tpu.engine import tune_parallel as jtp
from hipt_abmil_atec23_tpu.models import build_mil_model as jax_build
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu.utils.seeding import jax_key
from hipt_abmil_atec23_tpu_torch.engine import tune as ptune
from hipt_abmil_atec23_tpu_torch.engine import tune_parallel as ptp
from hipt_abmil_atec23_tpu_torch.models.abmil import MIL_SIZE_DICT
from hipt_abmil_atec23_tpu_torch.models.convert import (
    mil_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg

TOL = 1e-5


def test_adam_l2_update_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    lr = np.array([1e-3, 3e-3, 1e-2], np.float32)
    reg = np.array([1e-2, 0.0, 1e-3], np.float32)
    p0 = {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
          "b": rng.normal(size=(3, 5)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    # port: all lanes at once
    p = {k: torch.from_numpy(v) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    count = torch.zeros(3)
    for g in grads:
        p, mu, nu, count = ptp.adam_l2_update(
            p, {k: torch.from_numpy(v) for k, v in g.items()}, mu, nu, count,
            torch.from_numpy(lr), torch.from_numpy(reg))
    for t in range(3):
        # JAX: one lane with scalar lr / reg
        jp = {k: jnp.asarray(v[t]) for k, v in p0.items()}
        jm = {k: jnp.zeros_like(v) for k, v in jp.items()}
        jv = {k: jnp.zeros_like(v) for k, v in jp.items()}
        jc = jnp.asarray(0)
        # torch.optim.Adam with weight decay: the sequential trainer's
        tp = {k: torch.nn.Parameter(torch.from_numpy(v[t].copy()))
              for k, v in p0.items()}
        opt = torch.optim.Adam(list(tp.values()), lr=float(lr[t]),
                               weight_decay=float(reg[t]))
        for g in grads:
            jp, jm, jv, jc = jtp.adam_l2_update(
                jp, {k: jnp.asarray(v[t]) for k, v in g.items()}, jm, jv, jc,
                lr[t], reg[t])
            for k in tp:
                tp[k].grad = torch.from_numpy(g[k][t].copy())
            opt.step()
        for k in p0:
            np.testing.assert_allclose(p[k][t].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(p[k][t].numpy(),
                                       tp[k].detach().numpy(), rtol=0,
                                       atol=1e-6)


def _jax_lane_heads(fns, seed, lanes):
    """The port's lane init replaced by the JAX package's (JAX
    tune_parallel.py:148-156: flax init from fold_in(jax_key(seed, 4242),
    t)), carried across through mil_state_dict_from_jax."""
    heads = []
    for t in lanes:
        head = fns.init_params()
        size = next(k for k, v in MIL_SIZE_DICT.items() if v == head.size)
        m = jax_build("clam_sb", size_arg=size, n_classes=2)
        params = m.init(jax.random.fold_in(jax_key(seed, 4242), t),
                        jnp.zeros((8, head.size[0])), None,
                        label=jnp.array(0), instance_eval=True)
        head.load_state_dict(mil_state_dict_from_jax(params))
        heads.append(head)
    return heads


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
    return make_synthetic_bags(str(tmp_path_factory.mktemp("tp")),
                               n_slides=18, feat_dim=192, bag_range=(40, 90),
                               signal=1.5, signal_fraction=0.4, seed=3)


def _cfgs(**train):
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": 32},
         "model": {"model_type": "clam_sb", "model_size": "hipt_smaller",
                   "no_inst_cluster": False, "k_sample": 4},
         "train": {"early_stopping": False, "k": 3, "seed": 0,
                   "weighted_sample": True, **train}}
    return jcfg.ExperimentConfig.from_dict(d), \
        pcfg.ExperimentConfig.from_dict(d)


@pytest.mark.parametrize("n_real", [None, 3], ids=["four", "three+pad"])
def test_run_trials_parallel_matches_jax(bags, monkeypatch, n_real):
    from hipt_abmil_atec23_tpu.engine.experiment import (
        make_fold_datasets as jax_folds)
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    monkeypatch.setattr(ptp, "_lane_heads", _jax_lane_heads)
    manifest, store = bags
    jc, pc = _cfgs(max_epochs=4)
    pman = SlideManifest(manifest.df, manifest.label_dict, manifest.n_classes)
    lrs = np.array([1e-3, 4e-3, 1e-4, 2e-2], np.float32)
    regs = np.array([1e-5, 1e-3, 1e-5, 1e-4], np.float32)
    want = jtp.run_trials_parallel(
        jc, jax_folds(manifest, store, jc, 0), manifest.class_counts(), lrs,
        regs, verbose=False, n_real=n_real,
        asha=jtune.ASHAScheduler(max_t=4, grace_period=1))
    got = ptp.run_trials_parallel(
        pc, make_fold_datasets(pman, FeatureBagStore(store.feat_dir), pc, 0),
        manifest.class_counts(), lrs, regs, verbose=False, n_real=n_real,
        asha=ptune.ASHAScheduler(max_t=4, grace_period=1), device="cpu")
    assert np.array_equal(np.isnan(got.val_loss), np.isnan(want.val_loss))
    np.testing.assert_allclose(got.val_loss, want.val_loss, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.stopped_epoch, want.stopped_epoch)
    assert got.best_trial == want.best_trial
    assert np.isnan(got.val_loss).any()   # ASHA killed a lane


def test_run_tuning_hetero_matches_jax(bags, monkeypatch, tmp_path):
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    monkeypatch.setattr(ptp, "_lane_heads", _jax_lane_heads)
    manifest, store = bags
    jc, pc = _cfgs()
    pman = SlideManifest(manifest.df, manifest.label_dict, manifest.n_classes)
    jspace = {"lr": jtune.LogUniform(1e-4, 1e-2),
              "reg": jtune.LogUniform(1e-5, 1e-2),
              "model_size": jtune.GridSearch(["hipt_smaller", "hipt_small"])}
    pspace = {"lr": ptune.LogUniform(1e-4, 1e-2),
              "reg": ptune.LogUniform(1e-5, 1e-2),
              "model_size": ptune.GridSearch(["hipt_smaller", "hipt_small"])}
    configs = jtune.sample_configs(jspace, 4, 1)
    buckets = {jtp._bucket_key(c) for c in configs}
    assert len(configs) == 8 and len(buckets) == 2
    assert [ptp._bucket_key(c) for c in configs] == \
        [jtp._bucket_key(c) for c in configs]
    kw = dict(space=None, num_samples=4, max_epochs=3, grace_period=1,
              seed=1, verbose=False)
    jbest, jdf = jtp.run_tuning_hetero(
        jc, manifest, store, manifest.class_counts(),
        **dict(kw, space=jspace))
    pbest, rows = ptp.run_tuning_hetero(
        pc, pman, FeatureBagStore(store.feat_dir), manifest.class_counts(),
        **dict(kw, space=pspace), output_csv=str(tmp_path / "h.csv"),
        device="cpu")
    assert pbest == jbest
    want = jdf.to_dict("records")
    assert len(rows) == len(want) == 8
    for r, w in zip(rows, want):
        assert list(r) == list(w)
        for k in w:
            if isinstance(w[k], float):
                assert abs(r[k] - w[k]) <= TOL, (k, r, w)
            else:
                assert r[k] == w[k], (k, r, w)
