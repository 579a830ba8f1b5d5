"""The port's DRAS sampling (hipt_abmil_atec23_tpu_torch/engine/sampling.py)
held against the JAX package's on the CPU.

- Host math: ``generate_sample_idxs`` (weighted, exhausted and grid draws)
  and ``update_sampling_weights`` (all four rules) equal the JAX package's
  from the same numpy Generator, which is left in the same state.
- ``knn_indices``: identical indices, order included, on 256 px grids
  (every distance ties with others), integer coords and 64-d features.
- ``dras_sample_slide`` with one shared attention oracle and one seed:
  identical final draws, sampled sets and weights for every rule.
- ``make_attention_fn`` against JAX's at 1e-5 for the pooled head (gated
  CLAM_SB: the pool's plain version here), ungated CLAM_SB and CLAM_MB.
- ``eval_sampling`` and ``train_fold_sampling`` in lockstep with the JAX
  package on small CLAM_SB heads (weights bridged with
  ``mil_state_dict_from_jax``, dropout 0): probabilities and losses within
  1e-5, the same sampled counts and stopped epoch.
- The device loop against the host loop by distribution (the JAX
  package's own test of its device loop, tests/test_sampling.py:301), its
  invariants, and its draws fixed by the generator.
- Textural sampling (the bag itself, a texture store) and a lazy
  ``feature_lookup`` that is asked only for sampled rows.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.data import bags as jbags
from hipt_abmil_atec23_tpu.engine import sampling as J
from hipt_abmil_atec23_tpu.engine import train as jtrain
from hipt_abmil_atec23_tpu.models import build_mil_model as jbuild
from hipt_abmil_atec23_tpu.utils import config as jcfg
from hipt_abmil_atec23_tpu.utils.seeding import jax_key
from hipt_abmil_atec23_tpu_torch.data import bags as pbags
from hipt_abmil_atec23_tpu_torch.engine import sampling as P
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import ckpt_path
from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
from hipt_abmil_atec23_tpu_torch.models.convert import mil_state_dict_from_jax
from hipt_abmil_atec23_tpu_torch.utils import config as pcfg

TOL = 1e-5
CPU = torch.device("cpu")


def grid(nx, ny, step=256):
    return (np.stack(np.meshgrid(np.arange(nx), np.arange(ny)), -1)
            .reshape(-1, 2) * step).astype(np.int64)


def test_generate_sample_idxs_matches_jax():
    """Weighted + random draws, a weighted pool exhausted by zeros, and the
    grid-stratified initial draw: the same indices and Generator state."""
    w = np.random.default_rng(0).uniform(0, 1, 500)
    w[::3] = 0.0
    coords = np.random.default_rng(1).integers(0, 10000, (500, 2))
    cases = [dict(n=500, previous=list(range(40)), weights=w,
                  samples_per_iteration=50, num_random=10),
             dict(n=500, previous=[], weights=np.where(np.arange(500) < 5,
                                                       1.0, 0.0),
                  samples_per_iteration=30, num_random=4),
             dict(n=500, previous=[], weights=None, samples_per_iteration=49,
                  num_random=49, grid=True, coords=coords)]
    for kw in cases:
        jr, pr = np.random.default_rng(7), np.random.default_rng(7)
        got = P.generate_sample_idxs(rng=pr, **kw)
        want = J.generate_sample_idxs(rng=jr, **kw)
        assert [int(i) for i in got] == [int(i) for i in want]
        assert pr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("rule", P.SAMPLING_UPDATES)
@pytest.mark.parametrize("normalise", [False, True])
def test_update_sampling_weights_matches_jax(rule, normalise):
    rng = np.random.default_rng(2)
    n, s, k = 300, 30, 8
    w0 = rng.uniform(0.001, 1.0, n)
    attn = rng.uniform(0, 1, s)
    nbrs = np.stack([rng.choice(n, k, replace=False) for _ in range(s)])
    sampled = list(rng.choice(n, 20, replace=False))
    kw = dict(power=0.15, normalise=normalise, sampling_update=rule)
    np.testing.assert_array_equal(
        P.update_sampling_weights(w0, attn, sampled, nbrs, k, **kw),
        J.update_sampling_weights(w0, attn, sampled, nbrs, k, **kw))


@pytest.mark.parametrize("space", ["grid", "grid_offset", "int_coords",
                                   "features"])
def test_knn_indices_matches_jax_with_ties(space):
    """On a 256 px grid every query has rings of equally distant
    neighbours and the k-th boundary cuts through one: both packages keep
    the lower indices, in the same order."""
    rng = np.random.default_rng(3)
    X = {"grid": grid(60, 50), "grid_offset": grid(60, 50) * 40 + 1000,
         "int_coords": rng.integers(0, 100_000, (3000, 2)),
         "features": rng.normal(size=(2000, 64))}[space].astype(np.float32)
    sel = rng.choice(len(X), 100, replace=False)
    want = np.asarray(J.knn_indices(X, X[sel], 20))
    got = P.knn_indices(X, X[sel], 20, device=CPU)
    assert got.dtype == torch.int64 and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)
    if space == "grid":
        # ties really are broken: rows hold equal distances side by side
        d = ((X[sel][:, None] - X[want]) ** 2).sum(-1)
        assert (np.diff(d, axis=1) == 0).any()


def test_knn_indices_places_arrays_on_the_card_by_default():
    """A tensor keeps its device; an array goes to ``device``, the card
    unless the caller names another, so without one it raises here."""
    X = grid(10, 10).astype(np.float32)
    got = P.knn_indices(torch.from_numpy(X), torch.from_numpy(X[:5]), 4)
    assert got.device == CPU
    np.testing.assert_array_equal(
        got.numpy(), P.knn_indices(X, X[:5], 4, device="cpu").numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            P.knn_indices(X, X[:5], 4)


def _oracle(feats):
    """A deterministic attention oracle on the feature values, shared by
    both packages: patches with large feature 0 get the attention."""
    def attention_fn(sub):
        a = np.exp(3.0 * np.asarray(sub)[:, 0])
        return a / a.sum()
    return attention_fn


@pytest.mark.parametrize("rule", P.SAMPLING_UPDATES)
def test_dras_sample_slide_matches_jax(rule):
    """The host loop from one seed and one oracle: identical final draws,
    sampled sets and weights (so identical bags)."""
    rng = np.random.default_rng(4)
    coords = grid(40, 30)
    feats = rng.normal(size=(len(coords), 8)).astype(np.float32)
    feats[300:420, 0] += 2.0
    cfg = dict(samples_per_iteration=32, resampling_iterations=5,
               sampling_neighbors=12, final_sample_size=40,
               sampling_update=rule, grid_initial_sample=rule == "average")
    got = P.dras_sample_slide(feats, coords, _oracle(feats),
                              P.SamplingConfig(**cfg),
                              np.random.default_rng(9), device=CPU)
    want = J.dras_sample_slide(feats, coords, _oracle(feats),
                               J.SamplingConfig(**cfg),
                               np.random.default_rng(9))
    np.testing.assert_array_equal(got.final_idxs, want.final_idxs)
    assert got.all_sampled == want.all_sampled
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.bag_idxs, want.bag_idxs)


def test_sampling_config_and_bag_cap():
    assert P.SamplingConfig(sampling_average=True).sampling_update == \
        "average"
    for kw in ({}, dict(final_sample_size=48, resampling_iterations=3,
                        samples_per_iteration=31)):
        assert P._bag_cap(P.SamplingConfig(**kw)) == \
            J._bag_cap(J.SamplingConfig(**kw))
    res = P.dras_sample_slide(np.zeros((50, 4), np.float32),
                              grid(10, 5), None,
                              P.SamplingConfig(final_sample_size=100),
                              np.random.default_rng(0), device=CPU)
    assert sorted(res.final_idxs.tolist()) == list(range(50))


def _heads(model_type, gate=True, d=192, seed=0):
    """One set of weights in both packages: the JAX head's init carried
    into the port's head."""
    n_classes = 2
    jm = jbuild(model_type, size_arg="hipt_smaller", n_classes=n_classes,
                gate=gate)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((8, d)), None)
    pm = build_mil_model(model_type, size_arg="hipt_smaller",
                         n_classes=n_classes, gate=gate)
    pm.load_state_dict(mil_state_dict_from_jax(params, model_type,
                                               n_classes))
    return jm, params, pm.eval()


@pytest.mark.parametrize("model_type,gate", [("clam_sb", True),
                                             ("clam_sb", False),
                                             ("clam_mb", True)])
def test_make_attention_fn_matches_jax(model_type, gate):
    jm, params, pm = _heads(model_type, gate)
    jfn = J.make_attention_fn(jm, 64)
    pfn = P.make_attention_fn(pm)
    rng = np.random.default_rng(5)
    for n in (64, 37, 1):
        sub = rng.normal(size=(n, 192)).astype(np.float32)
        got = pfn(sub)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, jfn(params, sub), atol=TOL)
    assert pfn(np.zeros((0, 192), np.float32)).shape == (0,)


def test_attention_needs_an_attention_head():
    with pytest.raises(ValueError, match="attention head"):
        P.make_attention_fn(build_mil_model("mil"))(np.ones((3, 1024),
                                                            np.float32))


@pytest.fixture(scope="module")
def slides():
    """Ten 192-d bags of 150-260 instances on 256 px grids, a planted
    signal on part of the class-1 slides' rows, written as npy for both
    packages' stores; and a 16-d texture bag per slide."""
    rng = np.random.default_rng(6)
    bags, coords, textures = {}, {}, {}
    labels = np.arange(10) % 2
    for i in range(10):
        n = int(rng.integers(150, 260))
        bag = rng.normal(size=(n, 192)).astype(np.float32)
        if labels[i]:
            bag[: n // 3] += 0.8
        sid = f"s{i}"
        bags[sid], coords[sid] = bag, grid(20, 13)[:n]
        textures[sid] = rng.normal(size=(n, 16)).astype(np.float32)
    return bags, coords, textures, labels


class _Store:
    def __init__(self, bags):
        self.bags = bags

    def load_features(self, sid):
        return self.bags[sid]


def _cfgs(**over):
    d = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
         "bags": {"max_patches_per_slide": 0, "batch_size": 1},
         "model": {"model_type": "clam_sb", "model_size": "hipt_smaller",
                   "no_inst_cluster": True},
         "train": {"lr": 1e-3, "reg": 1e-5, "seed": 2,
                   "weighted_sample": True}}
    for k, v in over.items():
        d[k] = {**d.get(k, {}), **v}
    return jcfg.ExperimentConfig.from_dict(d), pcfg.ExperimentConfig.from_dict(d)


SCFG = dict(samples_per_iteration=24, resampling_iterations=3,
            sampling_neighbors=8, final_sample_size=32)


@pytest.mark.parametrize("case", ["spatial", "average", "textural_bag",
                                  "textural_store"])
def test_eval_sampling_matches_jax(slides, case):
    """eval_sampling from one seed: per-slide probabilities within 1e-5
    and the same number of patches used, the port's DRAS bag through the
    pool (its plain version here)."""
    bags, coords, textures, labels = slides
    jc, pc = _cfgs()
    kw = dict(SCFG, sampling_update="average" if case == "average" else
              "max", sampling_type="textural" if "textural" in case
              else "spatial")
    tex = textures if case == "textural_store" else None
    ids = list(bags)
    jm, params, pm = _heads("clam_sb")
    want_p, want_n = J.eval_sampling(
        jc, J.SamplingConfig(**kw),
        jbags.BagDataset(ids, labels, _Store(bags), jc.bags), params, jm,
        coords_lookup=coords, texture_lookup=tex, seed=3)
    got_p, got_n = P.eval_sampling(
        pc, P.SamplingConfig(**kw),
        pbags.BagDataset(ids, labels, _Store(bags), pc.bags), pm,
        coords_lookup=coords, texture_lookup=tex, seed=3, device="cpu")
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_p, want_p, atol=TOL)


class _Lazy:
    """A lazy feature source (OnlineFeatureGather's surface) that records
    the rows it was asked for."""

    def __init__(self, bag):
        self.bag, self.asked = bag, set()

    def __len__(self):
        return len(self.bag)

    @property
    def shape(self):
        return self.bag.shape

    def take(self, idxs, axis=0):
        self.asked.update(int(i) for i in idxs)
        return self.bag.take(idxs, axis=axis)


def test_eval_sampling_lazy_feature_lookup(slides):
    """A lazy feature_lookup gives the probabilities of the full bags from
    the same seed and is asked only for the rows DRAS sampled; textural
    sampling over a lazy source needs texture features."""
    bags, coords, textures, labels = slides
    _, pc = _cfgs()
    ids = list(bags)[:4]
    ds = pbags.BagDataset(ids, labels[:4], _Store(bags), pc.bags)
    _, _, pm = _heads("clam_sb")
    scfg = P.SamplingConfig(**SCFG)
    full_p, full_n = P.eval_sampling(pc, scfg, ds, pm, coords_lookup=coords,
                                     seed=1, device="cpu")
    lazy = {s: _Lazy(bags[s]) for s in ids}
    lazy_p, lazy_n = P.eval_sampling(pc, scfg, ds, pm, coords_lookup=coords,
                                     seed=1, feature_lookup=lazy,
                                     device_loop=True, device="cpu")
    np.testing.assert_array_equal(lazy_p, full_p)
    np.testing.assert_array_equal(lazy_n, full_n)
    for s, n in zip(ids, lazy_n):
        assert len(lazy[s].asked) == n < len(bags[s])
    with pytest.raises(ValueError, match="texture_features"):
        P.eval_sampling(pc, dataclasses.replace(scfg,
                                                sampling_type="textural"),
                        ds, pm, coords_lookup=coords, feature_lookup=lazy,
                        device="cpu")


@pytest.mark.parametrize("device_loop", [False, True])
def test_train_fold_sampling_matches_jax(slides, tmp_path, device_loop):
    """train_fold_sampling in lockstep with the JAX package: one full-bag
    epoch then two DRAS epochs from the JAX init (carried into the fold's
    .pt, continue_training), dropout 0, one host stream: every epoch's
    train / val loss and the test probabilities within 1e-5. With the
    device loop the two packages draw different bags (their generators
    differ), so the run is held to its own invariants instead."""
    bags, coords, _, labels = slides
    jc, pc = _cfgs(train={"max_epochs": 3, "early_stopping": False,
                          "continue_training": True})
    jc.results_dir = str(tmp_path / "j")
    ids = list(bags)
    parts = (np.arange(0, 6), np.arange(6, 8), np.arange(8, 10))
    mk = lambda mod, cfg: [mod.BagDataset([ids[i] for i in p], labels[p],
                                          _Store(bags), cfg.bags)
                           for p in parts]
    kw = dict(SCFG, no_sampling_epochs=1, device_loop=device_loop)
    counts = np.bincount(labels, minlength=2)
    jds = mk(jbags, jc)
    n_pad = max(d.pad_size() for d in jds)
    params = jtrain.build_step_fns(jc, counts, n_pad, 192).init_params(
        jax_key(jc.train.seed, 0))
    init = mil_state_dict_from_jax(params)

    def port_run(results_dir):
        pc.results_dir = results_dir
        os.makedirs(results_dir)
        torch.save(init, ckpt_path(results_dir, 0))
        return P.train_fold_sampling(pc, P.SamplingConfig(**kw), 0,
                                     *mk(pbags, pc), counts,
                                     coords_lookup=coords, verbose=False,
                                     device="cpu")
    got = port_run(str(tmp_path / "p"))
    assert len(got.history) == 3 and got.stopped_epoch == 2
    assert all(np.isfinite(h["train_loss"]) for h in got.history)
    if device_loop:
        # seeded: a second run from the same .pt draws the same bags
        again = port_run(str(tmp_path / "p2"))
        assert again.history == got.history
        np.testing.assert_array_equal(again.test_probs, got.test_probs)
        return
    want = J.train_fold_sampling(jc, J.SamplingConfig(**kw), 0, *jds, counts,
                                 coords_lookup=coords, verbose=False)
    for g, w in zip(got.history, want.history):
        for k in ("train_loss", "val_loss"):
            assert abs(g[k] - w[k]) <= TOL, (k, g, w)
    np.testing.assert_allclose(got.test_probs, want.test_probs, atol=TOL)
    assert abs(got.test_auc - want.test_auc) <= 1e-6


def _planted():
    """The JAX package's host/device agreement setup
    (tests/test_sampling.py:301): a hand-built CLAM_SB whose attention is
    monotone in feature 0, 120 planted patches with feature 0 at 5."""
    rng = np.random.default_rng(0)
    n, d = 1000, 192
    feats = rng.normal(size=(n, d)).astype(np.float32) * 0.1
    planted = np.arange(200, 320)
    feats[planted, 0] = 5.0
    coords = np.stack([np.arange(n) % 40, np.arange(n) // 40], 1) * 256
    model = build_mil_model("clam_sb", size_arg="hipt_smaller")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        model.attention_net[0].weight[0, 0] = 1.0
        model.attention_net[2].attention_a[0].weight[0, 0] = 1.0
        model.attention_net[2].attention_c.weight[0, 0] = 4.0
    return feats, coords, planted, model.eval()


def test_device_loop_matches_host_loop_in_distribution():
    """Weight concentration on the planted patches and their share of the
    final draw agree between the two loops over three seeds, within the
    JAX package's bounds for its own pair (0.35 and 0.08)."""
    feats, coords, planted, model = _planted()
    cfg = P.SamplingConfig(resampling_iterations=6, samples_per_iteration=64,
                           final_sample_size=96, sampling_neighbors=8,
                           sampling_random=0.4)
    attn = P.make_attention_fn(model)

    def stats(res):
        w = np.asarray(res.weights, np.float64)
        ratio = w[planted].mean() / max(np.delete(w, planted).mean(), 1e-9)
        return ratio, np.isin(res.final_idxs, planted).mean()

    host, dev = [], []
    for seed in range(3):
        host.append(stats(P.dras_sample_slide(
            feats, coords, attn, cfg, np.random.default_rng(seed),
            device=CPU)))
        dev.append(stats(P.dras_sample_slide_device(
            feats, coords, model, cfg,
            torch.Generator().manual_seed(seed))))
    (rh, fh), (rd, fd) = np.mean(host, 0), np.mean(dev, 0)
    assert abs(rh - rd) < 0.35, (host, dev)
    assert abs(fh - fd) < 0.08, (host, dev)
    chance = len(planted) / len(feats)
    assert fh > 0.5 * chance and fd > 0.5 * chance


def test_device_loop_invariants():
    """The device loop (the JAX package's test_dras_device_scan_variant):
    a full final draw without repeats, sampled patches zeroed, neighbours
    lifted off the floor, the final draw on non-zero weights; the draws
    fixed by the generator's seed."""
    feats, coords, _, model = _planted()
    cfg = P.SamplingConfig(resampling_iterations=6, samples_per_iteration=64,
                           final_sample_size=96, sampling_neighbors=8)
    run = lambda s: P.dras_sample_slide_device(
        feats, coords, model, cfg, torch.Generator().manual_seed(s))
    res = run(0)
    w = res.weights
    assert w.dtype == np.float32 and np.isfinite(w).all() and (w >= 0).all()
    assert res.final_idxs.shape == (96,)
    assert len(np.unique(res.final_idxs)) == 96
    assert len(res.all_sampled) == 6 * 64
    assert (w[res.all_sampled] == 0).all() and (w > 2e-4).any()
    assert (w[res.final_idxs] > 0).all()
    np.testing.assert_array_equal(run(0).final_idxs, res.final_idxs)
    assert not np.array_equal(run(5).final_idxs, res.final_idxs)
    # the textural space of the bag itself
    tex = P.dras_sample_slide_device(
        feats, coords, model, dataclasses.replace(cfg,
                                                  sampling_type="textural"),
        torch.Generator().manual_seed(0))
    assert len(np.unique(tex.final_idxs)) == 96


def test_eval_sampling_needs_a_card_unless_asked(slides):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    bags, coords, _, labels = slides
    _, pc = _cfgs()
    ds = pbags.BagDataset(list(bags), labels, _Store(bags), pc.bags)
    with pytest.raises(RuntimeError, match="cuda"):
        P.eval_sampling(pc, P.SamplingConfig(**SCFG), ds, _heads("clam_sb")[2],
                        coords_lookup=coords)
