"""The port's partial pooling, shard combine and the host modules of its
full-bag trainer held against the JAX package on the CPU: the plain
partial version against the JAX package's partial kernel in interpret mode
(grid and DMA launchers), the plain full-bag pool at the reference CLAM
width against the JAX package's apply_pooled, combine_partials against the
unsharded pool, make_optimizer against optax, and the copied metrics,
seeding, config and bag helpers against their originals. The sharded
forward and trainer across processes are in test_torch_sharded_dist.py."""
import dataclasses
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipt_abmil_atec23_tpu.data import bags as jbags
from hipt_abmil_atec23_tpu.engine import metrics as jmetrics
from hipt_abmil_atec23_tpu.engine.train import make_optimizer as jax_opt
from hipt_abmil_atec23_tpu.models import CLAM_SB as JaxCLAM
from hipt_abmil_atec23_tpu.ops import gated_attention_pool as jgap
from hipt_abmil_atec23_tpu.utils import config as jconfig
from hipt_abmil_atec23_tpu.utils import seeding as jseeding
from hipt_abmil_atec23_tpu_torch.data import bags
from hipt_abmil_atec23_tpu_torch.engine import metrics
from hipt_abmil_atec23_tpu_torch.engine.train import make_optimizer
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    MIL_SIZE_DICT, CLAM_SB, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.models.convert import (
    clam_state_dict_from_jax)
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.utils import config, seeding

WIDTHS = ["hipt_smaller", "small"]


def _interpret(fn, *args, **kwargs):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    with mock.patch.object(jgap.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return fn(*args, **kwargs)


def _params(rng, size_arg, c=2):
    """Pool weights at a CLAM width, drawn at the reference init's scale
    (xavier) with non-zero biases."""
    d_in, l, d = MIL_SIZE_DICT[size_arg]
    shapes = [("w_f", (d_in, l)), ("b_f", (l,)), ("w_a", (l, d)),
              ("b_a", (d,)), ("w_b", (l, d)), ("b_b", (d,)),
              ("w_c", (d, 1)), ("b_c", (1,)), ("w_cls", (l, c)),
              ("b_cls", (c,))]
    arrs = {}
    for k, s in shapes:
        scale = (2.0 / sum(s)) ** 0.5 if len(s) == 2 else 0.1
        arrs[k] = (rng.normal(size=s) * scale).astype(np.float32)
    return (jgap.GatedPoolParams(**{k: jnp.asarray(v)
                                    for k, v in arrs.items()}),
            gap.GatedPoolParams(**{k: torch.from_numpy(v)
                                   for k, v in arrs.items()}))


@pytest.mark.parametrize("impl", ["grid", "dma"])
@pytest.mark.parametrize("masking", ["tail", "none", "all"])
@pytest.mark.parametrize("size_arg", WIDTHS)
def test_plain_partial_matches_pallas_partial(size_arg, masking, impl, rng):
    """The plain partial version against the JAX package's partial kernel
    (interpret mode): acc, m, l and scores at rtol/atol 1e-5; an
    all-masked shard gives m = -1e30, l = 0, acc = 0."""
    jp, tp = _params(rng, size_arg)
    n = 300
    bag = rng.normal(size=(n, MIL_SIZE_DICT[size_arg][0])).astype(np.float32)
    mask = {"tail": np.arange(n) < 271, "none": None,
            "all": np.zeros(n, bool)}[masking]
    want = _interpret(jgap.gated_attention_pool_partial, jnp.asarray(bag), jp,
                      mask=None if mask is None else jnp.asarray(mask),
                      tile=128, impl=impl)
    got = gap.gated_attention_pool_partial(
        torch.from_numpy(bag), tp,
        mask=None if mask is None else torch.from_numpy(mask), impl=impl)
    assert got[0].shape == (1, MIL_SIZE_DICT[size_arg][1])
    assert got[1].shape == () and got[2].shape == () and got[3].shape == (n,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if masking == "all":
        assert got[1].item() == np.float32(gap.NEG_INF) and got[2].item() == 0
        assert not got[0].numpy().any()


@pytest.mark.parametrize("size_arg", WIDTHS)
def test_plain_pool_matches_jax_apply_pooled(size_arg, rng):
    """The plain full-bag pool at a CLAM width (the reference 'small' head
    among them) against the JAX package's apply_pooled(force=True) through
    CLAM_SB's own weights."""
    d_in = MIL_SIZE_DICT[size_arg][0]
    model = JaxCLAM(size_arg=size_arg, n_classes=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((8, d_in)), None)
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.normal(size=a.shape).astype(np.float32),
        params)
    port = CLAM_SB(size_arg, n_classes=2)
    port.load_state_dict(clam_state_dict_from_jax(params))
    bag = rng.normal(size=(300, d_in)).astype(np.float32)
    mask = np.arange(300) < 260
    want = jgap.apply_pooled(model, params, jnp.asarray(bag),
                             jnp.asarray(mask), force=True)
    with torch.inference_mode():
        got = gap.apply_pooled(port.eval(), torch.from_numpy(bag),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.a_raw.numpy()[:, :260],
                               np.asarray(want.a_raw)[:, :260],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dead", [None, 0, 3])
@pytest.mark.parametrize("size_arg", WIDTHS)
def test_combine_partials_matches_full_pool(size_arg, dead, rng):
    """Four shards' partials through combine_partials equal the full-bag
    pool, with one shard all-masked (weight 0) or none."""
    _, tp = _params(rng, size_arg)
    n = 4 * 75
    bag = torch.from_numpy(
        rng.normal(size=(n, MIL_SIZE_DICT[size_arg][0])).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    if dead is not None:
        mask[dead * 75:(dead + 1) * 75] = False
    parts = [gap.gated_attention_pool_partial(bag[i:i + 75], tp,
                                              mask=mask[i:i + 75])
             for i in range(0, n, 75)]
    acc, m, l, _ = (torch.stack([p[j] for p in parts]) for j in range(4))
    got = gap.combine_partials(acc[:, 0], m, l, tp)
    want, _ = gap.gated_attention_pool(bag, tp, mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_combine_partials_all_masked_bag_gives_bias(rng):
    _, tp = _params(rng, "hipt_smaller")
    bag = torch.randn(128, 192)
    none = torch.zeros(64, dtype=torch.bool)
    parts = [gap.gated_attention_pool_partial(bag[i:i + 64], tp, mask=none)
             for i in (0, 64)]
    acc, m, l, _ = (torch.stack([p[j] for p in parts]) for j in range(4))
    got = gap.combine_partials(acc[:, 0], m, l, tp)
    np.testing.assert_array_equal(got.numpy()[0], tp.b_cls.numpy())


def test_pool_refuses_unknown_impl(rng):
    _, tp = _params(rng, "hipt_smaller")
    with pytest.raises(ValueError):
        gap.gated_attention_pool(torch.randn(4, 192), tp, impl="ring")
    with pytest.raises(ValueError):
        gap.gated_attention_pool_partial(torch.randn(4, 192), tp,
                                         impl="ring")


def _torch_params(jparams):
    return {k: torch.tensor(np.asarray(v), requires_grad=True)
            for k, v in jparams.items()}


@pytest.mark.parametrize("reg", [0.0, 0.5])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_make_optimizer_matches_optax(opt, reg, rng):
    """Four steps of the port's optimizer against the JAX package's optax
    chain (L2 added to the gradient, then Adam or SGD with momentum) on
    the same gradients."""
    p0 = {"w": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    tx = jax_opt(opt, 1e-2, reg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = _torch_params(p0)
    optim = make_optimizer(opt, 1e-2, reg)(tp.values())
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        optim.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


def test_make_optimizer_refuses_unknown():
    with pytest.raises(ValueError):
        make_optimizer("lamb", 1e-3, 0.0)


def test_metrics_match_jax_package(rng):
    labels = rng.integers(0, 3, size=40)
    probs = rng.random((40, 3))
    probs[5] = probs[6]  # ties
    assert metrics.binary_auc(labels == 1, probs[:, 1]) == \
        jmetrics.binary_auc(labels == 1, probs[:, 1])
    np.testing.assert_array_equal(metrics._midranks(probs[:, 0]),
                                  jmetrics._midranks(probs[:, 0]))
    for c in (2, 3):
        lab = labels % c
        assert metrics.auc_score(lab, probs[:, :c], c) == \
            jmetrics.auc_score(lab, probs[:, :c], c)
    assert metrics.multiclass_auc_ovr(labels, probs) == \
        jmetrics.multiclass_auc_ovr(labels, probs)
    assert metrics.accuracy(labels, probs.argmax(1)) == \
        jmetrics.accuracy(labels, probs.argmax(1))
    assert np.isnan(metrics.binary_auc(np.ones(4), np.arange(4)))


def test_seeding_streams_match_jax_package():
    assert seeding.fold_seed(7, 3) == jseeding.fold_seed(7, 3)
    np.testing.assert_array_equal(seeding.host_rng(5, 7).permutation(20),
                                  jseeding.host_rng(5, 7).permutation(20))
    a = torch.randn(4, generator=seeding.torch_generator(5, 1))
    b = torch.randn(4, generator=seeding.torch_generator(5, 1))
    c = torch.randn(4, generator=seeding.torch_generator(5, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["TrainConfig", "TaskConfig",
                                  "ExperimentConfig"])
def test_config_defaults_match_jax_package(name):
    ours, theirs = getattr(config, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_experiment_config_round_trips(tmp_path):
    cfg = config.ExperimentConfig(
        train=config.TrainConfig(lr=2e-3, max_epochs=3),
        task=config.TaskConfig(n_classes=3, ignore=("x",)))
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    back = config.ExperimentConfig.load(path)
    assert back == cfg
    assert jconfig.ExperimentConfig.load(path).train.lr == 2e-3
    with pytest.raises(KeyError):
        config.ExperimentConfig.from_dict({"nope": 1})


@pytest.mark.parametrize("weighted", [True, False])
def test_epoch_order_matches_jax_package(weighted):
    labels = np.array([0, 0, 0, 1, 1, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(
        bags.epoch_order(labels, 2, np.random.default_rng(3), weighted),
        jbags.epoch_order(labels, 2, np.random.default_rng(3), weighted))
    np.testing.assert_array_equal(bags.balanced_sample_weights(labels, 2),
                                  jbags.balanced_sample_weights(labels, 2))


def test_bag_dataset_and_synthetic_bags_match_jax_package(tmp_path):
    """The port's make_synthetic_bags writes the JAX package's bags for one
    seed, and its BagDataset reads them back with the same pad size."""
    from hipt_abmil_atec23_tpu.data.synthetic import (
        make_synthetic_bags as jax_bags)
    from hipt_abmil_atec23_tpu_torch.data.synthetic import (
        make_synthetic_bags)
    man, store = make_synthetic_bags(str(tmp_path / "p"), n_slides=6,
                                     feat_dim=16, seed=4)
    jman, jstore = jax_bags(str(tmp_path / "j"), n_slides=6, feat_dim=16,
                            seed=4)
    np.testing.assert_array_equal(man.labels, jman.labels)
    cfg = config.BagConfig(max_patches_per_slide=None)
    ds = bags.BagDataset(man.slide_ids, man.labels, store, cfg)
    jds = jbags.BagDataset(jman.slide_ids, jman.labels, jstore,
                           jconfig.BagConfig(max_patches_per_slide=None))
    assert len(ds) == 6 and ds.pad_size() == jds.pad_size()
    for s in man.slide_ids:
        np.testing.assert_array_equal(ds._full_bag(s), jds._full_bag(s))
        assert ds._full_bag(s) is ds._full_bag(s)  # cached
    assert store.exists(man.slide_ids[0]) and not store.exists("missing")
    with pytest.raises(FileNotFoundError):
        store.load_features("missing")


def test_reference_init_is_xavier_with_zero_bias():
    model = init_reference_weights(CLAM_SB("small", 2),
                                   seeding.torch_generator(0))
    fc = model.attention_net[0]
    assert not fc.bias.any()
    std = (2.0 / (1024 + 512)) ** 0.5
    assert abs(fc.weight.std().item() / std - 1) < 0.02
    again = init_reference_weights(CLAM_SB("small", 2),
                                   seeding.torch_generator(0))
    assert torch.equal(fc.weight, again.attention_net[0].weight)
