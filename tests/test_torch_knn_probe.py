"""The port's kNN probe (hipt_abmil_atec23_tpu_torch/engine/knn_probe.py) and
HIPT_LGP global aggregator (models/hipt_mil.py) held against the JAX
package's on the CPU.

- ``init_hipt_lgp_params`` draws the JAX package's numbers from one numpy
  Generator, so the checkpoint-free probe is one aggregator in both.
- ``hipt_lgp_aggregate`` within 1e-5 of the JAX package's from its params
  (bridged with ``hipt_lgp_state_dict_from_jax``) and from a torch-layout
  HIPT_LGP_FC state dict (the JAX package reads it with
  ``hipt_lgp_params_from_torch``; the port loads it as it is).
- ``_knn_vote`` within 1e-6, duplicated training rows (tied
  similarities) included, and ``knn_cv_probe`` for every ``--agg`` with
  the JAX package's AUC and accuracy.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.data.splits import generate_kfold_splits
from hipt_abmil_atec23_tpu.engine import knn_probe as jknn
from hipt_abmil_atec23_tpu.models import hipt_mil as jmil
from hipt_abmil_atec23_tpu_torch.engine import knn_probe as pknn
from hipt_abmil_atec23_tpu_torch.models import hipt_mil as pmil
from hipt_abmil_atec23_tpu_torch.models.convert import (
    hipt_lgp_state_dict_from_jax)

TOL = 1e-5


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_init_params_are_the_jax_packages():
    _tree_equal(pmil.init_hipt_lgp_params(np.random.default_rng(0)),
                jmil.init_hipt_lgp_params(np.random.default_rng(0)))


@pytest.mark.parametrize("n", [1, 7, 60])
def test_hipt_lgp_aggregate_from_jax_params(n):
    params = jmil.init_hipt_lgp_params(np.random.default_rng(0))
    feats = np.random.default_rng(n).normal(size=(n, 192)).astype(np.float32)
    want = np.asarray(jmil.hipt_lgp_aggregate(params, jnp.asarray(feats)))
    model = pmil.build_hipt_lgp(hipt_lgp_state_dict_from_jax(params),
                                device="cpu")
    got = pmil.hipt_lgp_aggregate(model, feats)
    assert got.shape == (192,) and not model.training
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # without a state dict: the same default_rng(0) weights
    again = pmil.hipt_lgp_aggregate(pmil.build_hipt_lgp(device="cpu"), feats)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_hipt_lgp_aggregate_from_a_torch_checkpoint():
    """A HIPT_LGP_FC state dict (the global branch among the local
    branch's keys, with non-zero biases and norms) loads by name in the
    port and through hipt_lgp_params_from_torch in the JAX package."""
    g = torch.Generator().manual_seed(3)
    src = pmil.HIPTGlobalAggregator()
    sd = {k: torch.randn(v.shape, generator=g) * 0.1
          for k, v in src.state_dict().items()}
    sd["local_phi.0.weight"] = torch.zeros(192, 384)
    feats = np.random.default_rng(4).normal(size=(40, 192)).astype(np.float32)
    want = np.asarray(jmil.hipt_lgp_aggregate(
        jmil.hipt_lgp_params_from_torch({k: v.numpy() for k, v in sd.items()}),
        jnp.asarray(feats)))
    got = pmil.hipt_lgp_aggregate(pmil.build_hipt_lgp(sd, device="cpu"),
                                  feats)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the reference's names, so the module itself loads the global branch
    names = set(src.state_dict())
    assert {"global_phi.0.weight", "global_attn_pool.attention_c.bias",
            "global_transformer.layers.1.self_attn.in_proj_weight",
            "global_rho.0.bias"} <= names
    with pytest.raises(KeyError, match="lacks"):
        pmil.build_hipt_lgp({"global_phi.0.weight": sd["global_phi.0.weight"]},
                            device="cpu")


def test_knn_vote_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    train = rng.normal(size=(30, 16)).astype(np.float32)
    train[10:20] = train[0]            # ten equal similarities per query
    labels = (np.arange(30) % 3).astype(np.int32)
    test = rng.normal(size=(12, 16)).astype(np.float32)
    test[0] = train[0] * 2.0
    for k, t in ((5, 1.0), (12, 0.07), (30, 0.5)):
        want = np.asarray(jknn._knn_vote(jnp.asarray(train),
                                         jnp.asarray(labels),
                                         jnp.asarray(test), k, 3, t))
        got = pknn._knn_vote(torch.from_numpy(train),
                             torch.from_numpy(labels.astype(np.int64)),
                             torch.from_numpy(test), k, 3, t)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(
        pknn.knn_classify(train, labels, test, k=50, n_classes=3,
                          device="cpu"),
        jknn.knn_classify(train, labels, test, k=50, n_classes=3), atol=1e-6)


@pytest.fixture(scope="module")
def probe_data():
    """30 seeded 192-d bags of 6, 20 or 35 regions (three shapes for the
    JAX package to compile), class 1 shifted."""
    rng = np.random.default_rng(6)
    labels = (np.arange(30) % 2).astype(np.int32)
    bags = {f"s{i}": (rng.normal(size=(int(rng.choice([6, 20, 35])), 192))
                      + 0.3 * labels[i]).astype(np.float32)
            for i in range(30)}
    store = types.SimpleNamespace(load_features=lambda sid: bags[sid])
    manifest = types.SimpleNamespace(slide_ids=np.array(list(bags)),
                                     labels=labels, n_classes=2)
    return store, manifest, generate_kfold_splits(labels, 3, seed=1)


@pytest.mark.parametrize("method", ["mean", "max", "hipt_lgp"])
def test_knn_cv_probe_matches_jax(probe_data, method):
    store, manifest, splits = probe_data
    want = jknn.knn_cv_probe(store, manifest, splits, k=7, method=method)
    got = pknn.knn_cv_probe(store, manifest, splits, k=7, method=method,
                            device="cpu")
    assert got.keys() == want.keys()
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    feats = pknn.aggregate_slide_features(store, manifest.slide_ids[:3],
                                          method, device="cpu")
    np.testing.assert_allclose(
        feats, jknn.aggregate_slide_features(store, manifest.slide_ids[:3],
                                             method), atol=TOL)


def test_probe_needs_a_card_unless_asked(probe_data):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    store, manifest, splits = probe_data
    with pytest.raises(RuntimeError, match="cuda"):
        pknn.knn_cv_probe(store, manifest, splits)
    with pytest.raises(ValueError):
        pknn.aggregate_slide_features(store, ["s0"], "median", device="cpu")


def test_knn_probe_near_ties_split_by_rounding(tmp_path):
    """Known behaviour (ROADMAP §C): with an N(0, 0.1) HIPT_LGP state dict
    the 12 slides' embeddings nearly coincide (pairwise cosine
    0.9995-0.9999). The packages' embeddings agree within 1e-5, but f32
    rounding then reorders neighbours whose similarities differ by ~1e-7,
    and the probe's accuracy can differ. Every neighbour that one package
    votes with and the other does not sits within 1e-6 of the k-th
    similarity."""
    from hipt_abmil_atec23_tpu_torch.data.synthetic import make_synthetic_bags
    manifest, store = make_synthetic_bags(str(tmp_path), n_slides=12,
                                          bag_range=(150, 260), signal=1.5,
                                          signal_fraction=0.4, seed=2)
    g = torch.Generator().manual_seed(1)
    sd = {k: torch.randn(v.shape, generator=g) * 0.1
          for k, v in pmil.HIPTGlobalAggregator().state_dict().items()}
    ids = list(manifest.slide_ids)
    # 150 regions per slide: one shape for the JAX package to compile
    store = types.SimpleNamespace(
        load_features=lambda sid, f=store.load_features: f(sid)[:150])
    got = pknn.aggregate_slide_features(store, ids, "hipt_lgp", sd,
                                        device="cpu")
    want = jknn.aggregate_slide_features(
        store, ids, "hipt_lgp", jmil.hipt_lgp_params_from_torch(
            {k: v.numpy() for k, v in sd.items()}))
    np.testing.assert_allclose(got, want, atol=TOL)
    unit = got / np.linalg.norm(got, axis=1, keepdims=True)
    sim = unit.astype(np.float64) @ unit.T.astype(np.float64)
    assert sim[~np.eye(12, dtype=bool)].min() > 0.999
    labels = manifest.labels
    for train_idx, _, test_idx in generate_kfold_splits(labels, 3, seed=1):
        k = min(5, len(train_idx))   # the probe's k, as the CLI's --k 5
        s = sim[np.ix_(test_idx, train_idx)]
        pt = torch.sort(torch.from_numpy(
            (got[test_idx] / np.linalg.norm(got[test_idx], axis=1,
                                            keepdims=True))
            @ (got[train_idx] / np.linalg.norm(got[train_idx], axis=1,
                                               keepdims=True)).T),
            dim=1, descending=True, stable=True).indices[:, :k].numpy()
        jt = np.asarray(jax.lax.top_k(jnp.asarray(
            (want[test_idx] / np.linalg.norm(want[test_idx], axis=1,
                                             keepdims=True))
            @ (want[train_idx] / np.linalg.norm(want[train_idx], axis=1,
                                                keepdims=True)).T), k)[1])
        for row, (a, b) in enumerate(zip(pt, jt)):
            kth = np.sort(s[row])[::-1][k - 1]
            for j in set(a) ^ set(b):
                assert abs(s[row, j] - kth) < 1e-6, (row, j)
