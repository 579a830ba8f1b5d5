"""The port's bag losses (hipt_abmil_atec23_tpu_torch/engine/losses.py)
held against the JAX package's on the same logits and labels: the three
bag losses (ce, balanced_ce with class weights, svm) and the per-slide
validation losses, within 1e-6 (f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.engine import losses as jl
from hipt_abmil_atec23_tpu_torch.engine import losses as pl

TOL = 1e-6
COUNTS = np.array([7, 2, 4])


def _inputs(n_classes, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(9, n_classes))).astype(np.float32)
    labels = rng.integers(0, n_classes, 9).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("name", ["ce", "balanced_ce", "svm"])
@pytest.mark.parametrize("n_classes", [2, 3])
def test_bag_loss_matches_jax(name, n_classes):
    """make_bag_loss: batch CE, class-weighted CE (torch's weighted mean),
    the smooth top-1 SVM."""
    logits, labels = _inputs(n_classes)
    counts = COUNTS[:n_classes]
    want = jl.make_bag_loss(name, counts)(jnp.asarray(logits),
                                          jnp.asarray(labels))
    got = pl.make_bag_loss(name, counts)(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["ce", "balanced_ce", "svm"])
def test_per_sample_loss_matches_jax(name):
    """make_per_sample_loss: the [B] validation loss (NLL for both CE
    kinds, the per-slide SVM)."""
    logits, labels = _inputs(3, seed=1)
    want = jl.make_per_sample_loss(name)(jnp.asarray(logits),
                                         jnp.asarray(labels))
    got = pl.make_per_sample_loss(name)(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_class_weights_and_unknown_names():
    """balanced_class_weights equals the JAX package's; balanced_ce without
    counts and unknown names raise ValueError."""
    np.testing.assert_array_equal(pl.balanced_class_weights(COUNTS),
                                  jl.balanced_class_weights(COUNTS))
    logits, labels = _inputs(3, seed=2)
    w = torch.from_numpy(pl.balanced_class_weights(COUNTS))
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(w.numpy()))
    got = pl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), w)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        pl.make_bag_loss("balanced_ce")
    for make in (pl.make_bag_loss, pl.make_per_sample_loss):
        with pytest.raises(ValueError):
            make("focal")
