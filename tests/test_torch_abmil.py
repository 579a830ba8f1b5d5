"""The port's CLAM_SB (hipt_abmil_atec23_tpu_torch/models/abmil.py) and bag
masking held against the JAX package on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import CLAM_SB as JaxCLAM
from hipt_abmil_atec23_tpu.models.convert import clam_params_to_torch
from hipt_abmil_atec23_tpu.ops import masking as jmask
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    CLAM_SB, MIL_SIZE_DICT, build_mil_model)
from hipt_abmil_atec23_tpu_torch.models.convert import (
    clam_state_dict_from_jax, clam_state_dict_from_torch)
from hipt_abmil_atec23_tpu_torch.ops.masking import masked_softmax, pad_bag


def _jax_clam(rng):
    model = JaxCLAM(size_arg="hipt_smaller", n_classes=2)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((8, 192)), None)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params)
    return model, params


def test_clam_sb_matches_jax_on_padded_bag(rng):
    """hipt_smaller on a padded, masked bag: logits, y_prob, a_raw."""
    model, params = _jax_clam(rng)
    feats = rng.normal(size=(75, 192)).astype(np.float32)
    bag, mask = pad_bag(feats, 128)
    want = model.apply(params, jnp.asarray(bag), jnp.asarray(mask))
    port = build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2)
    port.load_state_dict(clam_state_dict_from_jax(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(bag), torch.from_numpy(mask))
        a_only = port(torch.from_numpy(bag), attention_only=True)
    for g, w in ((got.logits, want.logits), (got.y_prob, want.y_prob),
                 (got.a_raw, want.a_raw), (a_only, want.a_raw)):
        assert tuple(g.shape) == tuple(np.asarray(w).shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    assert int(got.y_hat[0]) == int(np.asarray(want.y_hat)[0])


def test_clam_bridges_agree_with_jax_exporter(rng):
    """clam_state_dict_from_jax writes exactly the reference layout of the
    JAX package's clam_params_to_torch, and a reference checkpoint (with
    dropout index, '.module' wrappers, instance classifiers and loss
    buffers) cleans up to the same state dict."""
    _, params = _jax_clam(rng)
    ours = clam_state_dict_from_jax(params)
    ref = clam_params_to_torch(params)
    assert set(ours) == set(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy())
    messy = {k.replace("attention_net.2.", "attention_net.3.module."): v
             for k, v in clam_params_to_torch(params,
                                              with_dropout=False).items()}
    messy["instance_classifiers.0.weight"] = torch.zeros(2, 16)
    messy["instance_loss_fn.weight"] = torch.zeros(2)
    cleaned = clam_state_dict_from_torch(messy)
    assert set(cleaned) == set(ours)
    for k in ours:
        np.testing.assert_array_equal(cleaned[k].numpy(), ours[k].numpy())


def test_masked_softmax_and_pad_bag_match_jax(rng):
    s = rng.normal(size=(3, 40)).astype(np.float32)
    m = rng.random((3, 40)) > 0.3
    m[2] = False  # fully masked row -> zeros
    want = jmask.masked_softmax(jnp.asarray(s), jnp.asarray(m))
    got = masked_softmax(torch.from_numpy(s), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert np.all(got.numpy()[2] == 0)
    feats = rng.normal(size=(5, 4)).astype(np.float32)
    for a, b in zip(pad_bag(feats, 8), jmask.pad_bag(feats, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pad_bag(feats, 4)


def test_only_gated_clam_sb_is_built():
    """Every head type of the JAX package is built now (the name is from
    when only the gated CLAM_SB was): clam_mb and the ungated clam_sb too;
    an unknown type raises ValueError, as in the JAX package."""
    assert MIL_SIZE_DICT["hipt_smaller"] == [192, 16, 8]
    assert isinstance(build_mil_model("clam_sb"), CLAM_SB)
    assert build_mil_model("clam_mb").multi_branch
    assert not build_mil_model("clam_sb", gate=False).gate
    with pytest.raises(ValueError):
        build_mil_model("clam_xl")
