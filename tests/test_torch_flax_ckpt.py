"""The port's flax checkpoint format (engine/flax_ckpt.py, no flax or
msgpack inside) and the CLI's ``export``, held against flax and the JAX
package on the CPU.

- The writer gives ``flax.serialization.to_bytes``'s bytes, and the reader
  ``msgpack_restore``'s tree (keys in order, dtypes, values), for the
  CLAM_SB, CLAM_MB and MIL heads' parameters and a (params, optax state,
  epoch) train state; a malformed file raises ValueError.
- ``mil_params_to_jax`` inverts ``mil_state_dict_from_jax``: a JAX head
  through the port's layout and back writes the JAX file byte for byte.
- ``export`` writes the JAX CLI's ``.pt`` (the same keys in order, the
  same tensors) for CLAM_SB and CLAM_MB, with and without dropout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from hipt_abmil_atec23_tpu import cli as jcli
from hipt_abmil_atec23_tpu.engine.checkpoint import save_params as jax_save
from hipt_abmil_atec23_tpu.models import build_mil_model as jax_build
from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.engine import flax_ckpt
from hipt_abmil_atec23_tpu_torch.models.convert import (
    mil_params_to_jax, mil_state_dict_from_jax)

HEADS = [("clam_sb", "hipt_smaller", 2), ("clam_mb", "hipt_smaller", 3),
         ("mil", "small", 2), ("mil", "small", 3)]


def _jax_params(model_type, size, n_classes, seed=0, gate=True):
    m = jax_build(model_type, size_arg=size, n_classes=n_classes, gate=gate)
    d = 1024 if model_type == "mil" else 192
    kw = dict(label=jnp.array(0), instance_eval=True) \
        if model_type != "mil" else {}
    return m.init(jax.random.PRNGKey(seed), jnp.zeros((8, d)), None, **kw)


def _numpy_tree(t):
    """A tree with every jax array as numpy, in the tree's own key order."""
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return np.asarray(t) if isinstance(t, jax.Array) else t


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
        return
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model_type,size,n_classes", HEADS)
def test_writer_and_reader_match_flax(model_type, size, n_classes):
    params = _jax_params(model_type, size, n_classes)
    want = serialization.to_bytes(params)
    assert flax_ckpt.to_bytes(_numpy_tree(params)) == want
    _assert_same_tree(flax_ckpt.from_bytes(want),
                      serialization.msgpack_restore(want))


def test_train_state_matches_flax():
    """The JAX package's save_train_state payload: params, an optax
    chain's state (tuples and namedtuples as index / field maps, an int32
    count), the epoch; plus the scalar kinds msgpack has."""
    params = _jax_params("clam_sb", "hipt_smaller", 2)
    tx = optax.chain(optax.add_decayed_weights(1e-3), optax.adam(1e-3))
    payload = {"params": params, "opt_state": tx.init(params), "epoch": 7,
               "loss": 0.25, "scale": np.float32(2.5), "step": -300,
               "big": 2 ** 40, "done": True, "none": None,
               "name": "x" * 40}
    want = serialization.to_bytes(payload)
    assert flax_ckpt.to_bytes(_numpy_tree(
        serialization.to_state_dict(payload))) == want
    _assert_same_tree(flax_ckpt.from_bytes(want),
                      serialization.msgpack_restore(want))


def test_reader_refuses_malformed_files():
    """A file cut short, with bytes after its object, or holding an ext
    type flax does not write raises ValueError."""
    good = serialization.to_bytes(_jax_params("clam_sb", "hipt_smaller", 2))
    for bad, match in ((good[:-5], "truncated"),
                       (good + b"\x00", "trailing"),
                       (b"\xd4\x07\x00", "ext type 7")):
        with pytest.raises(ValueError, match=match):
            flax_ckpt.from_bytes(bad)


@pytest.mark.parametrize(
    "model_type,size,n_classes,gate",
    [h + (True,) for h in HEADS] + [("clam_sb", "hipt_smaller", 2, False),
                                    ("clam_mb", "hipt_smaller", 3, False)])
def test_params_round_trip_through_the_port(model_type, size, n_classes,
                                            gate):
    """JAX params -> the port's state dict -> the JAX tree again: the
    same file as the JAX package's save_params, gated and ungated CLAM
    heads and both MIL heads."""
    params = _jax_params(model_type, size, n_classes, seed=3, gate=gate)
    sd = mil_state_dict_from_jax(params, model_type, n_classes)
    assert flax_ckpt.to_bytes(mil_params_to_jax(sd, model_type, n_classes)) \
        == serialization.to_bytes(params)


@pytest.mark.parametrize("drop_out", [0.0, 0.25])
@pytest.mark.parametrize("model_type,n_classes",
                         [("clam_sb", 2), ("clam_mb", 3)])
def test_export_matches_jax(model_type, n_classes, drop_out, tmp_path):
    params = _jax_params(model_type, "hipt_smaller", n_classes, seed=1)
    ckpt = str(tmp_path / "s_0_checkpoint.msgpack")
    jax_save(ckpt, params)
    args = ["export", "--ckpt", ckpt, "--model_type", model_type,
            "--n_classes", str(n_classes), "--drop_out", str(drop_out)]
    assert jcli.main(args + ["--out", str(tmp_path / "jax.pt")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "port.pt"),
                            "--device", "cpu"]) == 0
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
