"""The port's checkpoint loader and MIL head defaults against the JAX
package's: every layout the JAX loader takes (DINO 'teacher' with stacked
'module.'/'backbone.' prefixes, a bare state dict, the Histo
{'state_dict': ...} wrapper with its 'model.'/'resnet.' prefixes, a
pickled module) loads to the same keys and values, and a head built with
no size_arg has the JAX head's widths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import CLAM_SB as JaxCLAM
from hipt_abmil_atec23_tpu.models import build_mil_model as jax_build
from hipt_abmil_atec23_tpu.models.convert import (
    load_torch_state_dict as jax_load)
from hipt_abmil_atec23_tpu_torch.models.abmil import CLAM_SB, build_mil_model
from hipt_abmil_atec23_tpu_torch.models.convert import load_torch_state_dict


def _tensors(rng, names):
    return {k: torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
            for k in names}


def _teacher(rng):
    # interior '.model.' and a 'model.' head prefix survive outside the
    # Histo layout; DINO wrappers may stack
    return {"teacher": _tensors(rng, [
        "module.backbone.blocks.0.attn.qkv.weight",
        "backbone.blocks.0.model.weight", "model.head.weight"]),
        "student": _tensors(rng, ["module.head.weight"])}, "teacher"


def _histo(rng):
    return {"state_dict": _tensors(rng, [
        "model.resnet.conv1.weight", "model.layer1.0.model.weight",
        "resnet.fc.weight", "module.bn1.weight"]), "epoch": 3}, None


def _pickled_module(rng):
    torch.manual_seed(int(rng.integers(1 << 30)))
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                               torch.nn.Linear(3, 2)), None


def _bare(rng):
    return _tensors(rng, ["module.attention_net.0.weight",
                          "classifiers.weight"]), None


@pytest.mark.parametrize("layout", [_teacher, _histo, _pickled_module,
                                    _bare])
def test_loader_matches_jax_loader(layout, tmp_path, rng):
    """Same keys, same f32 values as the JAX package's loader."""
    obj, key = layout(rng)
    path = str(tmp_path / "ckpt.pt")
    torch.save(obj, path)
    got = load_torch_state_dict(path, checkpoint_key=key)
    want = jax_load(path, checkpoint_key=key)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_histo_layout_strips_prefixes_only(tmp_path, rng):
    """In the {'state_dict': ...} layout the leading 'model.'/'resnet.'
    prefixes strip, stacked or not; an interior '.model.' stays."""
    obj, _ = _histo(rng)
    path = str(tmp_path / "h.ckpt")
    torch.save(obj, path)
    assert set(load_torch_state_dict(path, checkpoint_key=None)) == {
        "conv1.weight", "layer1.0.model.weight", "fc.weight", "bn1.weight"}


def test_mil_heads_default_to_the_jax_size(rng):
    """CLAM_SB and build_mil_model with no size_arg build the JAX
    package's default head ('small', 1024 -> 512 -> 256)."""
    feats = jnp.zeros((8, 1024), jnp.float32)
    for jmodel in (JaxCLAM(), jax_build("clam_sb")):
        p = jmodel.init(jax.random.PRNGKey(0), feats, None)["params"]
        want = sorted(tuple(a.shape) for a in jax.tree.leaves(p)
                      if a.ndim == 2)
        for port in (CLAM_SB(), build_mil_model("clam_sb")):
            got = sorted(tuple(w.t().shape) for k, w in
                         port.named_parameters() if w.dim() == 2
                         and not k.startswith("instance_classifiers."))
            assert port.size[:2] == [1024, 512] and got == want
