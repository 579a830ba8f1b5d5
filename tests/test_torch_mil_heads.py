"""Every MIL head of the port (hipt_abmil_atec23_tpu_torch/models/abmil.py)
held against the JAX package's on the same weights and bags.

Weights: the JAX head's init, perturbed with seeded noise, carried across
with ``mil_state_dict_from_jax``. Bags: seeded normal features, padded and
masked. Tolerance: 1e-5 (rtol and atol, f32) on logits, y_prob, a_raw,
instance_loss and features; the instance predictions, targets and
validity must be equal. Scores are continuous, so the top-k ties that
``lax.top_k`` and ``torch.topk`` may order differently do not occur."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu.models import build_mil_model as jax_build
from hipt_abmil_atec23_tpu.models.convert import clam_params_to_torch
from hipt_abmil_atec23_tpu.ops import masking as jmask
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    CLAM_MB, CLAM_SB, MIL_fc, MIL_fc_mc, build_mil_model)
from hipt_abmil_atec23_tpu_torch.models.convert import (
    mil_state_dict_from_jax, mil_state_dict_from_torch)
from hipt_abmil_atec23_tpu_torch.ops.masking import (
    masked_bottom_k, masked_top_k, pad_bag)

TOL = 1e-5

# (model_type, size, n_classes, gate, subtyping)
HEADS = [("clam_sb", "hipt_smaller", 2, True, False),
         ("clam_sb", "hipt_smaller", 2, False, False),
         ("clam_sb", "hipt_small", 3, True, True),
         ("clam_mb", "hipt_small", 3, True, True),
         ("clam_mb", "hipt_smaller", 3, False, True),
         ("mil", "small", 2, True, False),
         ("mil", "small", 3, True, False)]


def _pair(model_type, size, n_classes, gate, subtyping, seed=0):
    """A JAX head with perturbed init params and the port's head loaded
    from them."""
    kw = dict(size_arg=size, n_classes=n_classes, gate=gate,
              subtyping=subtyping, k_sample=4)
    jm = jax_build(model_type, **kw)
    d_in = 1024 if model_type == "mil" else 192
    init_kw = {} if model_type == "mil" else dict(label=jnp.array(0),
                                                  instance_eval=True)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((16, d_in)), None,
                     **init_kw)
    rng = np.random.default_rng(seed + 1)
    # small enough that no instance probability saturates to a tie
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.normal(size=a.shape).astype(np.float32),
        params)
    port = build_mil_model(model_type, **kw)
    port.load_state_dict(mil_state_dict_from_jax(params, model_type,
                                                 n_classes))
    return jm, params, port, d_in


def _bag(d_in, n=40, n_pad=48, seed=2):
    feats = np.random.default_rng(seed).normal(size=(n, d_in)).astype(
        np.float32)
    return pad_bag(feats, n_pad)


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head", HEADS, ids=lambda h: "-".join(map(str, h)))
def test_head_matches_jax(head):
    """Logits, y_prob, y_hat and a_raw of the deterministic forward; for
    the CLAM heads also instance_eval with each label (instance_loss and
    the instance preds / targets / valid) and return_features, and
    attention_only."""
    model_type, _, n_classes, *_ = head
    jm, params, port, d_in = _pair(*head)
    bag, mask = _bag(d_in)
    tb, tm = torch.from_numpy(bag), torch.from_numpy(mask)
    clam = model_type != "mil"
    apply = jax.jit(jm.apply, static_argnames=(
        "instance_eval", "return_features", "attention_only"))
    for label in range(n_classes) if clam else [None]:
        kw = dict(label=label, instance_eval=True, return_features=True) \
            if clam else {}
        want = apply(params, jnp.asarray(bag), jnp.asarray(mask),
                     **({**kw, "label": jnp.array(label)} if clam else {}))
        with torch.no_grad():
            got = port(tb, tm, **kw)
        for g, w in ((got.logits, want.logits), (got.y_prob, want.y_prob),
                     (got.a_raw, want.a_raw)):
            _close(g, w)
        assert got.y_hat.tolist() == np.asarray(want.y_hat).tolist()
        if not clam:
            continue
        _close(got.extras["instance_loss"], want.extras["instance_loss"])
        _close(got.extras["features"], want.extras["features"])
        valid = np.asarray(want.extras["inst_valid"])
        np.testing.assert_array_equal(got.extras["inst_valid"].numpy(), valid)
        np.testing.assert_array_equal(got.extras["inst_labels"].numpy(),
                                      np.asarray(want.extras["inst_labels"]))
        np.testing.assert_array_equal(
            got.extras["inst_preds"].numpy()[valid],
            np.asarray(want.extras["inst_preds"])[valid])
    if clam:
        with torch.no_grad():
            a_only = port(tb, tm, attention_only=True)
        _close(a_only, apply(params, jnp.asarray(bag), jnp.asarray(mask),
                             attention_only=True))


def test_batched_forward_is_the_per_bag_forward():
    """A batch [B, N, D] with per-bag labels gives each bag's own forward:
    logits, a_raw and instance_loss per row."""
    _, _, port, d_in = _pair("clam_mb", "hipt_small", 3, True, True)
    bags, masks = zip(*[_bag(d_in, n=n, seed=s)
                        for n, s in ((40, 3), (17, 4), (48, 5))])
    labels = torch.tensor([2, 0, 1])
    with torch.no_grad():
        out = port(torch.from_numpy(np.stack(bags)),
                   torch.from_numpy(np.stack(masks)), label=labels,
                   instance_eval=True)
        for i in range(3):
            one = port(torch.from_numpy(bags[i]), torch.from_numpy(masks[i]),
                       label=int(labels[i]), instance_eval=True)
            _close(out.logits[i:i + 1], one.logits)
            _close(out.a_raw[i], one.a_raw)
            _close(out.extras["instance_loss"][i], one.extras["instance_loss"])


def test_dropout_is_seeded_and_keeps_its_rate():
    """Dropout draws from the generator it is given: one seed, one forward;
    another seed, another. A training forward with p = 0.5 zeroes about
    half of the projected instances and scales the rest by 2 (the layout
    moves the scorer to attention_net.3)."""
    port = build_mil_model("clam_sb", size_arg="hipt_smaller", dropout=0.5)
    assert set(port.state_dict()) >= {"attention_net.3.attention_c.weight"}
    bag = torch.randn(64, 192, generator=torch.Generator().manual_seed(0))
    run = lambda s: port(bag, deterministic=False,
                         generator=torch.Generator().manual_seed(s)).logits
    with torch.no_grad():
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))
        # the rate over ~32k projected instances (the head's init comes
        # from the global generator, so a 64-row bag's ~500 left the
        # estimate at the tolerance's edge for some inits)
        big = torch.randn(4096, 192,
                          generator=torch.Generator().manual_seed(4))
        h = torch.relu(port.attention_net[0](big))
        d = port.attention_net[2](h, True,
                                  torch.Generator().manual_seed(3))
        kept = (d != 0) & (h != 0)
        assert abs(kept.sum().item() / (h != 0).sum().item() - 0.5) < 0.05
        torch.testing.assert_close(d[kept], 2 * h[kept])
        assert torch.equal(port(bag).logits, port(bag).logits)


def test_masked_top_k_matches_jax(rng):
    """Values, indices and validity of the k largest / smallest valid
    scores on a batch with padding, and with fewer valid entries than k
    (the padded slots come back invalid)."""
    s = rng.normal(size=(3, 30)).astype(np.float32)
    m = rng.random((3, 30)) > 0.4
    m[2] = False
    m[2, :3] = True
    for port_fn, jax_fn in ((masked_top_k, jmask.masked_top_k),
                            (masked_bottom_k, jmask.masked_bottom_k)):
        got = port_fn(torch.from_numpy(s), torch.from_numpy(m), 5)
        want = jax_fn(jnp.asarray(s), jnp.asarray(m), 5)
        valid = np.asarray(want[2])
        np.testing.assert_array_equal(got[2].numpy(), valid)
        np.testing.assert_array_equal(got[1].numpy()[valid],
                                      np.asarray(want[1])[valid])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]))
        assert valid[2].sum() == 3


@pytest.mark.parametrize("multi_branch,with_dropout",
                         [(False, False), (True, True)])
def test_pt_loader_reads_the_jax_export(multi_branch, with_dropout):
    """A JAX CLAM exported by ``clam_params_to_torch`` (reference layout,
    instance classifiers, with or without the dropout index) loads through
    ``mil_state_dict_from_torch`` into the port's head of either build,
    instance classifiers kept, and gives the JAX forward."""
    model_type = "clam_mb" if multi_branch else "clam_sb"
    jm, params, _, d_in = _pair(model_type, "hipt_smaller", 2, True, False,
                                seed=4)
    sd = clam_params_to_torch(params, multi_branch=multi_branch,
                              with_dropout=with_dropout)
    sd["instance_loss_fn.weight"] = torch.zeros(2)
    bag, mask = _bag(d_in, seed=5)
    want = jm.apply(params, jnp.asarray(bag), jnp.asarray(mask),
                    label=jnp.array(1), instance_eval=True)
    for dropout in (0.0, 0.25):
        port = build_mil_model(model_type, size_arg="hipt_smaller",
                               k_sample=4, dropout=dropout)
        port.load_state_dict(mil_state_dict_from_torch(
            sd, with_dropout=dropout > 0, keep_instance=True))
        with torch.no_grad():
            got = port(torch.from_numpy(bag), torch.from_numpy(mask),
                       label=1, instance_eval=True)
        _close(got.logits, want.logits)
        _close(got.extras["instance_loss"], want.extras["instance_loss"])


def test_pt_loader_moves_indexed_slots():
    """The ungated scorer's last Linear and MIL_fc's classifier sit behind
    a Dropout slot: a dropout build's checkpoint loads into a plain build
    and back, with the same forward."""
    for model_type, size in (("clam_sb", "hipt_smaller"), ("mil", "small")):
        kw = dict(size_arg=size, gate=False)
        drop = build_mil_model(model_type, dropout=0.5, **kw)
        plain = build_mil_model(model_type, **kw)
        plain.load_state_dict(mil_state_dict_from_torch(
            drop.state_dict(), keep_instance=True))
        again = build_mil_model(model_type, dropout=0.5, **kw)
        again.load_state_dict(mil_state_dict_from_torch(
            plain.state_dict(), with_dropout=True, keep_instance=True))
        bag = torch.randn(20, plain.size[0])
        with torch.no_grad():
            for m in (plain, again):
                torch.testing.assert_close(m(bag).logits, drop(bag).logits)


def test_build_mil_model_dispatch():
    """JAX's dispatch: the CLAM types, MIL_fc for two classes and MIL_fc_mc
    past two; an unknown type raises ValueError."""
    assert isinstance(build_mil_model("clam_sb"), CLAM_SB)
    assert isinstance(build_mil_model("clam_mb"), CLAM_MB)
    assert isinstance(build_mil_model("mil"), MIL_fc)
    assert isinstance(build_mil_model("mil", n_classes=4), MIL_fc_mc)
    with pytest.raises(ValueError, match="unknown model_type"):
        build_mil_model("transmil")
