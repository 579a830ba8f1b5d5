"""The port's multi-device dry run (``hipt_abmil_atec23_tpu_torch.dryrun``)
on 2 and 4 gloo ranks, held part by part against the JAX package's dry run
(``__graft_entry__.py``) computed here on its CPU devices, with the same
numpy inputs and the JAX weights bridged by ``models/convert.py``:

1. fold-parallel lanes: bag losses within 1e-5, trained heads within 1e-5
   (every parameter but the gated scorer's output bias, whose gradient is
   zero and whose Adam steps are rounding noise, ROADMAP section C) and by
   their logits within 1e-5;
2. data-parallel HIPT features within 1e-4 of ``jax.jit(hipt.apply)``,
   and within 1e-6 of the port's own forward in one process;
3. sharded logits and scores within 1e-4;
4. the sequence-parallel step's loss and parameters within 1e-5 (the
   scorer bias again by the stepped head's logits);
5. the (host, fold) lanes as part 1 on part 5's inputs, and within 1e-6 of
   the same lanes stacked in one process.

Each world size spawns once (a module fixture); the dry run's ranks import
no jax. JAX's part 5 mesh is ``global_mesh(host_axis="host", n_hosts=2)``
as the dry run builds it on an n-device platform: the first n devices as
(2, n / 2).
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

from hipt_abmil_atec23_tpu_torch import dryrun as pdr

TOL = 1e-5
FEAT_TOL = 1e-4
POOL_TOL = 1e-4
SCORER_BIAS = "attention_c.bias"


def _jax_cfg():
    from hipt_abmil_atec23_tpu.utils.config import (
        BagConfig, ExperimentConfig, ModelConfig, TaskConfig, TrainConfig)
    return ExperimentConfig(
        task=TaskConfig(n_classes=2, label_dict={"0": 0, "1": 1}),
        bags=BagConfig(max_patches_per_slide=16, batch_size=2),
        model=ModelConfig(model_type="clam_sb", model_size="hipt_smaller"),
        train=TrainConfig(lr=1e-3, reg=1e-4, bag_loss="ce"))


def _lanes_to_torch(stacked, n):
    """Each lane's JAX head as the port's state dict (numpy)."""
    import jax
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax)
    return [{k: v.numpy() for k, v in mil_state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x[f]), stacked)).items()}
        for f in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX dry run's step functions and models, each jitted once for
    both world sizes (flax's eager init takes seconds here): (fold step
    functions, jitted head init, jitted vmapped epoch, HIPT4K and its
    variables, CLAM_SB and its params). No parameter depends on the
    length of the input it is initialised on."""
    import jax
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu.engine.train import build_step_fns
    from hipt_abmil_atec23_tpu.models import CLAM_SB
    from hipt_abmil_atec23_tpu.models.hipt import HIPT4K
    from hipt_abmil_atec23_tpu.models.vit import VIT_CONFIGS, ViT4KConfig

    fns = build_step_fns(_jax_cfg(), np.array([4, 4]), 16, 192)
    tiny256 = dataclasses.replace(VIT_CONFIGS["vit_small"], depth=2,
                                  embed_dim=128, num_heads=2)
    tiny4k = ViT4KConfig(input_embed_dim=128, output_embed_dim=64, depth=1,
                         num_heads=2)
    hipt = HIPT4K(vit256_config=tiny256, vit4k_config=tiny4k)
    hvars = jax.jit(hipt.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 256, 256, 3)))
    clam = CLAM_SB(size_arg="hipt_smaller", n_classes=2)
    p1 = jax.jit(clam.init)(jax.random.PRNGKey(0), jnp.zeros((32, 192)),
                            jnp.ones((32,), bool))
    return (fns, jax.jit(fns.init_params), jax.jit(jax.vmap(fns.train_epoch)),
            hipt, hvars, jax.jit(hipt.apply), clam, p1,
            jax.jit(clam.apply))


def _jax_init(n):
    """The JAX dry run's initial weights at n devices: (n stacked fold
    heads, the same as the port's state dicts in ``default_weights``'s
    layout)."""
    import jax
    import jax.numpy as jnp
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        hipt_state_dict_from_jax, mil_state_dict_from_jax)

    _, init, _, _, hvars, _, _, p1, _ = _jax_models()
    params = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[init(jax.random.PRNGKey(f)) for f in range(n)])
    tt = lambda sd: {k: torch.from_numpy(np.asarray(v)) for k, v in
                     sd.items()}
    return params, {"heads": [tt(h) for h in _lanes_to_torch(params, n)],
                    "hipt": tt(hipt_state_dict_from_jax(hvars)),
                    "clam": tt(mil_state_dict_from_jax(p1))}


def _jax_dryrun(n, params):
    """The JAX dry run's five parts at n devices on the port's inputs from
    its initial ``params`` (the stacked fold heads; the rest as
    ``_jax_models`` made them)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from hipt_abmil_atec23_tpu.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu.parallel.sharded_bag import (
        sharded_bag_train_step, sharded_clam_forward)

    fns, _, epoch, _, hvars, hipt_apply, _, p1, _ = _jax_models()
    inp = pdr.dryrun_inputs(n)
    devs = jax.devices()[:n]
    ekeys = jnp.stack([jax.random.PRNGKey(100 + f) for f in range(n)])

    def lanes(mesh, axes, feats, labels):
        put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, P(axes, *([None] * (np.ndim(a) - 1)))))
        p = jax.tree.map(put, params)
        new, _, bl, _, _ = epoch(p, jax.vmap(fns.tx.init)(p), put(feats),
                                 put(inp["mask"]), put(labels), ekeys)
        return np.asarray(bl), new

    want = {}
    want["part1"] = lanes(make_mesh([("fold", n)], devices=devs), "fold",
                          inp["feats"], inp["labels"])

    dp = make_mesh([("data", n)], devices=devs)
    regions = jax.device_put(jnp.asarray(inp["regions"]),
                             NamedSharding(dp, P("data")))
    want["part2"] = np.asarray(hipt_apply(hvars, regions))

    inst = make_mesh([("inst", n)], devices=devs)
    bag = jnp.asarray(inp["bag"])
    bmask = jnp.ones((len(bag),), bool)
    lg, a = jax.jit(lambda p: sharded_clam_forward(p, bag, bmask, inst))(p1)
    want["part3"] = (np.asarray(lg), np.asarray(a))
    tx = optax.adam(1e-3)
    p2, _, loss = jax.jit(lambda p, s: sharded_bag_train_step(
        p, s, tx, bag, bmask, 0, inst))(p1, tx.init(p1))
    want["part4"] = (float(loss), p2)

    if n % 2 == 0:
        mesh2 = Mesh(np.asarray(devs).reshape(2, -1), ("host", "fold"))
        want["part5"] = lanes(mesh2, ("host", "fold"), inp["feats5"],
                              inp["labels5"])
    return want


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    """(n, the bridged weights, the JAX results, each rank's results). The
    ranks run while this process computes the JAX side."""
    n = request.param
    params, weights = _jax_init(n)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pdr.dryrun_multichip, n, "cpu", weights=weights)
        want = _jax_dryrun(n, params)
        got = ranks.result()
    assert len(got) == n
    return n, weights, want, got


def _head_logits(sd, bag):
    """A CLAM_SB hipt_smaller head's logits on one bag."""
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    m = build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    with torch.no_grad():
        return m(torch.from_numpy(bag)).logits.numpy()


def _jax_logits(params, bag):
    import jax.numpy as jnp
    out = _jax_models()[-1](params, jnp.asarray(bag),
                            jnp.ones((len(bag),), bool))
    return np.asarray(out.logits)


def _check_lanes(got, want, n, bag):
    """Per-lane losses and heads (parameters but the scorer bias, and the
    logits on ``bag``) within TOL of the JAX lanes."""
    import jax
    bl, new = want
    np.testing.assert_allclose(got["loss"], bl, rtol=0, atol=TOL)
    for f, sd in enumerate(_lanes_to_torch(new, n)):
        assert set(sd) == set(got["heads"])
        for k, v in sd.items():
            if not k.endswith(SCORER_BIAS):
                np.testing.assert_allclose(got["heads"][k][f], v, rtol=0,
                                           atol=TOL, err_msg=k)
        lane = {k: v[f] for k, v in got["heads"].items()}
        np.testing.assert_allclose(
            _head_logits(lane, bag),
            _jax_logits(jax.tree.map(lambda x: x[f], new), bag),
            rtol=0, atol=TOL)


def test_part1_fold_lanes_match_jax(world):
    n, _, want, got = world
    bag = pdr.dryrun_inputs(n)["bag"][:64]
    for r in range(n):
        assert got[r]["part1"]["loss"].shape == (n,)
        _check_lanes(got[r]["part1"], want["part1"], n, bag)


def test_part2_data_parallel_features(world):
    """Every rank holds all n regions' features: the JAX package's within
    1e-4, and the port's own forward of all regions in one process."""
    from hipt_abmil_atec23_tpu_torch.models.hipt import HIPT4K
    n, tw, want, got = world
    model = HIPT4K(*pdr.hipt_configs()).eval()
    model.load_state_dict(tw["hipt"])
    with torch.no_grad():
        one = model(torch.from_numpy(pdr.dryrun_inputs(n)["regions"]))
    for r in range(n):
        feats = got[r]["part2"]["features"]
        assert feats.shape == (n, 64) and feats.dtype == np.float32
        np.testing.assert_allclose(feats, want["part2"], rtol=0,
                                   atol=FEAT_TOL)
        np.testing.assert_allclose(feats, one.numpy(), rtol=0, atol=1e-6)


def test_part3_sharded_forward_matches_jax(world):
    n, _, want, got = world
    lg, a = want["part3"]
    for r in range(n):
        p3 = got[r]["part3"]
        assert p3["logits"].shape == (1, 2) and p3["a_raw"].shape == (1, 32 * n)
        np.testing.assert_allclose(p3["logits"], lg, rtol=0, atol=POOL_TOL)
        np.testing.assert_allclose(p3["a_raw"], a, rtol=0, atol=POOL_TOL)
        assert p3["err"] <= POOL_TOL and p3["plain_err"] <= POOL_TOL


def test_part4_sequence_parallel_step_matches_jax(world):
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax)
    n, _, want, got = world
    loss, p2 = want["part4"]
    stepped = {k: v.numpy() for k, v in mil_state_dict_from_jax(p2).items()}
    bag = pdr.dryrun_inputs(n)["bag"][:64]
    for r in range(n):
        p4 = got[r]["part4"]
        assert abs(float(p4["loss"]) - loss) <= TOL
        # JAX's head has no instance classifiers before an instance_eval
        # call; the bag step does not touch the port's
        assert set(stepped) <= set(p4["state"])
        for k, v in stepped.items():
            if not k.endswith(SCORER_BIAS):
                np.testing.assert_allclose(p4["state"][k], v, rtol=0,
                                           atol=TOL, err_msg=k)
        np.testing.assert_allclose(_head_logits(p4["state"], bag),
                                   _jax_logits(p2, bag), rtol=0, atol=TOL)


def test_part5_two_axis_lanes(world):
    """The (host, fold) split: JAX's part 5 within 1e-5, and the port's
    lanes of one process (no mesh) on the same inputs within 1e-6."""
    from hipt_abmil_atec23_tpu_torch.dryrun import (
        experiment_config, fold_lanes_epoch)
    n, tw, want, got = world
    inp = pdr.dryrun_inputs(n)
    loss, heads = fold_lanes_epoch(
        experiment_config(), tw["heads"], inp["feats5"], inp["mask"],
        inp["labels5"], None, device=torch.device("cpu"))
    for r in range(n):
        p5 = got[r]["part5"]
        _check_lanes(p5, want["part5"], n, inp["bag"][:64])
        np.testing.assert_allclose(p5["loss"], loss.numpy(), rtol=0,
                                   atol=1e-6)
        for k, v in heads.items():
            np.testing.assert_allclose(p5["heads"][k], v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_odd_world_skips_part5(capsys):
    got = pdr.dryrun_multichip(3, "cpu")
    out = capsys.readouterr().out
    assert [g["part5"] for g in got] == [None] * 3
    assert "part 5 2-D host x fold train step: skipped" in out
    assert out.rstrip().endswith(
        "hipt_abmil_atec23_tpu_torch: dryrun_multichip(3) OK: fold-parallel "
        "train step + data-parallel HIPT encode + instance-sharded inference "
        "+ sequence-parallel train step + 2-D host x fold (DCN x ICI) train "
        "step")


class _TwoRankMesh:
    """A stand-in for a DeviceMesh whose ``data`` axis has two ranks."""
    mesh_dim_names = ("data",)

    def get_group(self, axis):
        return axis

    def size(self):
        return 2


def test_nondividing_regions_raise(monkeypatch):
    """Three regions over two ranks raise ValueError before any encoding
    or collective, as a NamedSharding of them would in JAX."""
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.models.hipt import HIPT4K
    from hipt_abmil_atec23_tpu_torch.parallel.data_parallel import (
        encode_data_parallel)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    model = HIPT4K(*pdr.hipt_configs())
    with pytest.raises(ValueError, match="3 .* do not divide over 2"):
        encode_data_parallel(model, torch.zeros(3, 256, 256, 3),
                             _TwoRankMesh())


def test_lanes_over_axes_the_mesh_lacks_raise(monkeypatch):
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.engine.stacked import lane_block
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="need a mesh of exactly"):
        lane_block(4, _TwoRankMesh(), ("host", "data"))


def test_entry_matches_jax(monkeypatch):
    """The port's entry() on the CPU (the plain path) against the JAX
    package's entry() with its XLA ViT path, from the JAX weights: the
    head's outputs within 1e-5, the bf16 ViT's CLS within 5e-2. flax's
    ``init`` runs jitted (eagerly it takes ~12 s here); both sides read
    the weights it returns."""
    import flax.linen as nn
    import jax
    from __graft_entry__ import entry as jax_entry
    eager = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, rng, *a: jax.jit(
        lambda r, *x: eager(self, r, *x))(rng, *a))
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax, vit256_state_dict_from_jax)
    jfn, jargs = jax_entry()
    want = [np.asarray(x, np.float32) for x in jax.jit(jfn)(*jargs)]
    fn, args = pdr.entry("cpu")
    model, vit = args[:2]
    model.load_state_dict(mil_state_dict_from_jax(jargs[0]))
    vit.load_state_dict(vit256_state_dict_from_jax(jargs[1]["params"]))
    assert not vit.cfg.use_fused_block and vit.cfg.dtype == torch.bfloat16
    got = [x.float().numpy() for x in fn(*args)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[3].shape == (8, 192)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[3], want[3], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", ["vit_tiny", "vit_small", "vit_base"])
def test_vit_configs_match_jax(name):
    from hipt_abmil_atec23_tpu.models.vit import VIT_CONFIGS as JAX_CONFIGS
    from hipt_abmil_atec23_tpu_torch.models.vit import VIT_CONFIGS
    fields = ("embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size")
    assert [getattr(VIT_CONFIGS[name], f) for f in fields] == \
        [getattr(JAX_CONFIGS[name], f) for f in fields]
