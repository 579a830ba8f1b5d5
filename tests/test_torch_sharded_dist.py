"""The port's instance-sharded MIL (parallel/) across 2 and 4 gloo ranks on
the CPU, held against the JAX package's sharded path on its 8-device CPU
mesh with the same weights: the forward (plain and through the partial
pooling), one training step's gradients and Adam update, and two epochs of
the full-bag trainer.

The JAX side runs in the test process; the ranks are spawned processes
that import no jax (this module imports it only inside functions) and get
numpy inputs and weights through a pickle file. Each world size spawns once
(a module fixture); the tests then compare what the ranks wrote.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, D = 512, 192
LABEL = 1
WIDTHS = ["hipt_smaller", "small"]


def _mask():
    """A tail of padding and a masked block that leaves whole shards
    without a valid row at 4 and 8 ranks."""
    i = np.arange(N)
    return (i < 480) & ~((i >= 128) & (i < 256))


def _rows(x, rank, world):
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def _worker(rank, world, store_path, in_path, out_dir):
    """One rank: the sharded forward at each width, one train step, two
    epochs of the full-bag trainer; results pickled per rank."""
    from hipt_abmil_atec23_tpu_torch.data.bags import (
        BagDataset, FeatureBagStore)
    from hipt_abmil_atec23_tpu_torch.models.abmil import CLAM_SB
    from hipt_abmil_atec23_tpu_torch.parallel import full_bag_train as fbt
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.sharded_bag import (
        sharded_bag_train_step, sharded_clam_forward)
    from hipt_abmil_atec23_tpu_torch.utils import config

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh([("inst", world)], "cpu")
        bag = torch.from_numpy(_rows(inp["bag"], rank, world))
        mask = torch.from_numpy(_rows(_mask(), rank, world))
        out = {"forward": {}}
        for width in WIDTHS:
            model = CLAM_SB(width, 2)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   inp["params"][width].items()})
            b = torch.from_numpy(_rows(inp["bags"][width], rank, world))
            for fused in (False, True):
                with torch.no_grad():
                    lg, a = sharded_clam_forward(model, b, mask, mesh,
                                                 use_fused=fused)
                out["forward"][width, fused] = (lg.numpy(), a.numpy())

        model = CLAM_SB("hipt_smaller", 2)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               inp["params"]["hipt_smaller"].items()})
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        loss = sharded_bag_train_step(model, opt, bag, mask, LABEL, mesh)
        out["loss"] = float(loss)
        # the bag loss reaches every parameter but the (reference-layout)
        # instance classifiers, which the test holds to JAX's keys below
        out["grads"] = {k: p.grad.numpy().copy()
                        for k, p in model.named_parameters()
                        if p.grad is not None}
        out["stepped"] = {k: v.numpy().copy()
                          for k, v in model.state_dict().items()
                          if not k.startswith("instance_classifiers.")}

        init = {k: torch.from_numpy(v) for k, v in inp["init"].items()}
        fbt.init_reference_weights = lambda m, g: m.load_state_dict(init)
        store = FeatureBagStore(inp["bag_dir"])
        cfg = config.ExperimentConfig.from_dict(inp["cfg"])
        ids, labels = inp["slide_ids"], inp["labels"]
        mk = lambda sel: BagDataset([ids[i] for i in sel], labels[list(sel)],
                                    store, cfg.bags)
        _, out["history"] = fbt.train_full_bags_sharded(
            cfg, mk(range(6)), mk(range(6, 10)), mesh, verbose=False)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# the full-bag trainer's configuration, for both packages' from_dict
CFG = {"task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
       "bags": {"max_patches_per_slide": None},
       "model": {"model_type": "clam_sb", "model_size": "hipt_smaller"},
       "train": {"lr": 2e-3, "max_epochs": 2, "seed": 0}}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Inputs, weights and the JAX package's sharded results."""
    import jax
    import jax.numpy as jnp
    import optax
    from hipt_abmil_atec23_tpu.data.bags import BagDataset
    from hipt_abmil_atec23_tpu.data.synthetic import make_synthetic_bags
    from hipt_abmil_atec23_tpu.models import CLAM_SB
    from hipt_abmil_atec23_tpu.parallel.full_bag_train import (
        train_full_bags_sharded)
    from hipt_abmil_atec23_tpu.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu.parallel.sharded_bag import (
        sharded_bag_train_step, sharded_clam_forward, sharded_clam_loss)
    from hipt_abmil_atec23_tpu.utils.config import ExperimentConfig
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        clam_state_dict_from_jax)
    from test_torch_sharded_bag import _interpret

    rng = np.random.default_rng(0)
    mesh = make_mesh([("inst", 8)])
    mask = jnp.asarray(_mask())
    to_np = lambda tree: {k: v.numpy() for k, v in
                          clam_state_dict_from_jax(tree).items()}
    inp = {"bags": {}, "params": {}}
    want = {"forward": {}}
    for width in WIDTHS:
        d_in = 1024 if width == "small" else D
        bag = rng.normal(size=(N, d_in)).astype(np.float32)
        model = CLAM_SB(size_arg=width, n_classes=2)
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(bag), None)
        params = jax.tree.map(
            lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
            params)
        inp["bags"][width], inp["params"][width] = bag, to_np(params)
        for fused in (False, True):
            fwd = lambda: sharded_clam_forward(params, jnp.asarray(bag), mask,
                                               mesh, use_fused=fused)
            lg, a = _interpret(fwd) if fused else fwd()
            want["forward"][width, fused] = (np.asarray(lg), np.asarray(a))
        if width == "hipt_smaller":
            inp["bag"], smaller = bag, (model, params)

    model, params = smaller
    bag = jnp.asarray(inp["bag"])
    # jitted: op by op, the gradient through shard_map takes ~10 s here
    want["grads"] = to_np(jax.jit(lambda p: jax.grad(sharded_clam_loss)(
        p, bag, mask, LABEL, mesh))(params))
    tx = optax.adam(1e-3)
    p1, _, loss = jax.jit(lambda p, s: sharded_bag_train_step(
        p, s, tx, bag, mask, LABEL, mesh))(params, tx.init(params))
    want["stepped"], want["loss"] = to_np(p1), float(loss)

    bag_dir = str(tmp_path_factory.mktemp("bags"))
    manifest, store = make_synthetic_bags(bag_dir, n_slides=10, feat_dim=D,
                                          signal=1.5, signal_fraction=0.4,
                                          bag_range=(40, 300), seed=9)
    cfg = ExperimentConfig.from_dict(CFG)
    ids = list(manifest.slide_ids)
    mk = lambda sel: BagDataset([ids[i] for i in sel],
                                manifest.labels[list(sel)], store, cfg.bags)
    init = CLAM_SB(size_arg="hipt_smaller", n_classes=2).init(
        jax.random.PRNGKey(cfg.train.seed), jnp.zeros((8, D)), None)
    _, want["history"] = train_full_bags_sharded(
        cfg, mk(range(6)), mk(range(6, 10)), mesh, verbose=False)
    inp.update(init=to_np(init), bag_dir=bag_dir, slide_ids=ids,
               labels=np.asarray(manifest.labels), cfg=CFG)
    return inp, want


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, jax_side, tmp_path_factory):
    """What each of ``world`` gloo ranks computed, and the world size."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"world{world}")
    in_path = str(tmp / "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(jax_side[0], f)
    mp.spawn(_worker, args=(world, str(tmp / "store"), in_path, str(tmp)),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return world, out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_sharded_forward_matches_jax(ranks, jax_side, width, fused):
    """Logits and raw scores on every rank equal the JAX package's sharded
    forward (8 devices) at test_parallel.py's tolerances; fused=True runs
    the partial pooling on each shard, some shards without a valid row."""
    world, out = ranks
    lg_want, a_want = jax_side[1]["forward"][width, fused]
    valid = _mask()
    for r in range(world):
        lg, a = out[r]["forward"][width, fused]
        assert lg.shape == (1, 2) and a.shape == (1, N)
        np.testing.assert_allclose(lg, lg_want, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(a[0, valid], a_want[0, valid], rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(lg, out[0]["forward"][width, fused][0])


def test_train_step_gradients_match_jax_and_unsharded(ranks, jax_side):
    """After the gradient sum every rank holds the JAX package's sharded
    gradient and the port's own unsharded gradient (no factor of the world
    size), and one Adam step keeps the ranks in lockstep with JAX's step."""
    from hipt_abmil_atec23_tpu_torch.models.abmil import CLAM_SB

    world, out = ranks
    inp, want = jax_side
    model = CLAM_SB("hipt_smaller", 2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           inp["params"]["hipt_smaller"].items()})
    logits = model(torch.from_numpy(inp["bag"]),
                   torch.from_numpy(_mask())).logits
    (-torch.log_softmax(logits[0], -1)[LABEL]).backward()
    for r in range(world):
        assert out[r]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert set(out[r]["grads"]) == set(want["grads"])
        for k, g in out[r]["grads"].items():
            # atol absorbs f32 noise on the analytically zero attn_c bias
            np.testing.assert_allclose(g, want["grads"][k], rtol=5e-4,
                                       atol=1.5e-3)
            np.testing.assert_allclose(
                g, dict(model.named_parameters())[k].grad.numpy(),
                rtol=1e-4, atol=1e-6)
            np.testing.assert_array_equal(g, out[0]["grads"][k])
        for k, p in out[r]["stepped"].items():
            # Adam's first step is ~lr sign(g): one lr quantum on that bias
            np.testing.assert_allclose(p, want["stepped"][k], rtol=5e-3,
                                       atol=1.5e-3)


def test_full_bag_training_matches_jax(ranks, jax_side):
    """Two epochs of train_full_bags_sharded from the JAX trainer's initial
    weights follow its history: the same epoch order, train and val losses
    within 1e-3, the same val AUC."""
    world, out = ranks
    want = jax_side[1]["history"]
    for r in range(world):
        got = out[r]["history"]
        assert [h["epoch"] for h in got] == [0, 1]
        for g, w in zip(got, want):
            for key in ("train_loss", "val_loss"):
                assert g[key] == pytest.approx(w[key], rel=1e-3), key
            assert g["val_auc"] == pytest.approx(w["val_auc"], abs=1e-9)
        assert got == out[0]["history"]


def test_init_multihost_forms_a_group_of_one():
    """No launcher, no arguments: a gloo group of one on the CPU, the mesh
    helpers over it, and a size mismatch refused."""
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import (
        global_mesh, init_multihost)

    assert not dist.is_initialized()
    try:
        assert init_multihost(device="cpu") == 1
        assert dist.get_backend() == "gloo"
        assert init_multihost(device="cpu") == 1  # the group is kept
        assert global_mesh("inst").mesh_dim_names == ("inst",)
        two = global_mesh("inst", host_axis="host", n_hosts=1)
        assert two.mesh_dim_names == ("host", "inst")
        assert make_mesh(None, "cpu").mesh_dim_names == ("fold",)
        with pytest.raises(ValueError):
            make_mesh([("inst", 2)], "cpu")
    finally:
        dist.destroy_process_group()
