"""The single-card entry check and the multi-device dry run.

Counterpart of ``__graft_entry__.py`` (``entry`` :7-57,
``dryrun_multichip`` :63-210) on ``torch.distributed``: one process per
device (NCCL between cards, one card per rank; gloo between CPU
processes) where the JAX package spreads one program over a mesh.

- ``entry(device)`` returns ``(fn, args)``: CLAM_SB ``hipt_smaller`` on a
  75-row bag padded to 80, and a ``vit_tiny`` ViT cut to depth 2 in bf16
  on 8 images of 64², every block the fused block kernel on a card (its
  tokens pad 17 -> 24), the plain path on the CPU.
- ``dryrun_multichip(n, device)`` spawns n ranks and runs the JAX dry
  run's five parts at its sizes and configurations: (1) fold-parallel
  training as stacked lanes over a ``fold`` mesh, one lane per rank, one
  epoch of 2 steps; (2) data-parallel HIPT encoding over a ``data`` mesh,
  on a card through the fused block kernel and held against the same
  model's plain blocks; (3) the instance-sharded CLAM forward over an
  ``inst`` mesh, on a card through the partial pooling kernel, held with
  ``apply_pooled`` on the whole bag against the pool's plain version; (4)
  one sequence-parallel Adam step; (5) for even n, part 1's lanes split
  over both axes of a 2-D (host, fold) mesh. Inputs are drawn from numpy
  in the JAX dry run's order (``dryrun_inputs``).

    python -m hipt_abmil_atec23_tpu_torch.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import pickle
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

N_PAD, FEAT_DIM, STEPS, BATCH = 16, 192, 2, 2   # part 1 (JAX :105-116)
INST_ROWS = 32                                   # part 3 rows per rank
REGION = 256                                     # part 2 region side
POOL_TOL = 1e-4    # f32 logits and scores of the pool against its plain
BLOCK_TOL = (3e-2, 5e-2)   # |fused - plain blocks| <= atol + rtol |plain|
OK_LINE = ("dryrun_multichip({n}) OK: fold-parallel train step + "
           "data-parallel HIPT encode + instance-sharded inference + "
           "sequence-parallel train step + 2-D host x fold (DCN x ICI) "
           "train step")


def log(*a):
    print("[dryrun]", *a, flush=True)


def experiment_config():
    """The fold-parallel configuration of the JAX dry run (:105-109)."""
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        BagConfig, ExperimentConfig, ModelConfig, TaskConfig, TrainConfig)
    return ExperimentConfig(
        task=TaskConfig(n_classes=2, label_dict={"0": 0, "1": 1}),
        bags=BagConfig(max_patches_per_slide=N_PAD, batch_size=BATCH),
        model=ModelConfig(model_type="clam_sb", model_size="hipt_smaller"),
        train=TrainConfig(lr=1e-3, reg=1e-4, bag_loss="ce"))


CLASS_COUNTS = np.array([4, 4])


def hipt_configs(use_fused_block: bool = False):
    """Part 2's narrow HIPT4K widths (JAX :144-147): ViT-256 ``vit_small``
    at depth 2, embed 128, 2 heads; ViT-4K 128 -> 64, depth 1, 2 heads."""
    from hipt_abmil_atec23_tpu_torch.models.vit import (
        VIT_CONFIGS, ViT4KConfig)
    v256 = dataclasses.replace(VIT_CONFIGS["vit_small"], depth=2,
                               embed_dim=128, num_heads=2,
                               use_fused_block=use_fused_block)
    v4k = ViT4KConfig(input_embed_dim=128, output_embed_dim=64, depth=1,
                      num_heads=2, use_fused_block=use_fused_block)
    return v256, v4k


def dryrun_inputs(n: int) -> Dict[str, np.ndarray]:
    """Every part's inputs at ``n`` devices, drawn in the JAX dry run's
    order: part 1 from ``default_rng(0)`` (features, then labels), then
    part 2's regions and part 3's bag from the same stream; part 5 from
    ``default_rng(5)``."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, STEPS, BATCH, N_PAD, FEAT_DIM)
                       ).astype(np.float32)
    labels = rng.integers(0, 2, size=(n, STEPS, BATCH)).astype(np.int32)
    regions = rng.normal(size=(n, REGION, REGION, 3)).astype(np.float32)
    bag = rng.normal(size=(INST_ROWS * n, FEAT_DIM)).astype(np.float32)
    rng5 = np.random.default_rng(5)
    feats5 = rng5.normal(size=(n, STEPS, BATCH, N_PAD, FEAT_DIM)
                         ).astype(np.float32)
    labels5 = rng5.integers(0, 2, size=(n, STEPS, BATCH)).astype(np.int32)
    return {"feats": feats, "mask": np.ones(feats.shape[:-1], bool),
            "labels": labels, "regions": regions, "bag": bag,
            "feats5": feats5, "labels5": labels5}


def fold_lanes_epoch(cfg, heads: List[Dict[str, torch.Tensor]], feats,
                     mask, labels, mesh, axes=("fold",), *, device):
    """One epoch of ``feats.shape[1]`` optimizer steps on every lane, the
    JAX dry run's ``vmap(train_epoch)``: lane f starts from ``heads[f]``
    and trains on ``feats[f]`` ([F, S, B, N, D] numpy; mask, labels
    alike). This rank trains its block of the lanes along the mesh's
    ``axes`` as one stacked program (engine/stacked.py) with the
    configured optimizer on the stacked leaves. Returns (each lane's mean
    bag loss [F], each lane's trained parameters {name: [F, ...]}), both
    gathered onto every rank."""
    from hipt_abmil_atec23_tpu_torch.engine.stacked import (
        gather_lanes, lane_block, step_lanes)
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        _tensor, build_step_fns)
    from hipt_abmil_atec23_tpu_torch.parallel.fold_parallel import (
        stacked_folds)
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator

    n, steps = feats.shape[:2]
    fns = build_step_fns(cfg, CLASS_COUNTS, feats.shape[3], feats.shape[4],
                         device=device)
    lanes = lane_block(n, mesh, axes)
    models = [fns.init_params() for _ in lanes]
    for model, f in zip(models, lanes):
        model.load_state_dict(heads[f])
    names, params, optimizer, step_f, _ = stacked_folds(
        fns, cfg, CLASS_COUNTS, models)
    generator = torch_generator(cfg.train.seed, 777, lanes.start,
                                device=device)
    sel = slice(lanes.start, lanes.stop)
    f, m = _tensor(feats[sel], device), _tensor(mask[sel], device)
    lab = _tensor(labels[sel], device).long()
    sums = step_lanes(step_f, params, names, optimizer, f, m, lab, generator)
    loss = gather_lanes(sums / steps, mesh, axes)
    trained = {k: gather_lanes(p.detach(), mesh, axes)
               for k, p in zip(names, params)}
    return loss, trained


def default_weights(n: int) -> dict:
    """Seeded initial weights of every part, from the port's own
    initialisers: n fold heads (stream (seed, f), as fold-parallel
    training draws them), the HIPT4K of part 2 (DINO scheme, seed 0) and
    the CLAM_SB of parts 3-4 (reference scheme, seed 0)."""
    from hipt_abmil_atec23_tpu_torch.engine.train import build_step_fns
    from hipt_abmil_atec23_tpu_torch.models.abmil import (
        build_mil_model, init_reference_weights)
    from hipt_abmil_atec23_tpu_torch.models.hipt import HIPT4K
    from hipt_abmil_atec23_tpu_torch.models.vit import init_dino_
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator

    cfg = experiment_config()
    fns = build_step_fns(cfg, CLASS_COUNTS, N_PAD, FEAT_DIM, device="cpu")
    heads = [fns.init_params(torch_generator(cfg.train.seed, f)).state_dict()
             for f in range(n)]
    hipt = init_dino_(HIPT4K(*hipt_configs()), torch_generator(0))
    clam = init_reference_weights(
        build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2),
        torch_generator(0))
    return {"heads": heads, "hipt": hipt.state_dict(),
            "clam": clam.state_dict()}


def _np_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return x


def _finite(name, *xs):
    for x in xs:
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{name}: non-finite values")


def _hold(name, got, want, atol, rtol=0.0) -> float:
    """max |got - want|; raises unless the shapes agree and every element
    is within atol + rtol |want|."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if got.shape != want.shape or not bool(
            (d <= atol + rtol * want.abs()).all()):
        raise RuntimeError(f"{name} {tuple(got.shape)} disagrees with its "
                           f"plain version {tuple(want.shape)} (max |d| "
                           f"{d.max().item():.3g}, tolerance {atol}, {rtol})")
    return d.max().item()


def run_parts(n: int, device, weights: Optional[dict] = None) -> dict:
    """The five parts on this rank of a default group of ``n`` ranks (set
    up by the caller). On a card parts 2 and 3 hold their kernels against
    the plain versions on the same inputs and raise past BLOCK_TOL and
    POOL_TOL. Returns this rank's results as numpy arrays: ``part1``/
    ``part5`` {loss [n], heads {name: [n, ...]}}, ``part2`` {features
    [n, 64], plain_err on a card}, ``part3`` {logits, a_raw, err (to
    apply_pooled), plain_err (of both to the plain pool)}, ``part4``
    {loss, state}; ``part5`` is None for odd n."""
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    from hipt_abmil_atec23_tpu_torch.models.hipt import HIPT4K
    from hipt_abmil_atec23_tpu_torch.models.vit import Block
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled, gated_attention_pool_reference, params_from_clam)
    from hipt_abmil_atec23_tpu_torch.parallel.data_parallel import (
        encode_data_parallel)
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import global_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.sharded_bag import (
        sharded_bag_train_step, sharded_clam_forward)

    if dist.get_world_size() != n:
        raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                           f"for a dry run of {n}")
    on_card = device.type == "cuda"
    weights = weights or default_weights(n)
    inp = dryrun_inputs(n)
    say = log if dist.get_rank() == 0 else (lambda *a: None)
    out = {}

    # 1. fold-parallel training: one lane per rank over a ``fold`` mesh
    cfg = experiment_config()
    fold_mesh = make_mesh([("fold", n)], device.type)
    loss, heads = fold_lanes_epoch(cfg, weights["heads"], inp["feats"],
                                   inp["mask"], inp["labels"], fold_mesh,
                                   device=device)
    _finite("part 1", loss, *heads.values())
    out["part1"] = {"loss": loss, "heads": heads}
    say(f"part 1 fold-parallel train step: {n} lanes, bag loss "
        f"{loss.tolist()}")

    # 2. data-parallel HIPT encoding over a ``data`` mesh
    hipt = HIPT4K(*hipt_configs(use_fused_block=on_card))
    hipt.load_state_dict(weights["hipt"])
    hipt = hipt.to(device).eval()
    data_mesh = make_mesh([("data", n)], device.type)
    regions = torch.from_numpy(inp["regions"])
    feats = encode_data_parallel(hipt, regions, data_mesh)
    _finite("part 2", feats)
    if feats.shape != (n, hipt.feat_dim):
        raise RuntimeError(f"part 2: features {tuple(feats.shape)}")
    out["part2"] = {"features": feats}
    if on_card:
        plain = copy.deepcopy(hipt)
        for m in plain.modules():
            if isinstance(m, Block):
                m.plain = True
        with torch.no_grad():
            want = plain(regions.to(device))
        out["part2"]["plain_err"] = _hold(
            "part 2: the fused-block features", feats, want, *BLOCK_TOL)
    say(f"part 2 data-parallel HIPT encode: {n} regions of {REGION}^2 -> "
        f"{tuple(feats.shape)}, fused block {on_card}"
        + (f", {out['part2']['plain_err']:.3g} off the plain blocks"
           if on_card else ""))

    # 3. the instance-sharded forward over an ``inst`` mesh
    inst_mesh = make_mesh([("inst", n)], device.type)
    r = dist.get_rank(inst_mesh.get_group("inst"))
    clam = build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2)
    clam.load_state_dict(weights["clam"])
    clam = clam.to(device).eval()
    bag = torch.from_numpy(inp["bag"]).to(device)
    mask = torch.ones(len(bag), dtype=torch.bool, device=device)
    rows = slice(r * INST_ROWS, (r + 1) * INST_ROWS)
    with torch.no_grad():
        logits, a_raw = sharded_clam_forward(clam, bag[rows], mask[rows],
                                             inst_mesh, use_fused=on_card)
        whole = apply_pooled(clam, bag, mask)
        ref_logits, ref_scores = gated_attention_pool_reference(
            bag, mask, params_from_clam(clam))
    _finite("part 3", logits, a_raw)
    if logits.shape != (1, 2) or a_raw.shape != (1, len(bag)):
        raise RuntimeError(f"part 3: logits {tuple(logits.shape)}, scores "
                           f"{tuple(a_raw.shape)}")
    err = max((logits - whole.logits).abs().max().item(),
              (a_raw - whole.a_raw).abs().max().item())
    if not err <= POOL_TOL:
        raise RuntimeError(f"part 3: the sharded forward is {err:.3g} off "
                           f"apply_pooled on the whole bag ({POOL_TOL})")
    plain_err = max(
        _hold("part 3: the sharded logits", logits[0], ref_logits, POOL_TOL),
        _hold("part 3: the sharded scores", a_raw[0], ref_scores, POOL_TOL),
        _hold("part 3: apply_pooled's logits", whole.logits[0], ref_logits,
              POOL_TOL),
        _hold("part 3: apply_pooled's scores", whole.a_raw[0], ref_scores,
              POOL_TOL))
    out["part3"] = {"logits": logits, "a_raw": a_raw, "err": err,
                    "plain_err": plain_err}
    say(f"part 3 instance-sharded inference: [{len(bag)}, {FEAT_DIM}] over "
        f"{n} ranks, partial kernel {on_card}, {err:.3g} off apply_pooled, "
        f"both {plain_err:.3g} off the plain pool")

    # 4. one sequence-parallel training step, gradients through the
    # collectives
    opt = torch.optim.Adam(clam.parameters(), lr=1e-3)
    loss = sharded_bag_train_step(clam, opt, bag[rows], mask[rows], 0,
                                  inst_mesh)
    _finite("part 4", loss)
    out["part4"] = {"loss": loss, "state": clam.state_dict()}
    say(f"part 4 sequence-parallel train step: loss {loss.item():.6g}")

    # 5. part 1's lanes split over both axes of a (host, fold) mesh
    out["part5"] = None
    if n % 2 == 0:
        mesh2 = global_mesh("fold", host_axis="host", n_hosts=2)
        args = (cfg, weights["heads"], inp["feats5"], inp["mask"],
                inp["labels5"])
        loss, heads = fold_lanes_epoch(*args, mesh2, ("host", "fold"),
                                       device=device)
        _finite("part 5", loss, *heads.values())
        out["part5"] = {"loss": loss, "heads": heads}
        say(f"part 5 2-D host x fold train step: mesh "
            f"{tuple(mesh2.mesh.shape)}, bag loss {loss.tolist()}")
    return _np_tree(out)


def _rank_main(rank: int, n: int, device_type: str, tmp: str,
               weights: Optional[dict]) -> None:
    """One spawned rank: a launcher's environment, its card (C.4's
    LOCAL_RANK rule), the group through a file store, the parts, its
    results pickled to ``tmp``."""
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import init_multihost

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device_type == "cpu":
        torch.set_num_threads(1)
    device = resolve_device(device_type)
    init_multihost(device=device, init_method=f"file://{tmp}/store")
    try:
        res = run_parts(n, device, weights)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", *,
                     weights: Optional[dict] = None) -> List[dict]:
    """Run the five parts on ``n_devices`` ranks, one process each (NCCL
    and one card per rank on CUDA, gloo on the CPU), and print the JAX dry
    run's line. With n = 1 it runs in the calling process on a group of
    one, destroyed after. ``weights`` (``default_weights``'s layout)
    replaces the seeded initial weights. Returns each rank's results
    (``run_parts``), in rank order. Raises when a part fails, and on CUDA
    when there are fewer cards than ranks."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from hipt_abmil_atec23_tpu_torch.device import require_cuda, resolve_device
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import init_multihost

    n = int(n_devices)
    device_type = torch.device(device).type
    if n < 1:
        raise ValueError(f"dryrun_multichip needs a rank, got {n}")
    if device_type == "cuda":
        require_cuda()
        if n > torch.cuda.device_count():
            raise RuntimeError(f"dryrun_multichip({n}) on CUDA needs {n} "
                               f"cards, {torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        if n == 1:
            device = resolve_device(device)
            created = not dist.is_initialized()
            init_multihost(device=device, init_method=f"file://{tmp}/store")
            try:
                results = [run_parts(1, device, weights)]
            finally:
                if created:
                    dist.destroy_process_group()
        else:
            mp.spawn(_rank_main, args=(n, device_type, tmp, weights),
                     nprocs=n, join=True)
            results = []
            for r in range(n):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
    if n % 2:
        log(f"part 5 2-D host x fold train step: skipped, {n} devices do "
            f"not split over 2 hosts")
    print(f"hipt_abmil_atec23_tpu_torch: {OK_LINE.format(n=n)}", flush=True)
    return results


def entry(device="cuda"):
    """(fn, args) of a forward step over both flagship paths, as the JAX
    package's ``entry()``: ``fn(*args)`` gives (logits, y_prob, a_raw,
    cls) of CLAM_SB ``hipt_smaller`` on a 75-row bag padded to 80 and of
    a ``vit_tiny`` ViT cut to depth 2, bf16, on 8 images of 64². On a card
    every block of the ViT is one fused block kernel call (B.1 at D 192,
    3 heads of 64, 24 padded tokens); on the CPU the plain path runs.
    Seeded weights: the reference scheme for the head, DINO's for the
    ViT."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.models.abmil import (
        build_mil_model, init_reference_weights)
    from hipt_abmil_atec23_tpu_torch.models.vit import (
        VIT_CONFIGS, VisionTransformer, init_dino_)
    from hipt_abmil_atec23_tpu_torch.ops.masking import pad_bag
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator

    device = resolve_device(device)
    model = init_reference_weights(
        build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2),
        torch_generator(0)).to(device).eval()
    rng = np.random.default_rng(0)
    bag, mask = pad_bag(rng.normal(size=(75, 192)).astype(np.float32), 80)
    tiny = dataclasses.replace(VIT_CONFIGS["vit_tiny"], depth=2,
                               dtype=torch.bfloat16,
                               use_fused_block=device.type == "cuda")
    vit = init_dino_(VisionTransformer(tiny),
                     torch_generator(1)).to(device).eval()
    imgs = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)

    def fwd(model, vit, bag, mask, imgs):
        with torch.no_grad():
            out = model(bag, mask)
            cls = vit(imgs)
        return out.logits, out.y_prob, out.a_raw, cls

    to = lambda a: torch.from_numpy(a).to(device)
    return fwd, (model, vit, to(bag), to(mask), to(imgs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the multi-device dry run on N ranks.")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card per rank, NCCL) or cpu (gloo)")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices, a.device)
    return 0


if __name__ == "__main__":
    from hipt_abmil_atec23_tpu_torch import dryrun as _dryrun
    sys.exit(_dryrun.main())
