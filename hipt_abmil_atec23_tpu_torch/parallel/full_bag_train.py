"""Exact FULL-BAG MIL training with the instance axis sharded over a mesh.

Counterpart of hipt_abmil_atec23_tpu/parallel/full_bag_train.py. The
reference subsamples bags to ``max_patches_per_slide`` to fit a training
step (reference: datasets/dataset_generic.py:517-519); here every slide
trains on all of its instances, split over the ranks of one mesh axis, with
gradients through the sequence-parallel collectives
(parallel/sharded_bag.py). Bags pad to one bucket size and validity is a
mask, and the loop takes one slide per optimizer step, the reference's own
schedule. Each rank copies to its device only its own rows of each bag.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hipt_abmil_atec23_tpu_torch.engine import metrics as M
from hipt_abmil_atec23_tpu_torch.engine.train import make_optimizer
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    build_mil_model, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.parallel.sharded_bag import (
    sharded_bag_train_step, sharded_clam_forward)
from hipt_abmil_atec23_tpu_torch.utils.seeding import (
    host_rng, torch_generator)


def _pad_bucket(n_max: int, n_devices: int) -> int:
    m = 128 * n_devices
    return ((n_max + m - 1) // m) * m


def train_full_bags_sharded(cfg, train_ds, val_ds, mesh, *,
                            axis: str = "inst", verbose: bool = True
                            ) -> Tuple[torch.nn.Module, List[dict]]:
    """Train CLAM_SB on exact full bags, instance axis sharded over ``mesh``
    (a DeviceMesh whose device type places the model and the rows).

    Uses cfg.model (single-branch gated CLAM, the sharded forward's
    contract) and cfg.train.{lr, reg, opt, max_epochs, seed}. Returns
    (model, history); history rows carry epoch, train_loss, val_loss and
    val_auc, as the JAX trainer's do."""
    if cfg.model.model_type != "clam_sb" or not cfg.model.gate:
        raise ValueError("full-bag sharded training requires single-branch "
                         "gated CLAM (clam_sb)")
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    n_devices = mesh.size()
    group = mesh.get_group(axis)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    feat_dim = train_ds._full_bag(train_ds.slide_ids[0]).shape[1]
    n_max = max(len(ds._full_bag(s)) for ds in (train_ds, val_ds)
                for s in ds.slide_ids)
    n_pad = _pad_bucket(n_max, n_devices)
    n_loc = n_pad // world
    lo = rank * n_loc

    model = build_mil_model("clam_sb", size_arg=cfg.model.model_size,
                            n_classes=cfg.task.n_classes, gate=True)
    init_reference_weights(model, torch_generator(cfg.train.seed))
    model = model.to(device)
    optimizer = make_optimizer(cfg.train.opt, cfg.train.lr,
                               cfg.train.reg)(model.parameters())

    def _local(ds, sid):
        """This rank's rows of the padded bag, and their mask."""
        feats = ds._full_bag(sid)
        k = min(len(feats), n_pad)
        bag = np.zeros((n_loc, feat_dim), np.float32)
        rows = feats[lo:min(k, lo + n_loc)]
        bag[:len(rows)] = rows
        mask = np.arange(lo, lo + n_loc) < k
        return (torch.from_numpy(bag).to(device),
                torch.from_numpy(mask).to(device))

    def _infer(sid):
        with torch.no_grad():
            logits, _ = sharded_clam_forward(model, *_local(val_ds, sid),
                                             mesh, axis=axis)
        return torch.softmax(logits[0], dim=-1).cpu().numpy()

    rng = host_rng(cfg.train.seed, 7)
    history: List[dict] = []
    for epoch in range(cfg.train.max_epochs):
        order = rng.permutation(len(train_ds.slide_ids))
        losses = []
        model.train()
        for i in order:
            bag, mask = _local(train_ds, train_ds.slide_ids[i])
            loss = sharded_bag_train_step(model, optimizer, bag, mask,
                                          int(train_ds.labels[i]), mesh,
                                          axis=axis)
            losses.append(float(loss))
        model.eval()
        val_probs = np.stack([_infer(s) for s in val_ds.slide_ids])
        val_auc = M.auc_score(val_ds.labels, val_probs, cfg.task.n_classes)
        val_loss = float(np.mean(
            [-np.log(max(val_probs[j, int(l)], 1e-12))
             for j, l in enumerate(val_ds.labels)]))
        rec = dict(epoch=epoch, train_loss=float(np.mean(losses)),
                   val_loss=val_loss, val_auc=val_auc)
        history.append(rec)
        if verbose and rank == 0:
            print(f"[full-bag] epoch {epoch}: train {rec['train_loss']:.4f} "
                  f"val {val_loss:.4f} auc {val_auc:.4f} "
                  f"(bags padded to {n_pad})")
    return model, history
