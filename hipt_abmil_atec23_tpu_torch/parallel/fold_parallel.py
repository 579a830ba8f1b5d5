"""Fold-parallel cross-validation: every fold trains at once.

Counterpart of hipt_abmil_atec23_tpu/parallel/fold_parallel.py. The
reference trains folds in a serial loop (main.py:231-282); here the folds
are a lane axis (engine/stacked.py): the heads' parameters and the
optimizer state carry a leading [F] axis, each optimizer step is one
vmapped gradient over all folds, and each epoch's validation is one vmapped
forward. The optimizer is ``train_fold``'s own ``torch.optim`` one on the
stacked leaves: Adam and SGD are elementwise, so with one lr for every fold
this is the per-fold optimizer. Early stopping runs per fold on the host.

With a ``DeviceMesh`` each rank of its ``fold`` axis trains a block of F / W
folds; the per-epoch losses are all-gathered, so every rank takes the
stop decisions a single process would, and the summary is gathered at the
end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset, epoch_order
from hipt_abmil_atec23_tpu_torch.engine import metrics as M


@dataclass
class FoldParallelResult:
    summary: Dict[str, np.ndarray]              # per-fold arrays [F]
    best_params: List[Dict[str, torch.Tensor]]  # each fold's best state dict
    histories: List[List[Dict[str, float]]]


def _fold_heads(fns, seed: int, folds) -> List[torch.nn.Module]:
    """Each fold's initial head: ``train_fold``'s, from the generator of
    stream (seed, fold)."""
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator
    return [fns.init_params(torch_generator(seed, f)) for f in folds]


def train_folds_parallel(
    cfg,
    fold_datasets: List[Tuple[BagDataset, BagDataset, BagDataset]],
    class_counts: np.ndarray,
    mesh=None,
    *,
    verbose: bool = True,
    device="cuda",
) -> FoldParallelResult:
    """Train all folds at once on ``device``. Every fold takes the same
    number of steps per epoch, the largest train split's (weighted sampling
    draws with replacement, so the smaller folds draw extra slides from
    their own host stream, JAX fold_parallel.py:104-108), with bags padded
    to one N. A fold that has stopped keeps its parameters while the
    optimizer state goes on advancing for every fold, as in the JAX
    package."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.stacked import (
        gather_lanes, gather_objects, head_fns, lane_block, stack_heads,
        unstack, vmap_lanes)
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        _epoch_tensors, _tensor, build_step_fns)
    from hipt_abmil_atec23_tpu_torch.utils.seeding import (
        host_rng, torch_generator)

    device = resolve_device(device)
    tc = cfg.train
    n_folds = len(fold_datasets)
    bs = max(1, cfg.bags.batch_size)
    feat_dim = fold_datasets[0][0]._full_bag(
        fold_datasets[0][0].slide_ids[0]).shape[1]
    n_pad = max(max(tr.pad_size(), va.pad_size(), te.pad_size())
                for tr, va, te in fold_datasets)
    for tr, va, te in fold_datasets:
        tr._feat_dim = va._feat_dim = te._feat_dim = feat_dim
    steps = max(len(tr) for tr, _, _ in fold_datasets) // bs
    val_n = max(len(va) for _, va, _ in fold_datasets)

    fns = build_step_fns(cfg, class_counts, n_pad, feat_dim, device=device)
    folds = lane_block(n_folds, mesh)
    local = list(folds)
    base, stacked = stack_heads(_fold_heads(fns, tc.seed, folds))
    params = [v.detach().requires_grad_(False) for v in stacked.values()]
    names = list(stacked)
    optimizer = fns.tx(params)
    step_fn, eval_fn = head_fns(base, cfg, class_counts)
    step_f = vmap_lanes(step_fn, (0, 0, 0, 0, None))
    eval_f = vmap_lanes(eval_fn, (0, 0, 0, 0))
    dropout_gen = torch_generator(tc.seed, 777, folds.start, device=device)
    rngs = {f: host_rng(tc.seed, f) for f in local}

    def as_dict(tensors):
        return dict(zip(names, tensors))

    best_val = np.full(n_folds, np.inf)
    counters = np.zeros(n_folds, np.int64)
    stopped = np.zeros(n_folds, bool)
    best_started = np.zeros(n_folds, bool)
    best_params = [p.detach().clone() for p in params]
    histories: Dict[int, List[Dict[str, float]]] = {f: [] for f in local}

    def epoch_data():
        f = np.zeros((len(local), steps, bs, n_pad, feat_dim), np.float32)
        m = np.zeros((len(local), steps, bs, n_pad), bool)
        lab = np.zeros((len(local), steps, bs), np.int32)
        for i, fold in enumerate(local):
            tr = fold_datasets[fold][0]
            rng = rngs[fold]
            order = epoch_order(tr.labels, cfg.task.n_classes, rng,
                                tc.weighted_sample)
            need = steps * bs
            if len(order) < need:
                extra = rng.choice(len(tr), need - len(order), replace=True)
                order = np.concatenate([order, extra])
            f[i], m[i], lab[i] = _epoch_tensors(tr, order[:need], bs, n_pad,
                                                rng)
        return f, m, lab

    def val_data():
        f = np.zeros((len(local), val_n, n_pad, feat_dim), np.float32)
        m = np.zeros((len(local), val_n, n_pad), bool)
        lab = np.zeros((len(local), val_n), np.int32)
        valid = np.zeros((len(local), val_n), bool)
        for i, fold in enumerate(local):
            va = fold_datasets[fold][1]
            b = va.make_batch(list(range(len(va))), rngs[fold], n_pad=n_pad,
                              train=False)
            f[i, :len(va)], m[i, :len(va)], lab[i, :len(va)] = (
                b.features, b.mask, b.labels)
            valid[i, :len(va)] = True
        return f, m, lab, valid

    for epoch in range(tc.max_epochs):
        f, m, lab = (_tensor(x, device) for x in epoch_data())
        lab = lab.long()
        old = [p.detach().clone() for p in params] if stopped.any() else None
        sums = torch.zeros(len(local), device=device)
        for s in range(steps):
            grads, (bl, _, _) = step_f(as_dict(params), f[:, s], m[:, s],
                                       lab[:, s], dropout_gen)
            for p, name in zip(params, names):
                p.grad = grads[name]
            optimizer.step()
            sums += bl
        # folds that stopped keep their parameters (their results are
        # ignored); the optimizer state advanced for every fold
        if old is not None:
            keep = torch.as_tensor(stopped[local], device=device)
            with torch.no_grad():
                for p, o in zip(params, old):
                    p[keep] = o[keep]
        train_loss = gather_lanes(sums / max(steps, 1), mesh).cpu().numpy()

        vf, vm, vl, vvalid = val_data()
        with torch.no_grad():
            _, nll = eval_f(as_dict(params), _tensor(vf, device),
                            _tensor(vm, device), _tensor(vl, device).long())
        nll = nll.cpu().numpy()
        local_loss = (nll * vvalid).sum(1) / np.maximum(vvalid.sum(1), 1)
        val_loss = gather_lanes(torch.as_tensor(local_loss, device=device),
                                mesh).cpu().numpy()

        # early stopping per fold (reference: core_utils.py:52-100)
        improved = np.zeros(n_folds, bool)
        for i in range(n_folds):
            if stopped[i]:
                continue
            if i in histories:
                histories[i].append(dict(epoch=epoch,
                                         val_loss=float(val_loss[i]),
                                         train_loss=float(train_loss[i])))
            if not tc.early_stopping:
                improved[i] = True   # track the latest parameters
                continue
            if epoch < tc.min_epochs:
                improved[i] = True
                best_val[i] = val_loss[i]
            # <= : a plateau-equal loss re-checkpoints and resets the
            # counter, as EarlyStopper.update does
            elif not best_started[i] or val_loss[i] <= best_val[i]:
                best_started[i] = True
                best_val[i] = val_loss[i]
                counters[i] = 0
                improved[i] = True
            else:
                counters[i] += 1
                if counters[i] >= tc.patience and epoch > tc.stop_epoch:
                    stopped[i] = True
        imp = torch.as_tensor(improved[local], device=device)
        with torch.no_grad():
            for b, p in zip(best_params, params):
                b[imp] = p[imp]
        if verbose:
            print(f"[folds] epoch {epoch}: val_loss "
                  f"{np.array2string(val_loss, precision=4)} "
                  f"stopped {stopped}")
        if stopped.all():
            break

    # the final evaluation from each fold's best parameters
    out = {}
    for i, fold in enumerate(local):
        sd = unstack(as_dict(best_params), i)
        model = fns.init_params()
        model.load_state_dict(sd)
        row = {"state": {k: v.cpu() for k, v in sd.items()},
               "history": histories[fold]}
        for name, ds in (("val", fold_datasets[fold][1]),
                         ("test", fold_datasets[fold][2])):
            b = ds.make_batch(list(range(len(ds))), rngs[fold], n_pad=n_pad,
                              train=False)
            probs, _, _ = fns.eval_batch(model, b.features, b.mask, b.labels)
            probs = probs.cpu().numpy()
            row[f"{name}_auc"] = M.auc_score(ds.labels, probs,
                                             cfg.task.n_classes)
            row[f"{name}_acc"] = M.accuracy(ds.labels, probs.argmax(1))
        out[fold] = row
    merged = {}
    for part in gather_objects(out, mesh):
        merged.update(part)
    summary = {k: np.array([merged[f][k] for f in range(n_folds)])
               for k in ("val_auc", "test_auc", "val_acc", "test_acc")}
    return FoldParallelResult(
        summary=summary,
        best_params=[merged[f]["state"] for f in range(n_folds)],
        histories=[merged[f]["history"] for f in range(n_folds)])
