"""Per-fold training engine.

Counterpart of hipt_abmil_atec23_tpu/engine/train.py, which re-designs the
reference's bag-at-a-time loop (reference: utils/core_utils.py:102-442):

- ``train_epoch`` runs one epoch's optimizer steps, each on a batch of B
  padded bags ([B, N, D] + mask); B = 1 is the reference's schedule. The
  JAX package scans the steps in one jitted program; here a Python loop of
  autograd steps on the device, in f32 (TF32 stays off).
- Each epoch's data is assembled on the host at once (weighted resampling,
  bag subsampling with replacement; utils/utils.py:91, datasets/
  dataset_generic.py:517-519) from the numpy Generator in the JAX
  package's order, and goes to the device as one array.
- Validation and test are batched deterministic forwards.
- Early stopping keeps the reference's exact schedule (min_epochs warmup,
  patience / stop_epoch, best-val-loss checkpoints; core_utils.py:52-100).

Dropout masks come from a ``torch.Generator`` on the device seeded per
fold, so torch and JAX runs agree only with dropout off.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset, epoch_order
from hipt_abmil_atec23_tpu_torch.engine import metrics as M
from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
    ckpt_path, load_params, save_params)
from hipt_abmil_atec23_tpu_torch.engine.losses import (
    make_bag_loss, make_per_sample_loss)
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    build_mil_model, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.utils.seeding import (
    host_rng, torch_generator)


def make_optimizer(opt: str, lr: float, reg: float
                   ) -> Callable[[Iterable[torch.nn.Parameter]],
                                 torch.optim.Optimizer]:
    """The optimizer for ``opt`` ("adam" or "sgd") as a function of the
    parameters, as optax's transformation is initialised on them.
    ``torch.optim.Adam(weight_decay=reg)`` adds ``reg * p`` to the gradient
    before the moments, as ``optax.add_decayed_weights(reg)`` chained
    before ``optax.adam`` does; SGD likewise with momentum 0.9 (reference:
    get_optim, utils/utils.py:100-107)."""
    if opt == "adam":
        return lambda params: torch.optim.Adam(params, lr=lr,
                                               weight_decay=reg)
    if opt == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9,
                                              weight_decay=reg)
    raise ValueError(f"unknown optimizer {opt!r}")


@dataclass
class StepFns:
    # (model, optimizer, feats [S, B, N, D], mask, labels, generator)
    #   -> (mean bag loss, mean instance loss, mean accuracy), floats
    train_epoch: Callable
    # (model, feats [B, N, D], mask, labels) -> (probs, per-slide loss, inst)
    eval_batch: Callable
    init_params: Callable  # (generator) -> a fresh head on the device
    tx: Callable           # (parameters) -> optimizer


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)


def build_step_fns(cfg, class_counts: np.ndarray, n_pad: int, feat_dim: int,
                   *, device="cuda") -> StepFns:
    """The head, its losses and optimizer for ``cfg`` (JAX train.py:67-179).
    ``n_pad`` and ``feat_dim`` keep the JAX signature; nothing here needs a
    static shape."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    device = resolve_device(device)
    mc = cfg.model
    is_clam = mc.model_type in ("clam_sb", "clam_mb")
    use_inst = is_clam and not mc.no_inst_cluster
    bag_loss = make_bag_loss(cfg.train.bag_loss, class_counts)
    # validation ranks epochs by the CONFIGURED loss, per slide (reference:
    # validate() applies loss_fn at batch 1, core_utils.py:464,527)
    val_loss_fn = make_per_sample_loss(cfg.train.bag_loss)
    bag_weight = cfg.train.bag_weight

    def forward(model, feats, mask, labels, deterministic, generator=None):
        kw = dict(deterministic=deterministic, generator=generator)
        if is_clam:
            kw.update(label=labels, instance_eval=use_inst)
        return model(feats, mask, **kw)

    def train_epoch(model, optimizer, feats, mask, labels, generator=None):
        """feats [S, B, N, D]: S optimizer steps. The loss of a step is the
        batch mean of bag_weight * bag loss + (1 - bag_weight) * instance
        loss (the instance loss taken per bag, then averaged) where the
        instance loss is on (JAX train.py:96-107)."""
        feats, mask = _tensor(feats, device), _tensor(mask, device)
        labels = _tensor(labels, device).long()
        sums = torch.zeros(3, device=device)
        for s in range(feats.shape[0]):
            out = forward(model, feats[s], mask[s], labels[s], False,
                          generator)
            bl = bag_loss(out.logits, labels[s])
            if use_inst:
                inst = out.extras["instance_loss"].mean()
                total = bag_weight * bl + (1.0 - bag_weight) * inst
            else:
                inst = torch.zeros((), device=device)
                total = bl
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            optimizer.step()
            correct = (out.y_hat == labels[s]).float().mean()
            sums += torch.stack([bl.detach(), inst.detach(), correct])
        bl, inst, acc = (sums / feats.shape[0]).tolist()
        return bl, inst, acc

    @torch.no_grad()
    def eval_batch(model, feats, mask, labels):
        labels = _tensor(labels, device).long()
        out = forward(model, _tensor(feats, device), _tensor(mask, device),
                      labels, True)
        losses = val_loss_fn(out.logits, labels)
        inst = out.extras["instance_loss"] if use_inst \
            else torch.zeros_like(losses)
        return torch.softmax(out.logits, dim=-1), losses, inst

    def init_params(generator: Optional[torch.Generator] = None):
        model = build_mil_model(
            mc.model_type, size_arg=mc.model_size, dropout=mc.drop_out,
            n_classes=cfg.task.n_classes, k_sample=mc.k_sample,
            gate=mc.gate, subtyping=mc.subtyping)
        return init_reference_weights(model, generator).to(device)

    return StepFns(train_epoch=train_epoch, eval_batch=eval_batch,
                   init_params=init_params,
                   tx=make_optimizer(cfg.train.opt, cfg.train.lr,
                                     cfg.train.reg))


class EarlyStopper:
    """The reference's schedule (utils/core_utils.py:52-100)."""

    def __init__(self, min_epochs=50, patience=50, stop_epoch=50):
        self.min_epochs = min_epochs
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.save_requested = False

    def update(self, epoch: int, val_loss: float) -> bool:
        """Returns True when the current model should be checkpointed."""
        score = -val_loss
        self.save_requested = False
        if epoch < self.min_epochs:
            # warmup: checkpoint every epoch, best tracking not yet started
            self.save_requested = True
            return True
        # >= : the reference checkpoints and resets its counter when the
        # score EQUALS the best (its non-improvement branch is a strict
        # score < best_score, core_utils.py:80-88)
        if self.best_score is None or score >= self.best_score:
            self.best_score = score
            self.counter = 0
            self.save_requested = True
            return True
        self.counter += 1
        if self.counter >= self.patience and epoch > self.stop_epoch:
            self.early_stop = True
        return False


@dataclass
class FoldResult:
    fold: int
    val_auc: float
    test_auc: float
    val_acc: float
    test_acc: float
    val_loss: float
    test_loss: float
    stopped_epoch: int
    test_probs: np.ndarray
    test_labels: np.ndarray
    test_slide_ids: List[str]
    history: List[Dict[str, float]] = field(default_factory=list)


def _chunk_tensors(train_ds, val_ds, cfg, e: int, bs: int, n_pad: int,
                   rng: np.random.Generator, tc):
    """E epochs of train batches, then E per-epoch val subsamples, drawn in
    the JAX package's order (JAX train.py:240-262)."""
    parts = []
    for _ in range(e):
        order = epoch_order(train_ds.labels, cfg.task.n_classes, rng,
                            tc.weighted_sample)
        parts.append(_epoch_tensors(train_ds, order, bs, n_pad, rng))
    tr_f = np.stack([p[0] for p in parts])
    tr_m = np.stack([p[1] for p in parts])
    tr_l = np.stack([p[2] for p in parts])
    n_val = len(val_ds)
    v_f = np.zeros((e, n_val, n_pad, tr_f.shape[-1]), np.float32)
    v_m = np.zeros((e, n_val, n_pad), bool)
    v_l = np.zeros((e, n_val), np.int32)
    for i in range(e):
        vb = val_ds.make_batch(list(range(n_val)), rng, n_pad=n_pad,
                               train=False)
        v_f[i], v_m[i], v_l[i] = vb.features, vb.mask, vb.labels
    v_v = np.ones((e, n_val), np.float32)
    return tr_f, tr_m, tr_l, v_f, v_m, v_l, v_v


def _epoch_tensors(ds: BagDataset, order: np.ndarray, batch_size: int,
                   n_pad: int, rng: np.random.Generator):
    """One epoch of batches as [S, B, N, D] host arrays (a ragged last
    batch is dropped when B > 1)."""
    order = order[: (len(order) // batch_size) * batch_size] \
        if batch_size > 1 else order
    steps = len(order) // batch_size
    feats = np.zeros((steps, batch_size, n_pad, ds._feat_dim), np.float32)
    mask = np.zeros((steps, batch_size, n_pad), bool)
    labels = np.zeros((steps, batch_size), np.int32)
    for s in range(steps):
        idxs = order[s * batch_size:(s + 1) * batch_size]
        b = ds.make_batch(idxs, rng, n_pad=n_pad, train=True)
        feats[s], mask[s], labels[s] = b.features, b.mask, b.labels
    return feats, mask, labels


def evaluate_split(fns: StepFns, model, ds: BagDataset, n_pad: int,
                   rng: np.random.Generator, batch_size: int = 32):
    """Deterministic forward over a split in batches of min(32, n), bags
    subsampled to the training cap as the reference does (datasets/
    dataset_generic.py:517-519). Returns (probs [n, C], mean loss)."""
    n = len(ds)
    batch_size = min(batch_size, n)
    all_probs, all_loss = [], []
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        b = ds.make_batch(idxs, rng, n_pad=n_pad, train=False)
        p, loss, _ = fns.eval_batch(model, b.features, b.mask, b.labels)
        all_probs.append(p.cpu().numpy())
        all_loss.append(loss.cpu().numpy())
    return np.concatenate(all_probs), float(np.concatenate(all_loss).mean())


def train_fold(cfg, fold: int, train_ds: BagDataset, val_ds: BagDataset,
               test_ds: BagDataset, class_counts: np.ndarray, *,
               feat_dim: Optional[int] = None, n_pad: Optional[int] = None,
               verbose: bool = True,
               log_cb: Optional[Callable[[int, Dict[str, float]], Any]] = None,
               state_cb: Optional[Callable[[int, Any, Any], None]] = None,
               device="cuda") -> FoldResult:
    """Train one CV fold end to end (reference: train(), utils/
    core_utils.py:102-297) on ``device``. ``log_cb(epoch, record)``
    returning True stops training; ``state_cb(epoch, model, optimizer)``
    sees every epoch's state. With ``epoch_chunk`` E > 1 the host draws E
    epochs of batches and E val subsamples at once, in the JAX package's
    order; the epochs still run and are judged one at a time."""
    tc = cfg.train
    logger = None
    if cfg.log_data:
        # tensorboardX-or-JSONL scalars per epoch (reference: --log_data,
        # utils/core_utils.py:126-128, 365-371)
        from hipt_abmil_atec23_tpu_torch.utils.logging import MetricsLogger
        logger = MetricsLogger(os.path.join(cfg.results_dir, str(fold)))
    if n_pad is None:
        n_pad = max(train_ds.pad_size(), val_ds.pad_size(),
                    test_ds.pad_size())
    if feat_dim is None:
        feat_dim = train_ds._full_bag(train_ds.slide_ids[0]).shape[1]
    for ds in (train_ds, val_ds, test_ds):
        ds._feat_dim = feat_dim  # used by _epoch_tensors

    fns = build_step_fns(cfg, class_counts, n_pad, feat_dim, device=device)
    model = fns.init_params(torch_generator(tc.seed, fold))
    os.makedirs(cfg.results_dir, exist_ok=True)
    cpath = ckpt_path(cfg.results_dir, fold)
    if tc.continue_training and os.path.exists(cpath):
        load_params(cpath, model)
    optimizer = fns.tx(model.parameters())
    dev = next(model.parameters()).device
    dropout_gen = torch_generator(tc.seed, fold, 1, device=dev)

    stopper = EarlyStopper(tc.min_epochs, tc.patience, tc.stop_epoch) \
        if tc.early_stopping else None
    rng = host_rng(tc.seed, fold)
    history: List[Dict[str, float]] = []
    stopped_epoch = tc.max_epochs - 1
    bs = max(1, cfg.bags.batch_size)
    chunk = max(1, getattr(tc, "epoch_chunk", 1))

    def finish_epoch(epoch, rec) -> bool:
        """Per-epoch bookkeeping; True stops training."""
        history.append(rec)
        if state_cb is not None:
            state_cb(epoch, model, optimizer)
        if logger is not None:
            logger.scalars({k: v for k, v in rec.items() if k != "epoch"},
                           epoch)
        if log_cb and log_cb(epoch, rec):
            return True  # external stop
        if verbose:
            print(f"[fold {fold}] epoch {epoch}: "
                  f"train_loss {rec['train_loss']:.4f} "
                  f"val_loss {rec['val_loss']:.4f} "
                  f"val_auc {rec['val_auc']:.4f}")
        if stopper is not None:
            if stopper.update(epoch, rec["val_loss"]):
                save_params(cpath, model)
            if stopper.early_stop:
                if verbose:
                    print(f"[fold {fold}] early stop at epoch {epoch}")
                return True
        return False

    def run_epoch(epoch, feats, mask, labels, val) -> bool:
        bl, inst, acc = fns.train_epoch(model, optimizer, feats, mask,
                                        labels, dropout_gen)
        val_probs, val_loss = val()
        rec = dict(epoch=epoch, train_loss=bl, train_inst_loss=inst,
                   train_acc=acc, val_loss=val_loss,
                   val_auc=M.auc_score(val_ds.labels, val_probs,
                                       cfg.task.n_classes))
        return finish_epoch(epoch, rec)

    epoch = 0
    stop = False
    while epoch < tc.max_epochs and not stop:
        if chunk == 1:
            order = epoch_order(train_ds.labels, cfg.task.n_classes, rng,
                                tc.weighted_sample)
            batches = _epoch_tensors(train_ds, order, bs, n_pad, rng)
            stop = run_epoch(epoch, *batches, lambda: evaluate_split(
                fns, model, val_ds, n_pad, rng))
            stopped_epoch = epoch
            epoch += 1
            continue
        e = min(chunk, tc.max_epochs - epoch)
        tr_f, tr_m, tr_l, v_f, v_m, v_l, _ = _chunk_tensors(
            train_ds, val_ds, cfg, e, bs, n_pad, rng, tc)
        for i in range(e):
            def val(i=i):
                probs, loss, _ = fns.eval_batch(model, v_f[i], v_m[i],
                                                v_l[i])
                return probs.cpu().numpy(), float(loss.mean())
            stop = run_epoch(epoch, tr_f[i], tr_m[i], tr_l[i], val)
            stopped_epoch = epoch
            epoch += 1
            if stop:
                break

    if stopper is not None and os.path.exists(cpath):
        load_params(cpath, model)   # reload the best (reference :273-274)
    else:
        save_params(cpath, model)   # reference :276

    if logger is not None:
        logger.close()
    val_probs, val_loss = evaluate_split(fns, model, val_ds, n_pad, rng)
    test_probs, test_loss = evaluate_split(fns, model, test_ds, n_pad, rng)
    return FoldResult(
        fold=fold,
        val_auc=M.auc_score(val_ds.labels, val_probs, cfg.task.n_classes),
        test_auc=M.auc_score(test_ds.labels, test_probs, cfg.task.n_classes),
        val_acc=M.accuracy(val_ds.labels, val_probs.argmax(1)),
        test_acc=M.accuracy(test_ds.labels, test_probs.argmax(1)),
        val_loss=val_loss, test_loss=test_loss, stopped_epoch=stopped_epoch,
        test_probs=test_probs, test_labels=test_ds.labels,
        test_slide_ids=list(test_ds.slide_ids), history=history)
