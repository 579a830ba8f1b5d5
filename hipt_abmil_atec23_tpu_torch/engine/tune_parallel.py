"""Trial-parallel hyperparameter search: trials as a stacked lane axis.

Counterpart of hipt_abmil_atec23_tpu/engine/tune_parallel.py. The reference
runs Ray Tune trials as separate processes sharing one GPU (main.py:40-255);
trials whose architecture is the same (one model size and dropout; only
the optimizer's lr and weight decay differ) train here as one program: T
heads stacked along a lane axis (engine/stacked.py), one vmapped gradient
per optimizer step, and an Adam step whose lr and reg are [T] tensors.

Adam is the reference's (torch Adam with additive L2: grad + reg * param
before the moments, utils/utils.py:100-107), written out so lr and reg
are per lane. Over a ``DeviceMesh``'s ``fold`` axis each rank trains T / W
lanes; every epoch's validation losses are all-gathered, so every rank
takes the same ASHA decisions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _lane_view(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane [T] (or scalar) tensor shaped to broadcast over a
    stacked leaf [T, ...]."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


@torch.no_grad()
def adam_l2_update(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor],
                   mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
                   count: torch.Tensor, lr, reg):
    """One torch-style Adam step with additive L2 on stacked leaves (JAX
    tune_parallel.py:28): ``lr``, ``reg`` and ``count`` are [T] tensors
    (one per lane) or scalars. Returns (params, mu, nu, count), new
    tensors."""
    count = count + 1
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k] + _lane_view(reg, p) * p
        m = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
        v = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
        c = _lane_view(count, p)
        mhat = m / (1 - torch.pow(torch.tensor(ADAM_B1, dtype=p.dtype,
                                               device=p.device), c))
        vhat = v / (1 - torch.pow(torch.tensor(ADAM_B2, dtype=p.dtype,
                                               device=p.device), c))
        new_p[k] = p - _lane_view(lr, p) * mhat / (torch.sqrt(vhat)
                                                   + ADAM_EPS)
        new_m[k], new_v[k] = m, v
    return new_p, new_m, new_v, count


@dataclass
class ParallelTrialResult:
    lr: np.ndarray             # [T]
    reg: np.ndarray            # [T]
    val_loss: np.ndarray       # [T, E] (NaN after a trial's ASHA kill)
    best_trial: int
    best_lr: float
    best_reg: float
    stopped_epoch: Optional[np.ndarray] = None  # [T] last trained epoch


def _lane_heads(fns, seed: int, lanes) -> List[torch.nn.Module]:
    """The initial head of each lane in ``lanes`` (global lane indices):
    the reference's init from the generator of stream (seed, 4242, t)."""
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator
    return [fns.init_params(torch_generator(seed, 4242, t)) for t in lanes]


def run_trials_parallel(
    cfg,
    fold_datasets: Tuple,
    class_counts: np.ndarray,
    lr_values: np.ndarray,
    reg_values: np.ndarray,
    *,
    max_epochs: Optional[int] = None,
    mesh=None,
    verbose: bool = True,
    asha=None,
    n_real: Optional[int] = None,
    device="cuda",
) -> ParallelTrialResult:
    """Train T = len(lr_values) trials at once on one fold, on ``device``.

    Every trial sees the same data stream (one host stream, the JAX
    package's: host_rng(seed, 999), the validation bags first) and differs
    only in (lr, reg). Selection: the lowest mean validation NLL over the
    last min(10, E) epochs (reference: main.py:256-268).

    ``asha`` (an engine.tune.ASHAScheduler) kills trials at its rung
    milestones: a killed lane keeps computing, but its losses freeze at NaN
    and it stops feeding the rungs; once every trial is dead the run stops.
    ``n_real`` leaves trailing padding lanes out. With ``mesh`` each rank
    of its ``fold`` axis trains its block of T / W lanes."""
    from hipt_abmil_atec23_tpu_torch.data.bags import epoch_order
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.stacked import (
        gather_lanes, head_fns, lane_block, stack_heads, vmap_lanes)
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        _epoch_tensors, _tensor, build_step_fns)
    from hipt_abmil_atec23_tpu_torch.utils.seeding import (
        host_rng, torch_generator)

    device = resolve_device(device)
    lr_values = np.asarray(lr_values, np.float32)
    reg_values = np.asarray(reg_values, np.float32)
    assert lr_values.shape == reg_values.shape
    n_trials = len(lr_values)
    train_ds, val_ds, _ = fold_datasets
    epochs = max_epochs or cfg.train.max_epochs
    bs = max(1, cfg.bags.batch_size)

    feat_dim = train_ds._full_bag(train_ds.slide_ids[0]).shape[1]
    for ds in (train_ds, val_ds):
        ds._feat_dim = feat_dim
    n_pad = max(train_ds.pad_size(), val_ds.pad_size())

    fns = build_step_fns(cfg, class_counts, n_pad, feat_dim, device=device)
    lanes = lane_block(n_trials, mesh)
    base, params = stack_heads(_lane_heads(fns, cfg.train.seed, lanes))
    params = {k: v.detach() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = torch.zeros(len(lanes), dtype=torch.float32, device=device)
    lr = torch.as_tensor(lr_values[lanes.start:lanes.stop], device=device)
    reg = torch.as_tensor(reg_values[lanes.start:lanes.stop], device=device)
    step_fn, eval_fn = head_fns(base, cfg, class_counts)
    step_f = vmap_lanes(step_fn, (0, None, None, None, None))
    eval_f = vmap_lanes(eval_fn, (0, None, None, None))
    dropout_gen = torch_generator(cfg.train.seed, 4242, device=device)

    rng = host_rng(cfg.train.seed, 999)
    vb = val_ds.make_batch(list(range(len(val_ds))), rng, n_pad=n_pad,
                           train=False)
    v_feats, v_mask = _tensor(vb.features, device), _tensor(vb.mask, device)
    v_labels = _tensor(vb.labels, device).long()

    n_real = n_trials if n_real is None else n_real
    val_hist = np.full((n_trials, epochs), np.nan, np.float32)
    active = np.zeros((n_trials,), bool)
    active[:n_real] = True
    stopped = np.full((n_trials,), epochs - 1, np.int64)
    for epoch in range(epochs):
        order = epoch_order(train_ds.labels, cfg.task.n_classes, rng,
                            cfg.train.weighted_sample)
        feats, mask, labels = _epoch_tensors(train_ds, order, bs, n_pad, rng)
        feats, mask = _tensor(feats, device), _tensor(mask, device)
        labels = _tensor(labels, device).long()
        for s in range(feats.shape[0]):
            grads, _ = step_f(params, feats[s], mask[s], labels[s],
                              dropout_gen)
            params, mu, nu, count = adam_l2_update(params, grads, mu, nu,
                                                   count, lr, reg)
        with torch.no_grad():
            _, nll = eval_f(params, v_feats, v_mask, v_labels)
        vl = gather_lanes(nll.mean(-1), mesh).cpu().numpy()
        val_hist[active, epoch] = vl[active]
        if asha is not None:
            for t in np.flatnonzero(active):
                if asha.should_stop(epoch, float(vl[t])):
                    active[t] = False
                    stopped[t] = epoch
            if not active.any():
                if verbose:
                    print(f"[trials] all trials ASHA-killed at epoch {epoch}")
                break
        if verbose:
            print(f"[trials] epoch {epoch}: val_loss "
                  f"{np.array2string(vl[:n_real], precision=4)}")

    def _last10(t):
        vals = val_hist[t][~np.isnan(val_hist[t])]
        return float(vals[-min(10, len(vals)):].mean()) if len(vals) \
            else float("inf")
    last = np.array([_last10(t) for t in range(n_real)])
    best = int(np.argmin(last))
    return ParallelTrialResult(
        lr=lr_values, reg=reg_values, val_loss=val_hist, best_trial=best,
        best_lr=float(lr_values[best]), best_reg=float(reg_values[best]),
        stopped_epoch=stopped)


# --------------------------------------------------------------------------
# heterogeneous spaces: one stacked run per architecture bucket
# --------------------------------------------------------------------------

_LANE_KEYS = ("lr", "reg")  # the tunables that differ between lanes


def _bucket_key(trial: Dict) -> Tuple:
    """The part of a trial that fixes the head and its data (model_size,
    max_patches_per_slide, B, drop_out): lanes of one run share it; lr and
    reg vary per lane."""
    return tuple(sorted((k, v) for k, v in trial.items()
                        if k not in _LANE_KEYS))


def run_tuning_hetero(
    base_cfg,
    manifest,
    store,
    class_counts: np.ndarray,
    *,
    fold: int = 0,
    space: Optional[Dict] = None,
    num_samples: int = 20,
    max_epochs: Optional[int] = None,
    grace_period: int = 8,
    reduction_factor: int = 2,
    mesh=None,
    seed: int = 0,
    output_csv: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
):
    """Trial-parallel search over a heterogeneous space (JAX
    tune_parallel.py:240-321). The reference's grids sweep model_size /
    max_patches / drop_out beside lr and reg (main.py:54-206); those fix
    the head and the data, so the sampled trials bucket by them
    (``_bucket_key``) and each bucket trains as one stacked run with per
    lane (lr, reg), padded to a multiple of the mesh's ranks by repeating
    its last trial. One ASHAScheduler kills trials per rung across
    buckets; a bucket whose trials are all dead stops early.

    Returns (best config, rows), by run_tuning's rule (the lowest mean
    validation loss over the last 10 epochs)."""
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.engine.stacked import _fold_axis
    from hipt_abmil_atec23_tpu_torch.engine.tune import (
        DEFAULT_SEARCH_SPACE, ASHAScheduler, apply_trial_config,
        sample_configs, write_rows)

    space = space or DEFAULT_SEARCH_SPACE
    configs = sample_configs(space, num_samples, seed)
    max_t = max_epochs or base_cfg.train.max_epochs
    asha = ASHAScheduler(max_t=max_t, grace_period=grace_period,
                         reduction_factor=reduction_factor)
    ndev = _fold_axis(mesh)[1] if mesh is not None else 1

    buckets: Dict[Tuple, List[int]] = {}
    for i, c in enumerate(configs):
        buckets.setdefault(_bucket_key(c), []).append(i)

    rows: List[Optional[Dict]] = [None] * len(configs)
    for bkey, idxs in buckets.items():
        static = dict(bkey)
        cfg = apply_trial_config(base_cfg, static)
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, max_epochs=max_t,
                                           early_stopping=False))
        datasets = make_fold_datasets(manifest, store, cfg, fold)
        lrs = [float(configs[i].get("lr", base_cfg.train.lr)) for i in idxs]
        regs = [float(configs[i].get("reg", base_cfg.train.reg))
                for i in idxs]
        n_real = len(idxs)
        if n_real % ndev:
            pad = ndev - n_real % ndev
            lrs += [lrs[-1]] * pad
            regs += [regs[-1]] * pad
        if verbose:
            extra = len(lrs) - n_real
            print(f"[tune-hetero] bucket {static}: {n_real} trials"
                  f"{' (+%d pad)' % extra if extra else ''}")
        res = run_trials_parallel(
            cfg, datasets, class_counts, np.asarray(lrs, np.float32),
            np.asarray(regs, np.float32), max_epochs=max_t, mesh=mesh,
            verbose=verbose, asha=asha, n_real=n_real, device=device)
        for j, i in enumerate(idxs):
            vals = res.val_loss[j][~np.isnan(res.val_loss[j])]
            rows[i] = {**configs[i],
                       "epochs": int(len(vals)),
                       "best_val_loss": float(vals.min()),
                       "last10_val_loss": float(
                           vals[-min(10, len(vals)):].mean()),
                       "stopped_epoch": int(res.stopped_epoch[j])}
    if output_csv:
        write_rows(output_csv, rows)
    best = configs[int(np.argmin([r["last10_val_loss"] for r in rows]))]
    return best, rows
