"""Eval stage: per-fold checkpoint inference and bootstrap CIs.

Counterpart of hipt_abmil_atec23_tpu/engine/evaluate.py (reference:
eval.py, utils/eval_utils.py initiate_model/eval/summary,
bootstrapping.py): rebuild the head from the config, load each fold's
``s_{fold}_checkpoint.pt`` (or the JAX package's ``.msgpack``), write
per-slide ``fold_k.csv`` and ``summary.csv``, and pool fold CSVs into
bootstrap confidence intervals computed on the device (engine/metrics.py).
Only ``run_eval`` needs pandas (through the slide manifest).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
from hipt_abmil_atec23_tpu_torch.engine import metrics as M
from hipt_abmil_atec23_tpu_torch.engine.losses import make_per_sample_loss
from hipt_abmil_atec23_tpu_torch.engine.train import (
    FoldResult, build_step_fns, evaluate_split)
from hipt_abmil_atec23_tpu_torch.utils.seeding import host_rng


def evaluate_full_bags_fused(cfg, ds: BagDataset, model,
                             n_pad: int) -> Tuple[np.ndarray, float]:
    """Exact full-bag evaluation: each slide's whole bag (up to ``n_pad``
    rows) goes through ``ops/gated_attention_pool.apply_pooled``, one pool
    kernel launch per slide on the card and its plain version on the CPU,
    with no [N, L] intermediate in memory. The JAX package pads every bag
    to one shape so its kernel compiles once; the CUDA kernel takes any N,
    so each bag goes as it is. Returns (probs [n, C], mean loss)."""
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled)
    loss_fn = make_per_sample_loss(cfg.train.bag_loss)
    device = next(model.parameters()).device
    probs, losses = [], []
    with torch.no_grad():
        for sid, label in zip(ds.slide_ids, ds.labels):
            bag = torch.from_numpy(ds._full_bag(sid)[:n_pad]).to(device)
            out = apply_pooled(model, bag)
            probs.append(out.y_prob[0].cpu().numpy())
            losses.append(float(loss_fn(
                out.logits, torch.tensor([int(label)], device=device))[0]))
    return np.stack(probs), float(np.mean(losses))


def evaluate_fold(cfg, fold: int, ds: BagDataset, class_counts: np.ndarray,
                  models_dir: str, n_pad: Optional[int] = None, *,
                  device="cuda") -> FoldResult:
    """Load fold ``fold``'s checkpoint from ``models_dir`` and run the
    deterministic forward over ``ds`` on ``device``: its ``.pt`` (the
    port's, the reference's or the JAX package's export), else the JAX
    package's own ``s_{fold}_checkpoint.msgpack`` (each package reads its
    own format first and falls back to the other's, JAX evaluate.py:
    76-101).

    A gated single-branch CLAM whose bags are not subsampled
    (``max_patches_per_slide`` unset) takes ``evaluate_full_bags_fused``;
    every other head and setting takes ``evaluate_split``. On an
    un-subsampled bag both compute the same function. The JAX package also
    asks for a padded size of at least 4096 (``FUSED_EVAL_MIN_BAG``, a band
    set on a TPU); the CUDA pool has no size band (ops/
    gated_attention_pool.apply_pooled), so neither has this route."""
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        fold_ckpt, load_mil_state_dict)
    feat_dim = ds._full_bag(ds.slide_ids[0]).shape[1]
    if n_pad is None:
        n_pad = ds.pad_size()
    ds._feat_dim = feat_dim
    fns = build_step_fns(cfg, class_counts, n_pad, feat_dim, device=device)
    model = fns.init_params(torch.Generator().manual_seed(0))
    model.load_state_dict(load_mil_state_dict(
        fold_ckpt(models_dir, fold), cfg.model.model_type,
        cfg.task.n_classes, with_dropout=cfg.model.drop_out > 0,
        keep_instance=True))
    rng = host_rng(cfg.train.seed, 100 + fold)
    fused = (cfg.model.model_type == "clam_sb" and cfg.model.gate
             and cfg.bags.max_patches_per_slide is None)
    if fused:
        probs, loss = evaluate_full_bags_fused(cfg, ds, model, n_pad)
    else:
        probs, loss = evaluate_split(fns, model, ds, n_pad, rng)
    return FoldResult(
        fold=fold, val_auc=float("nan"),
        test_auc=M.auc_score(ds.labels, probs, cfg.task.n_classes),
        val_acc=float("nan"),
        test_acc=M.accuracy(ds.labels, probs.argmax(1)),
        val_loss=float("nan"), test_loss=loss, stopped_epoch=-1,
        test_probs=probs, test_labels=ds.labels,
        test_slide_ids=list(ds.slide_ids))


def run_eval(cfg, manifest, store, models_dir: str, save_dir: str, *,
             splits: str = "test", folds: Optional[Sequence[int]] = None,
             device="cuda"):
    """The eval stage over folds (reference: eval.py:140-246).
    ``splits``: test | val | all. Returns the summary as a pandas
    DataFrame."""
    import pandas as pd
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        _write_fold_csv, make_fold_datasets)
    os.makedirs(save_dir, exist_ok=True)
    cfg.save(os.path.join(save_dir, f"eval_experiment_{cfg.exp_code}.json"))
    folds = list(folds) if folds is not None else list(range(cfg.train.k))
    class_counts = manifest.class_counts()
    rows = []
    for fold in folds:
        if splits == "all":
            ds = BagDataset(manifest.slide_ids, manifest.labels, store,
                            cfg.bags)
        else:
            tr, va, te = make_fold_datasets(manifest, store, cfg, fold)
            ds = {"train": tr, "val": va, "test": te}[splits]
        res = evaluate_fold(cfg, fold, ds, class_counts, models_dir,
                            device=device)
        _write_fold_csv(save_dir, res)
        rows.append({"folds": fold, "test_auc": res.test_auc,
                     "test_acc": res.test_acc, "loss": res.test_loss})
        print(f"[eval] fold {fold}: auc {res.test_auc:.4f} "
              f"acc {res.test_acc:.4f}")
    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(save_dir, "summary.csv"), index=False)
    return df


def read_fold_csvs(dirs: Sequence[str], folds: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(labels [n], probs [n, C]) pooled over every ``fold_k.csv`` found in
    ``dirs`` for ``folds``, in that order. Probability columns ``p_c`` sort
    by their number (p_10 after p_2)."""
    labels: List[int] = []
    probs: List[List[float]] = []
    for d in dirs:
        for k in folds:
            path = os.path.join(d, f"fold_{k}.csv")
            if not os.path.exists(path):
                continue
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    cols = sorted((c for c in row if c.startswith("p_")),
                                  key=lambda c: int(c[2:]))
                    labels.append(int(row["Y"]))
                    probs.append([float(row[c]) for c in cols])
    if not labels:
        raise FileNotFoundError("no fold CSVs found")
    return np.asarray(labels, np.int32), np.asarray(probs, np.float32)


def bootstrap_from_fold_csvs(dirs: Sequence[str], folds: Sequence[int], *,
                             n_bootstraps: int = 100_000, seed: int = 0,
                             device="cuda") -> Dict:
    """Pool fold_k.csv across folds and run repeats and bootstrap AUC / F1
    / accuracy / balanced accuracy on ``device`` (reference:
    bootstrapping.py:24-113). Returns the summary dict with the pooled
    confusion matrix, the slide count and the mean CE loss."""
    labels, probs = read_fold_csvs(dirs, folds)
    res = M.bootstrap_metrics(labels, probs, n_bootstraps=n_bootstraps,
                              seed=seed, device=device)
    out = res.summarize()
    out["confusion_matrix"] = M.confusion_matrix(
        labels, probs.argmax(1), probs.shape[1]).tolist()
    out["n_slides"] = int(len(labels))
    out["mean_ce_loss"] = float(np.mean(
        -np.log(np.maximum(probs[np.arange(len(labels)), labels], 1e-12))))
    return out


def roc_curve_points(labels: np.ndarray, scores: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) at every distinct threshold, binary labels - the curve
    sklearn's roc_curve gives (reference: bootstrapping.py:70)."""
    order = np.argsort(-scores, kind="stable")
    y = labels[order].astype(np.float64)
    tps = np.cumsum(y)
    fps = np.cumsum(1.0 - y)
    # the last point of each tied-score run, and the (0, 0) origin
    distinct = np.r_[np.where(np.diff(scores[order]) != 0)[0], len(y) - 1]
    tpr = np.r_[0.0, tps[distinct] / max(tps[-1], 1e-12)]
    fpr = np.r_[0.0, fps[distinct] / max(fps[-1], 1e-12)]
    return fpr, tpr


def plot_roc_curves(dirs: Sequence[str], folds: Sequence[int],
                    out_path: str) -> str:
    """One pooled ROC curve per run-repeat dir on one figure (reference:
    bootstrapping.py --plot_roc_curves, :69-77). Binary only."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    for rep, d in enumerate(dirs):
        try:
            labels, probs = read_fold_csvs([d], folds)
        except FileNotFoundError:
            continue
        fpr, tpr = roc_curve_points(labels, probs[:, 1].astype(np.float64))
        auc = float(np.trapezoid(tpr, fpr))
        label = f"Repeat {rep + 1} (AUC {auc:.3f})" if len(dirs) > 1 \
            else f"AUC {auc:.3f}"
        ax.plot(fpr, tpr, label=label)
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.legend(loc="lower right")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
