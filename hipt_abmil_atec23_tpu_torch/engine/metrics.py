"""Classification metrics and the vectorised bootstrap on the device.

Counterpart of hipt_abmil_atec23_tpu/engine/metrics.py. The per-epoch
metrics are small host computations (rank-based AUC, exact parity with
sklearn's roc_auc_score). The bootstrap replaces the reference's
100,000-iteration Python loop (reference: bootstrapping.py:78-87) with one
device computation per chunk of resamples: each resample is a multinomial
weight vector over the samples, and its AUC a weighted Mann-Whitney
statistic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney U statistic (tie-aware midranks);
    numerically identical to sklearn.roc_auc_score for binary labels."""
    labels = np.asarray(labels).astype(np.int32)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _midranks(scores)
    u = ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _midranks(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def multiclass_auc_ovr(labels: np.ndarray, probs: np.ndarray) -> float:
    """One-vs-rest macro AUC, NaN-skipping classes absent from labels
    (reference: utils/core_utils.py:553-563)."""
    n_classes = probs.shape[1]
    aucs = []
    for c in range(n_classes):
        if c in labels:
            aucs.append(binary_auc((labels == c).astype(int), probs[:, c]))
        else:
            aucs.append(float("nan"))
    return float(np.nanmean(aucs))


def auc_score(labels: np.ndarray, probs: np.ndarray, n_classes: int) -> float:
    if n_classes == 2:
        return binary_auc(labels, probs[:, 1])
    return multiclass_auc_ovr(labels, probs)


def accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    return float(np.mean(np.asarray(preds) == np.asarray(labels)))


def balanced_accuracy(labels: np.ndarray, preds: np.ndarray,
                      n_classes: int) -> float:
    recalls = []
    for c in range(n_classes):
        m = labels == c
        if m.any():
            recalls.append(float(np.mean(preds[m] == c)))
    return float(np.mean(recalls))


def f1_binary(labels: np.ndarray, preds: np.ndarray) -> float:
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    for t, p in zip(labels.astype(int), preds.astype(int)):
        cm[t, p] += 1
    return cm


class ClassAccuracyLogger:
    """Per-class count/correct accumulation (reference:
    Accuracy_Logger, utils/core_utils.py:17-50)."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.count = np.zeros(n_classes, np.int64)
        self.correct = np.zeros(n_classes, np.int64)

    def log_batch(self, y_hat: np.ndarray, y: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> None:
        y_hat = np.asarray(y_hat).astype(int).ravel()
        y = np.asarray(y).astype(int).ravel()
        if valid is None:
            valid = np.ones_like(y, dtype=bool)
        valid = np.asarray(valid).astype(bool).ravel()
        for c in range(self.n_classes):
            m = (y == c) & valid
            self.count[c] += int(m.sum())
            self.correct[c] += int((y_hat[m] == c).sum())

    def summary(self, c: int):
        cnt = int(self.count[c])
        return (self.correct[c] / cnt if cnt else None,
                int(self.correct[c]), cnt)


# --------------------------------------------------------------------------
# Vectorised bootstrap (device)
# --------------------------------------------------------------------------

@dataclass
class BootstrapResult:
    auc: np.ndarray           # [B]
    f1: np.ndarray            # [B] (macro for multiclass)
    acc: np.ndarray           # [B]
    balanced_acc: np.ndarray  # [B]

    def summarize(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in ("auc", "f1", "acc", "balanced_acc"):
            v = getattr(self, name)
            out[name] = {"mean": float(np.nanmean(v)),
                         "std": float(np.nanstd(v))}
        return out


def bootstrap_metrics(labels: np.ndarray, probs: np.ndarray,
                      n_bootstraps: int = 100_000, seed: int = 0,
                      batch: int = 10_000, *, device="cuda"
                      ) -> BootstrapResult:
    """AUC / F1 / accuracy / balanced accuracy of ``n_bootstraps``
    resamples, ``batch`` resamples per device computation. Each chunk's
    [b, n] resample indices come from one ``torch.Generator`` on
    ``device`` seeded with ``seed`` (torch's stream, not JAX's: the two
    packages draw different resamples from one seed)."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    device = resolve_device(device)
    labels = torch.as_tensor(np.asarray(labels).astype(np.int64),
                             device=device)
    probs = torch.as_tensor(np.asarray(probs, dtype=np.float32),
                            device=device)
    preds = probs.argmax(1)
    n = len(labels)
    g = torch.Generator(device=device).manual_seed(seed)
    chunks = []
    done = 0
    while done < n_bootstraps:
        b = min(batch, n_bootstraps - done)
        idx = torch.randint(0, n, (b, n), generator=g, device=device)
        chunks.append(bootstrap_chunk(labels, probs, preds, idx,
                                      probs.shape[1]))
        done += b
    return BootstrapResult(*[torch.cat([c[i] for c in chunks]).cpu().numpy()
                             for i in range(4)])


def bootstrap_chunk(labels: torch.Tensor, probs: torch.Tensor,
                    preds: torch.Tensor, idx: torch.Tensor, n_classes: int
                    ) -> Tuple[torch.Tensor, ...]:
    """(auc, f1, acc, balanced_acc), each [b], of the resamples ``idx``
    [b, n] (rows of sample indices), as the JAX package's
    ``_bootstrap_chunk`` computes them (metrics.py:201-234). F1 is class
    1's for two classes and the macro mean otherwise; the multi-class AUC
    and the balanced accuracy average over the classes present in a
    resample."""
    lab, prd = labels[idx], preds[idx]                          # [b, n]
    acc = (lab == prd).float().mean(1)
    cls = torch.arange(n_classes, device=idx.device)[:, None, None]
    is_c, pred_c = lab[None] == cls, prd[None] == cls           # [C, b, n]
    tp = (is_c & pred_c).sum(2).float()
    fp = (~is_c & pred_c).sum(2).float()
    fn = (is_c & ~pred_c).sum(2).float()
    support = is_c.sum(2).float()
    has = support > 0
    n_has = torch.clamp(has.float().sum(0), min=1.0)
    recall = tp / torch.clamp(support, min=1.0)
    bal_acc = torch.where(has, recall, torch.zeros_like(recall)).sum(0) / n_has
    f1_c = 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)
    if n_classes == 2:
        return weighted_auc(labels, probs[:, 1], idx), f1_c[1], acc, bal_acc
    aucs = torch.stack([weighted_auc((labels == c).long(), probs[:, c], idx)
                        for c in range(n_classes)])             # [C, b]
    auc = torch.where(has, aucs, torch.zeros_like(aucs)).sum(0) / n_has
    return auc, f1_c.mean(0), acc, bal_acc


def weighted_auc(labels: torch.Tensor, scores: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """The AUC of each resample in ``idx`` [b, n]. With w_i the
    multiplicity of sample i, AUC = sum over positive i, negative j of
    w_i w_j ([s_i > s_j] + 0.5 [s_i == s_j]) / (P N), from the cumulative
    negative weight below each tie group of the sorted scores: O(b n) after
    one sort. NaN where a resample lacks a class."""
    b, n = idx.shape
    w = torch.zeros(b, n, device=idx.device).scatter_add_(
        1, idx, torch.ones(b, n, device=idx.device))
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    pos = (labels[order] == 1).float()
    w = w[:, order]
    wp, wn = w * pos, w * (1.0 - pos)
    new_group = torch.ones(n, dtype=torch.bool, device=idx.device)
    new_group[1:] = s[1:] != s[:-1]
    starts = torch.nonzero(new_group)[:, 0]
    ends = torch.cat([starts[1:] - 1, starts.new_tensor([n - 1])])
    group = torch.cumsum(new_group.long(), 0) - 1
    cum = torch.cumsum(wn, 1)
    below = (cum - wn)[:, starts[group]]       # negative weight below the group
    tied = cum[:, ends[group]] - below         # negative weight in the group
    u = (wp * (below + 0.5 * tied)).sum(1)
    p, q = wp.sum(1), wn.sum(1)
    return torch.where((p > 0) & (q > 0), u / torch.clamp(p * q, min=1.0),
                       torch.full_like(u, float("nan")))
