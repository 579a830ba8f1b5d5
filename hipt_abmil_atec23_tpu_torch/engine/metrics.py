"""Host-side classification metrics.

The port's own copy of the numpy half of
hipt_abmil_atec23_tpu/engine/metrics.py: rank-based AUC (exact parity with
sklearn's roc_auc_score), one-vs-rest macro AUC and accuracy. The
vectorised bootstrap belongs with the evaluation path, not ported yet.
"""
from __future__ import annotations

import numpy as np


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
