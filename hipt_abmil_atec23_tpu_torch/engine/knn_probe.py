"""Slide-level kNN probe over aggregated region features.

Counterpart of hipt_abmil_atec23_tpu/engine/knn_probe.py (reference:
HIPT_knn.py): aggregate each slide's region features into one vector (mean
or max pooling, or the pretrained HIPT_LGP_FC global branch of
models/hipt_mil.py) and classify with the DINO-style weighted kNN
classifier (temperature-scaled cosine similarity voting; reference:
HIPT_knn.py:40-79, T=1). Aggregation and the vote run on the caller's
device; AUC and accuracy are computed on the host (engine/metrics.py).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def aggregate_slide_features(store, slide_ids, method: str = "mean",
                             lgp_state: Optional[Mapping] = None, *,
                             device="cuda") -> np.ndarray:
    """Per-slide embedding [n_slides, D] f32 from the region-feature bags,
    computed on ``device``.

    ``method='hipt_lgp'`` is the reference's aggregation, the HIPT_LGP_FC
    global-pooling branch (reference: HIPT_knn.py:19-27): pass the
    checkpoint's state dict as ``lgp_state`` (or omit it for the
    checkpoint-free weights both packages draw from ``default_rng(0)``).
    ``'mean'`` / ``'max'`` are checkpoint-free alternatives."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if method == "hipt_lgp":
        from hipt_abmil_atec23_tpu_torch.models.hipt_mil import (
            build_hipt_lgp, hipt_lgp_aggregate)
        model = build_hipt_lgp(lgp_state, device=device)
        agg = lambda f: hipt_lgp_aggregate(model, f)
    elif method == "mean":
        agg = lambda f: f.mean(0)
    elif method == "max":
        agg = lambda f: f.amax(0)
    else:
        raise ValueError(method)
    out = [agg(torch.as_tensor(store.load_features(sid),
                               dtype=torch.float32).to(device))
           for sid in slide_ids]
    return torch.stack(out).cpu().numpy().astype(np.float32)


def _knn_vote(train_x: torch.Tensor, train_y: torch.Tensor,
              test_x: torch.Tensor, k: int, n_classes: int,
              temperature: float) -> torch.Tensor:
    """DINO knn_classifier semantics: cosine similarity, top-k neighbours
    (equal similarities lower index first, as ``lax.top_k``), an
    exp(sim/T)-weighted one-hot vote; [n_test, n_classes] normalised."""
    tr = train_x / torch.clamp(train_x.norm(dim=1, keepdim=True), min=1e-8)
    te = test_x / torch.clamp(test_x.norm(dim=1, keepdim=True), min=1e-8)
    sim = te @ tr.T                                  # [n_test, n_train]
    srt = torch.sort(sim, dim=1, descending=True, stable=True)
    topv, topi = srt.values[:, :k], srt.indices[:, :k]
    w = torch.exp(topv / temperature)                # [n_test, k]
    votes = torch.nn.functional.one_hot(train_y[topi].long(),
                                        n_classes).to(w.dtype)
    scores = torch.einsum("tk,tkc->tc", w, votes)
    return scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-8)


def knn_classify(train_x: np.ndarray, train_y: np.ndarray,
                 test_x: np.ndarray, *, k: int = 20, n_classes: int = 2,
                 temperature: float = 1.0, device="cuda") -> np.ndarray:
    """Returns [n_test, n_classes] class probabilities, voted on
    ``device``."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device, true_f32
    device = resolve_device(device)
    k = min(k, len(train_x))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    with true_f32():
        probs = _knn_vote(t(train_x), torch.as_tensor(
            np.asarray(train_y, np.int64)).to(device), t(test_x), k,
            n_classes, temperature)
    return probs.cpu().numpy()


def knn_cv_probe(store, manifest, splits, *, k: int = 20,
                 temperature: float = 1.0, method: str = "mean",
                 lgp_state: Optional[Mapping] = None,
                 device="cuda") -> Dict[str, float]:
    """k-fold kNN probe (reference: HIPT_knn.py main loop) on ``device``.
    Returns mean AUC / acc across folds."""
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    ids = list(manifest.slide_ids)
    labels = manifest.labels
    feats = aggregate_slide_features(store, ids, method, lgp_state,
                                     device=device)
    aucs, accs = [], []
    for train_idx, _, test_idx in splits:
        probs = knn_classify(feats[train_idx], labels[train_idx],
                             feats[test_idx], k=k,
                             n_classes=manifest.n_classes,
                             temperature=temperature, device=device)
        aucs.append(M.auc_score(labels[test_idx], probs, manifest.n_classes))
        accs.append(M.accuracy(labels[test_idx], probs.argmax(1)))
    return {"auc_mean": float(np.mean(aucs)), "auc_std": float(np.std(aucs)),
            "acc_mean": float(np.mean(accs))}
