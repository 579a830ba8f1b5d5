"""Bag-level losses: CE, class-balanced CE, smooth top-1 SVM.

Counterpart of hipt_abmil_atec23_tpu/engine/losses.py (the reference's
registry: main.py --bag_loss {ce,balanced_ce,svm}, utils/core_utils.py:
141-154). As there, ``balanced_ce`` weighs the classes across a batch
(sum w_i nll_i / sum w_i, torch's weighted mean); at batch size 1 the
weighting cancels, as it does in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def balanced_class_weights(class_counts: np.ndarray) -> np.ndarray:
    """w_c = (1/count_c) * (sum(counts)/n_classes)
    (reference: utils/core_utils.py:148)."""
    counts = np.asarray(class_counts, dtype=np.float64)
    return ((1.0 / np.maximum(counts, 1.0)) * (counts.sum() / len(counts))
            ).astype(np.float32)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Mean CE over the batch; optional per-class weights with torch's
    weighted-mean normalisation (sum w*nll / sum w)."""
    nll = _nll(logits, labels)
    if class_weights is None:
        return nll.mean()
    w = class_weights.to(logits.device)[labels.long()]
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-8)


def _svm(logits: torch.Tensor, labels: torch.Tensor, tau: float = 1.0,
         alpha: float = 1.0) -> torch.Tensor:
    """Per-sample smooth top-1 SVM (Berrada et al. 2018):
    tau * logsumexp((s_j + alpha [j != y]) / tau) - s_y."""
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]
                                         ).to(logits.dtype)
    aug = logits + alpha * (1.0 - onehot)
    lse = tau * torch.logsumexp(aug / tau, dim=-1)
    return lse - torch.gather(logits, -1, labels.long()[:, None])[:, 0]


def smooth_top1_svm(logits: torch.Tensor, labels: torch.Tensor,
                    tau: float = 1.0, alpha: float = 1.0) -> torch.Tensor:
    """The ``svm`` bag loss (reference: topk.svm.SmoothTop1SVM at
    utils/core_utils.py:142-146), the batch mean."""
    return _svm(logits, labels, tau, alpha).mean()


def make_per_sample_loss(name: str
                         ) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """Per-slide validation loss, a [B] vector (reference: validate()
    applies loss_fn per slide at batch size 1, core_utils.py:464,527). At
    batch 1 balanced_ce's weighting cancels, so ce and balanced_ce are both
    the NLL there; svm keeps its per-slide value."""
    if name in ("ce", "balanced_ce"):
        return _nll
    if name == "svm":
        return _svm
    raise ValueError(f"unknown bag loss {name!r}")


def make_bag_loss(name: str, class_counts: Optional[np.ndarray] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if name == "ce":
        return cross_entropy
    if name == "balanced_ce":
        if class_counts is None:
            raise ValueError("balanced_ce requires class_counts")
        w = torch.from_numpy(balanced_class_weights(class_counts))
        return lambda logits, labels: cross_entropy(logits, labels, w)
    if name == "svm":
        return smooth_top1_svm
    raise ValueError(f"unknown bag loss {name!r}")
