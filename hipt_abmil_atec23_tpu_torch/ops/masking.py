"""Masked-bag primitives (counterpart of hipt_abmil_atec23_tpu/ops/
masking.py): a bag is a fixed-size [N, D] buffer plus a bool [N] validity
mask."""
from __future__ import annotations

import numpy as np
import torch

# large-but-finite sentinel, as in the JAX package: a fully-masked row stays
# well defined and its weights are zeroed by the mask afterwards
NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to positions where ``mask`` is True.
    Padded positions get exactly 0; a fully-masked row returns zeros."""
    mask = mask.to(torch.bool)
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask.to(scores.dtype)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.clamp(denom, min=torch.finfo(scores.dtype).tiny)


def pad_bag(features: np.ndarray, n_pad: int):
    """Host-side: pad an [n, D] bag to [n_pad, D]; returns (padded, mask)."""
    n, d = features.shape
    if n > n_pad:
        raise ValueError(f"bag of size {n} does not fit padded size {n_pad}")
    out = np.zeros((n_pad, d), dtype=features.dtype)
    out[:n] = features
    mask = np.zeros((n_pad,), dtype=bool)
    mask[:n] = True
    return out, mask
