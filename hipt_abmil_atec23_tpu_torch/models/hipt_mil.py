"""HIPT global (WSI-level) aggregator: the pooling head of HIPT_LGP_FC.

Counterpart of hipt_abmil_atec23_tpu/models/hipt_mil.py. The reference's
kNN probe aggregates a slide's [N, 192] region features into one 192-d WSI
embedding with the pretrained HIPT_LGP_FC global branch of the external
mahmoodlab/HIPT repo (reference: HIPT_knn.py:8-28): ``global_phi``
Linear + ReLU, a 2-layer post-norm ``nn.TransformerEncoder`` (d_model 192,
3 heads, FFN 192, ReLU), ``global_attn_pool`` gated attention and
``global_rho`` Linear + ReLU. The module keeps the reference's parameter
names, so the external checkpoint's global branch loads with
``load_state_dict`` (``strict=False`` past the local branch's keys).

Eval semantics (dropout off), as in the JAX package: the reference script
never calls ``.eval()``, so its dropouts are live at probe time; the
DINO-probe protocol intends them off. The JAX package computes this outside
any Pallas kernel, so it is plain PyTorch here too.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

EMBED = 192
HEADS = 3


class GatedAttentionPool(nn.Module):
    """Attn_Net_Gated(L=192, D=192, n_classes=1) of the reference
    (attention_a / attention_b Sequentials with their Dropout slots,
    attention_c)."""

    def __init__(self, dim: int = EMBED, dropout: float = 0.25):
        super().__init__()
        self.attention_a = nn.Sequential(nn.Linear(dim, dim), nn.Tanh(),
                                         nn.Dropout(dropout))
        self.attention_b = nn.Sequential(nn.Linear(dim, dim), nn.Sigmoid(),
                                         nn.Dropout(dropout))
        self.attention_c = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_c(self.attention_a(x) * self.attention_b(x))


class HIPTGlobalAggregator(nn.Module):
    """The global branch of HIPT_LGP_FC: [N, 192] region features -> [192]
    (reference: HIPT_knn.py:19-27 agg_slide_feature)."""

    def __init__(self, depth: int = 2, dropout: float = 0.25):
        super().__init__()
        self.global_phi = nn.Sequential(nn.Linear(EMBED, EMBED), nn.ReLU(),
                                        nn.Dropout(dropout))
        layer = nn.TransformerEncoderLayer(
            d_model=EMBED, nhead=HEADS, dim_feedforward=EMBED,
            dropout=dropout, activation="relu")
        self.global_transformer = nn.TransformerEncoder(
            layer, num_layers=depth, enable_nested_tensor=False)
        self.global_attn_pool = GatedAttentionPool(EMBED, dropout)
        self.global_rho = nn.Sequential(nn.Linear(EMBED, EMBED), nn.ReLU(),
                                        nn.Dropout(dropout))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.global_phi(feats)
        # sequence over the regions, a batch of one (batch_first=False)
        x = self.global_transformer(x[:, None])[:, 0]
        w = torch.softmax(self.global_attn_pool(x)[:, 0], dim=0)
        return self.global_rho(w @ x)


def init_hipt_lgp_params(rng: np.random.Generator, depth: int = 2
                         ) -> Dict[str, Any]:
    """Random (xavier-normal) parameters in the JAX package's layout, the
    JAX package's draws from ``rng`` (hipt_mil.py:84-107), for running the
    probe without the external checkpoint: ``default_rng(0)`` gives both
    packages one aggregator. Convert with
    ``models/convert.hipt_lgp_state_dict_from_jax``."""
    def lin(n_in, n_out):
        s = float(np.sqrt(2.0 / (n_in + n_out)))
        return {"kernel": rng.normal(0, s, (n_in, n_out)).astype(np.float32),
                "bias": np.zeros(n_out, np.float32)}

    def ln():
        return {"scale": np.ones(EMBED, np.float32),
                "bias": np.zeros(EMBED, np.float32)}

    layers = []
    for _ in range(depth):
        layers.append({
            "attn": {"in_proj_kernel": lin(EMBED, 3 * EMBED)["kernel"],
                     "in_proj_bias": np.zeros(3 * EMBED, np.float32),
                     "out_proj": lin(EMBED, EMBED)},
            "norm1": ln(), "norm2": ln(),
            "linear1": lin(EMBED, EMBED), "linear2": lin(EMBED, EMBED)})
    return {"phi": lin(EMBED, EMBED), "layers": layers,
            "attn_a": lin(EMBED, EMBED), "attn_b": lin(EMBED, EMBED),
            "attn_c": lin(EMBED, 1), "rho": lin(EMBED, EMBED)}


def build_hipt_lgp(state_dict: Optional[Mapping[str, Any]] = None, *,
                   device="cuda") -> HIPTGlobalAggregator:
    """The aggregator in eval mode on ``device`` with ``state_dict`` (a
    HIPT_LGP_FC checkpoint's; keys outside the global branch are ignored),
    or, without one, the checkpoint-free weights of
    ``init_hipt_lgp_params(default_rng(0))``."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        hipt_lgp_state_dict_from_jax)
    model = HIPTGlobalAggregator()
    if state_dict is None:
        state_dict = hipt_lgp_state_dict_from_jax(
            init_hipt_lgp_params(np.random.default_rng(0)))
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"HIPT_LGP state dict lacks {missing[:4]}")
    model.load_state_dict({k: torch.as_tensor(state_dict[k]).float()
                           for k in own})
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def hipt_lgp_aggregate(model: HIPTGlobalAggregator, feats) -> torch.Tensor:
    """[N, 192] region features (ndarray or tensor) -> [192] WSI embedding
    on the model's device."""
    dev = next(model.parameters()).device
    return model(torch.as_tensor(feats, dtype=torch.float32).to(dev))
