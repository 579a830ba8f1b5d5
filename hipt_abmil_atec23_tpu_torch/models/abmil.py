"""CLAM_SB, the single-branch gated-attention MIL head (forward only).

Counterpart of hipt_abmil_atec23_tpu/models/abmil.py CLAM_SB's
deterministic forward and ``attention_only``; CLAM_MB, MIL_fc and the
instance-clustering loss are not ported yet. The module keeps the
reference's layout (models/model_clam.py:77-191): ``attention_net.0`` the
fc Linear, ``attention_net.2.attention_{a,b}.0`` and
``attention_net.2.attention_c`` the gated scorer, ``classifiers`` the bag
classifier, so reference checkpoints load as they are.

Forward contract: ``MILOutput(logits [1, C], y_prob [1, C], y_hat [1],
a_raw [1, N], extras)``, the reference's 5-tuple.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu_torch.ops.masking import masked_softmax

# [input_dim, hidden_dim, attention_dim] (reference: models/model_clam.py:81)
MIL_SIZE_DICT = {
    "tinier3": [1024, 32, 8],
    "256": [256, 64, 16],
    "tinier_resnet18": [512, 64, 16],
    "tinier2_resnet18": [512, 32, 8],
    "tiny_resnet18": [512, 128, 32],
    "small_resnet18": [512, 256, 64],
    "tinier": [1024, 64, 16],
    "tiny128": [1024, 128, 32],
    "tiny": [1024, 256, 64],
    "small": [1024, 512, 256],
    "big": [1024, 512, 384],
    "hipt_big": [192, 128, 64],
    "hipt_medium": [192, 64, 32],
    "hipt_small": [192, 32, 16],
    "hipt_smaller": [192, 16, 8],
    "hipt_smallest": [192, 8, 4],
}


class MILOutput(NamedTuple):
    logits: torch.Tensor   # [1, C]
    y_prob: torch.Tensor   # [1, C]
    y_hat: torch.Tensor    # [1]
    a_raw: torch.Tensor    # [1, N] pre-softmax attention
    extras: Dict[str, Any]


class AttnNetGated(nn.Module):
    """A = W_c(tanh(W_a h) * sigmoid(W_b h)) (reference:
    models/model_clam.py:41-64)."""

    def __init__(self, dim_in: int, dim_attn: int, n_branches: int = 1):
        super().__init__()
        self.attention_a = nn.Sequential(nn.Linear(dim_in, dim_attn),
                                         nn.Tanh())
        self.attention_b = nn.Sequential(nn.Linear(dim_in, dim_attn),
                                         nn.Sigmoid())
        self.attention_c = nn.Linear(dim_attn, n_branches)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.attention_c(self.attention_a(h) * self.attention_b(h))


class CLAM_SB(nn.Module):
    """Single-branch gated CLAM; inference forward (dropout is identity)."""

    multi_branch = False
    gate = True

    def __init__(self, size_arg: str = "small", n_classes: int = 2):
        super().__init__()
        size = MIL_SIZE_DICT[size_arg]
        self.size = size
        self.n_classes = n_classes
        self.attention_net = nn.Sequential(
            nn.Linear(size[0], size[1]), nn.ReLU(),
            AttnNetGated(size[1], size[2], 1))
        self.classifiers = nn.Linear(size[1], n_classes)

    def forward(self, bag: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attention_only: bool = False):
        """bag [N, D_in], mask [N] bool (None: all valid)."""
        fc, relu, attn = self.attention_net
        h = relu(fc(bag))                               # [N, L]
        a_raw = attn(h).t()                             # [1, N]
        if attention_only:
            return a_raw
        if mask is None:
            mask = torch.ones(bag.shape[0], dtype=torch.bool,
                              device=bag.device)
        a_soft = masked_softmax(a_raw, mask[None, :], dim=-1)
        logits = self.classifiers(a_soft @ h)           # [1, C]
        y_prob = torch.softmax(logits, dim=-1)
        y_hat = torch.argmax(logits, dim=-1)
        return MILOutput(logits, y_prob, y_hat, a_raw, {})


def init_reference_weights(model: nn.Module,
                           generator: Optional[torch.Generator] = None
                           ) -> nn.Module:
    """The reference's initialisation (utils/utils.py:217-226): every
    Linear gets xavier-normal weights and zero bias. (The JAX package draws
    flax's truncated glorot normal instead, so the two packages start from
    different weights for one seed.)"""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_normal_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
    return model


def build_mil_model(model_type: str, *, size_arg: str = "small",
                    n_classes: int = 2, gate: bool = True) -> CLAM_SB:
    """Model-type dispatch (reference: main.py:329); only the gated
    CLAM_SB is ported."""
    if model_type != "clam_sb" or not gate:
        raise NotImplementedError(
            f"model_type={model_type!r}, gate={gate}: only the gated clam_sb "
            "head is ported to hipt_abmil_atec23_tpu_torch")
    return CLAM_SB(size_arg=size_arg, n_classes=n_classes)
