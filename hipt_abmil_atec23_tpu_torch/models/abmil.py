"""Attention-based MIL heads: CLAM_SB, CLAM_MB, MIL_fc and MIL_fc_mc.

Counterpart of hipt_abmil_atec23_tpu/models/abmil.py. The modules keep the
reference's layout (models/model_clam.py, models/model_mil.py), so
reference checkpoints and the JAX package's exports load as they are:

- CLAM: ``attention_net.0`` the fc Linear; the scorer at ``attention_net.2``,
  or ``.3`` in a dropout build (its Dropout holds slot 2). The gated scorer
  is ``attention_a.0``, ``attention_b.0``, ``attention_c``; the ungated one
  ``module.0`` and ``module.2`` (``.3`` with dropout). ``classifiers`` is the
  bag classifier of CLAM_SB and ``classifiers.{c}`` the per-class
  ``Linear(L, 1)`` of CLAM_MB; ``instance_classifiers.{c}`` the per-class
  ``Linear(L, 2)`` of the clustering loss.
- MIL_fc: ``classifier.0`` the fc Linear and ``classifier.2`` (``.3`` with
  dropout) the instance classifier. MIL_fc_mc: ``fc.0`` and the per-class
  ``classifiers.{c}`` ``Linear(L, 1)``.

Every head takes one bag [N, D] with a bool mask [N] and returns the
reference's 5-tuple ``MILOutput(logits [1, C], y_prob [1, C], y_hat [1],
a_raw [K, N], extras)``, or a batch [B, N, D] with mask [B, N] (and labels
[B]), when every output gains a leading B (logits [B, C], a_raw [B, K, N],
``extras["instance_loss"]`` [B]). Dropout draws its masks from an explicit
``torch.Generator`` (``nn.Dropout`` takes none), so one seed gives one run.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu_torch.ops.masking import (
    masked_bottom_k, masked_softmax, masked_top_k)

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
MIL_FC_SIZE = [1024, 512]  # reference: models/model_mil.py:11


class MILOutput(NamedTuple):
    logits: torch.Tensor   # [1, C]
    y_prob: torch.Tensor   # [1, C]
    y_hat: torch.Tensor    # [1]
    a_raw: torch.Tensor    # [K, N] pre-softmax attention (K=1 SB, C MB)
    extras: Dict[str, Any]


class Dropout(nn.Module):
    """Inverted dropout with its mask from an explicit generator: keeps an
    element with probability 1 - p and scales it by 1 / (1 - p), as flax's
    Dropout does. Holds the reference's Dropout slot in a layout."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class AttnNet(nn.Module):
    """Linear -> Tanh -> (Dropout) -> Linear (reference:
    models/model_clam.py:15-31)."""

    def __init__(self, dim_in: int, dim_attn: int, n_branches: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        layers = [nn.Linear(dim_in, dim_attn), nn.Tanh()]
        if dropout > 0:
            layers.append(Dropout(dropout))
        layers.append(nn.Linear(dim_attn, n_branches))
        self.module = nn.Sequential(*layers)

    def forward(self, h: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = torch.tanh(self.module[0](h))
        if len(self.module) == 4:
            a = self.module[2](a, train, generator)
        return self.module[-1](a)


class AttnNetGated(nn.Module):
    """A = W_c(tanh(W_a h) * sigmoid(W_b h)), each half with its own
    dropout (reference: models/model_clam.py:41-64)."""

    def __init__(self, dim_in: int, dim_attn: int, n_branches: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        a = [nn.Linear(dim_in, dim_attn), nn.Tanh()]
        b = [nn.Linear(dim_in, dim_attn), nn.Sigmoid()]
        if dropout > 0:
            a.append(Dropout(dropout))
            b.append(Dropout(dropout))
        self.attention_a = nn.Sequential(*a)
        self.attention_b = nn.Sequential(*b)
        self.attention_c = nn.Linear(dim_attn, n_branches)

    def forward(self, h: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = torch.tanh(self.attention_a[0](h))
        b = torch.sigmoid(self.attention_b[0](h))
        if len(self.attention_a) == 3:
            a = self.attention_a[2](a, train, generator)
            b = self.attention_b[2](b, train, generator)
        return self.attention_c(a * b)


def _masked_ce(logits: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean NLL over the second-to-last dim: logits [..., M, 2],
    targets [M], weights [..., M]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.expand(logp.shape[:-1])[..., None]
                        )[..., 0]
    return (nll * weights).sum(-1) / torch.clamp(weights.sum(-1), min=1.0)


def _squeeze(out: MILOutput) -> MILOutput:
    """A batch of one back to the one-bag contract."""
    return MILOutput(out.logits, out.y_prob, out.y_hat, out.a_raw[0],
                     {k: v[0] for k, v in out.extras.items()})


def _batched(bag, mask, label):
    single = bag.dim() == 2
    if single:
        bag = bag[None]
        mask = None if mask is None else mask[None]
        if label is not None:
            label = torch.as_tensor(label, device=bag.device).reshape(1)
    if mask is None:
        mask = torch.ones(bag.shape[:2], dtype=torch.bool, device=bag.device)
    return single, bag, mask.to(torch.bool), label


class _CLAMBase(nn.Module):
    """Shared trunk: fc projection, attention scorer, instance classifiers.
    Single-branch unless ``multi_branch``."""

    multi_branch = False

    def __init__(self, size_arg: str = "small", n_classes: int = 2, *,
                 gate: bool = True, dropout: float = 0.0, k_sample: int = 8,
                 subtyping: bool = False):
        super().__init__()
        size = MIL_SIZE_DICT[size_arg]
        self.size = size
        self.gate = gate
        self.dropout = float(dropout)
        self.k_sample = k_sample
        self.n_classes = n_classes
        self.subtyping = subtyping
        n_branches = n_classes if self.multi_branch else 1
        scorer = (AttnNetGated if gate else AttnNet)(
            size[1], size[2], n_branches, self.dropout)
        fc = [nn.Linear(size[0], size[1]), nn.ReLU()]
        if self.dropout > 0:
            fc.append(Dropout(self.dropout))
        self.attention_net = nn.Sequential(*fc, scorer)
        if self.multi_branch:
            self.classifiers = nn.ModuleList(
                [nn.Linear(size[1], 1) for _ in range(n_classes)])
        else:
            self.classifiers = nn.Linear(size[1], n_classes)
        self.instance_classifiers = nn.ModuleList(
            [nn.Linear(size[1], 2) for _ in range(n_classes)])

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """As nn.Module's, except that a state dict without instance
        classifiers (an inference export) keeps this head's own, as the JAX
        package's evaluate_fold keeps its initialised ones."""
        if not any(k.startswith("instance_classifiers.") for k in state_dict):
            own = {k: v for k, v in self.state_dict().items()
                   if k.startswith("instance_classifiers.")}
            state_dict = {**own, **state_dict}
        return super().load_state_dict(state_dict, strict, assign)

    def forward(self, bag: torch.Tensor, mask: Optional[torch.Tensor] = None,
                label=None, instance_eval: bool = False,
                attention_only: bool = False, return_features: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """bag [N, D_in] (or [B, N, D_in]), mask [N] bool (None: all valid).
        ``instance_eval`` adds the clustering loss for ``label``;
        ``deterministic=False`` applies dropout from ``generator``."""
        single, bag, mask, label = _batched(bag, mask, label)
        train = not deterministic
        h = torch.relu(self.attention_net[0](bag))            # [B, N, L]
        if self.dropout > 0:
            h = self.attention_net[2](h, train, generator)
        # the reference transposes before the softmax (model_clam.py:150)
        a_raw = self.attention_net[-1](h, train, generator).transpose(1, 2)
        if attention_only:
            return a_raw[0] if single else a_raw               # [B, K, N]
        a_soft = masked_softmax(a_raw, mask[:, None, :], dim=-1)
        extras: Dict[str, Any] = {}
        if instance_eval:
            if label is None:
                raise ValueError("instance_eval requires a label")
            extras.update(self._instance_loss(a_soft, h, mask, label))
        m = a_soft @ h                                          # [B, K, L]
        if self.multi_branch:
            w = torch.stack([c.weight[0] for c in self.classifiers])
            b = torch.stack([c.bias[0] for c in self.classifiers])
            logits = (m * w).sum(-1) + b                        # [B, C]
        else:
            logits = self.classifiers(m[:, 0])
        if return_features:
            extras["features"] = m
        out = MILOutput(logits, torch.softmax(logits, dim=-1),
                        torch.argmax(logits, dim=-1), a_raw, extras)
        return _squeeze(out) if single else out

    def _instance_loss(self, a_soft, h, mask, label) -> Dict[str, Any]:
        """CLAM's instance-level clustering loss with every class evaluated
        at once (JAX abmil.py:104-173): for the label's class the top-k
        attended instances are pseudo-labelled 1 and the bottom-k 0; for the
        other classes (subtyping only) the top-k are labelled 0. Both
        variants are computed for every class and blended with one-hot
        weights, so no branch depends on the label."""
        bsz, _, n = a_soft.shape
        c, k = self.n_classes, self.k_sample
        scores = a_soft if self.multi_branch else a_soft.expand(bsz, c, n)
        m = mask[:, None, :].expand(bsz, c, n)
        _, top_idx, top_valid = masked_top_k(scores, m, k)      # [B, C, k]
        _, bot_idx, bot_valid = masked_bottom_k(scores, m, k)
        idx = torch.cat([top_idx, bot_idx], -1)                 # [B, C, 2k]
        rows = torch.arange(bsz, device=h.device)[:, None, None]
        sel = h[rows, idx]                                      # [B, C, 2k, L]
        w = torch.stack([ic.weight for ic in self.instance_classifiers])
        b = torch.stack([ic.bias for ic in self.instance_classifiers])
        logits_in = torch.einsum("bckl,cjl->bckj", sel, w) + b[:, None, :]
        top_logits = logits_in[:, :, :k]
        targets_in = torch.cat([torch.ones(k, dtype=torch.long),
                                torch.zeros(k, dtype=torch.long)]
                               ).to(h.device)
        valid_in = torch.cat([top_valid, bot_valid], -1)
        ce_in = _masked_ce(logits_in, targets_in, valid_in.to(h.dtype))
        ce_out = _masked_ce(top_logits, torch.zeros_like(targets_in[:k]),
                            top_valid.to(h.dtype))
        # one-hot by comparison: F.one_hot reads its input's max on the
        # host, which torch.func.vmap (stacked folds and trials) refuses
        classes = torch.arange(c, device=h.device)
        in_w = (torch.as_tensor(label, device=h.device).long()[..., None]
                == classes).to(h.dtype)                          # [B, C]
        out_w = (1.0 - in_w) if self.subtyping else torch.zeros_like(in_w)
        total = (in_w * ce_in).sum(-1) + (out_w * ce_out).sum(-1)
        if self.subtyping:
            total = total / c  # reference: models/model_clam.py:177-178
        # per-instance predictions and targets for the clustering-accuracy
        # logger; validity folds in which class branches count
        sel_in = (in_w > 0)[..., None] & valid_in
        sel_out = (out_w > 0)[..., None] & top_valid
        preds = torch.cat([logits_in.argmax(-1).reshape(bsz, -1),
                           top_logits.argmax(-1).reshape(bsz, -1)], 1)
        targets = torch.cat([targets_in.repeat(bsz, c),
                             torch.zeros(bsz, c * k, dtype=torch.long,
                                         device=h.device)], 1)
        valid = torch.cat([sel_in.reshape(bsz, -1),
                           sel_out.reshape(bsz, -1)], 1)
        return dict(instance_loss=total, inst_preds=preds,
                    inst_labels=targets, inst_valid=valid)


class CLAM_SB(_CLAMBase):
    """Single-branch CLAM: gated-attention ABMIL plus the optional
    instance clustering (reference: models/model_clam.py:77-191). ABMIL is
    CLAM_SB trained with the instance loss off."""

    multi_branch = False


class CLAM_MB(_CLAMBase):
    """Multi-branch CLAM: one attention branch and one 1-d bag classifier
    per class (reference: models/model_clam.py:193-264)."""

    multi_branch = True


class MIL_fc(nn.Module):
    """Non-attention MIL baseline, binary: a per-instance classifier whose
    top class-1 instance is the slide prediction (reference:
    models/model_mil.py:7-43)."""

    def __init__(self, size_arg: str = "small", dropout: float = 0.0,
                 n_classes: int = 2, top_k: int = 1):
        super().__init__()
        if n_classes != 2:
            raise ValueError("MIL_fc is binary; use MIL_fc_mc")
        self.size = MIL_FC_SIZE
        self.n_classes = n_classes
        self.top_k = top_k
        layers = [nn.Linear(self.size[0], self.size[1]), nn.ReLU()]
        if dropout > 0:
            layers.append(Dropout(dropout))
        layers.append(nn.Linear(self.size[1], n_classes))
        self.classifier = nn.Sequential(*layers)

    def forward(self, bag, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, **_):
        single, bag, mask, _ = _batched(bag, mask, None)
        h = torch.relu(self.classifier[0](bag))
        if len(self.classifier) == 4:
            h = self.classifier[2](h, not deterministic, generator)
        inst_logits = self.classifier[-1](h)                    # [B, N, 2]
        y_probs = torch.softmax(inst_logits, dim=-1)
        _, top_idx, _ = masked_top_k(y_probs[..., 1], mask, self.top_k)
        rows = torch.arange(bag.shape[0], device=bag.device)
        top = inst_logits[rows, top_idx[:, 0]]                  # [B, 2]
        out = MILOutput(top, torch.softmax(top, dim=-1),
                        torch.argmax(top, dim=-1), y_probs.transpose(1, 2),
                        {})
        return _squeeze(out) if single else out


class MIL_fc_mc(nn.Module):
    """Multi-class MIL baseline: the prediction is the (instance, class)
    cell with the largest probability (reference: models/model_mil.py:
    46-93)."""

    def __init__(self, size_arg: str = "small", dropout: float = 0.0,
                 n_classes: int = 3, top_k: int = 1):
        super().__init__()
        if n_classes <= 2:
            raise ValueError("MIL_fc_mc needs more than two classes")
        self.size = MIL_FC_SIZE
        self.n_classes = n_classes
        self.top_k = top_k
        layers = [nn.Linear(self.size[0], self.size[1]), nn.ReLU()]
        if dropout > 0:
            layers.append(Dropout(dropout))
        self.fc = nn.Sequential(*layers)
        self.classifiers = nn.ModuleList(
            [nn.Linear(self.size[1], 1) for _ in range(n_classes)])

    def forward(self, bag, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, **_):
        single, bag, mask, _ = _batched(bag, mask, None)
        h = torch.relu(self.fc[0](bag))
        if len(self.fc) == 3:
            h = self.fc[2](h, not deterministic, generator)
        inst_logits = torch.cat([c(h) for c in self.classifiers], -1)
        y_probs = torch.softmax(inst_logits, dim=-1)            # [B, N, C]
        masked = torch.where(mask[..., None], y_probs,
                             torch.zeros_like(y_probs))
        flat = torch.argmax(masked.reshape(bag.shape[0], -1), dim=-1)
        top, y_hat = flat // self.n_classes, flat % self.n_classes
        rows = torch.arange(bag.shape[0], device=bag.device)
        out = MILOutput(inst_logits[rows, top], y_probs[rows, top], y_hat,
                        y_probs.transpose(1, 2), {})
        return _squeeze(out) if single else out


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


MIL_MODEL_TYPES = ("clam_sb", "clam_mb", "mil")


def check_model_type(model_type: str) -> None:
    """Raise the ValueError ``build_mil_model`` raises for a type it does
    not know."""
    if model_type not in MIL_MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")


def build_mil_model(model_type: str, *, size_arg: str = "small",
                    dropout: float = 0.0, n_classes: int = 2,
                    k_sample: int = 8, gate: bool = True,
                    subtyping: bool = False) -> nn.Module:
    """Model-type dispatch (reference: main.py:329, utils/core_utils.py:
    156-189). ``mil`` ignores ``size_arg``: the reference's MIL heads have
    the one size [1024, 512]."""
    if model_type in ("clam_sb", "clam_mb"):
        cls = CLAM_SB if model_type == "clam_sb" else CLAM_MB
        return cls(gate=gate, size_arg=size_arg, dropout=dropout,
                   k_sample=k_sample, n_classes=n_classes,
                   subtyping=subtyping)
    if model_type == "mil":
        if n_classes > 2:
            return MIL_fc_mc(dropout=dropout, n_classes=n_classes)
        return MIL_fc(dropout=dropout, n_classes=n_classes)
    check_model_type(model_type)
