"""Optimizers for the port's MIL training.

Counterpart of ``make_optimizer`` in hipt_abmil_atec23_tpu/engine/train.py,
whose optax chains copy the reference's torch optimizers (reference:
utils/core_utils.py get_optim): Adam with L2 weight decay added to the
gradient, and SGD with momentum 0.9. The rest of that module (the stacked
per-fold step functions, early stopping) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_optimizer(opt: str, lr: float, reg: float
                   ) -> Callable[[Iterable[torch.nn.Parameter]],
                                 torch.optim.Optimizer]:
    """The optimizer for ``opt`` ("adam" or "sgd") as a function of the
    parameters, as optax's transformation is initialised on them.
    ``torch.optim.Adam(weight_decay=reg)`` adds ``reg * p`` to the gradient
    before the moments, as ``optax.add_decayed_weights(reg)`` chained
    before ``optax.adam`` does; SGD likewise with momentum 0.9."""
    if opt == "adam":
        return lambda params: torch.optim.Adam(params, lr=lr,
                                               weight_decay=reg)
    if opt == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9,
                                              weight_decay=reg)
    raise ValueError(f"unknown optimizer {opt!r}")
