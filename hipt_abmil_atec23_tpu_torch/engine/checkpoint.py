"""Checkpointing: the best-validation MIL head per fold.

Counterpart of hipt_abmil_atec23_tpu/engine/checkpoint.py, on the
reference's own contract: one torch state dict per fold at
``results_dir/s_{fold}_checkpoint.pt``, written on every validation-loss
improvement (reference: utils/core_utils.py:92-100). The heads keep the
reference's module layout, so the reference's eval loader and the JAX
package's ``.pt`` fallback (JAX evaluate.py:88-101) read these files. The
orbax-managed ``TrainStateCheckpointer`` belongs with tuning (ROADMAP
§A.10).
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def ckpt_path(results_dir: str, fold: int) -> str:
    return os.path.join(results_dir, f"s_{fold}_checkpoint.pt")


def _cpu_state(module: torch.nn.Module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def save_params(path: str, model: torch.nn.Module) -> None:
    """The head's state dict, on the CPU, at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_cpu_state(model), path)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a state dict written by ``save_params`` (or a reference-layout
    one of the same build) into ``model``, in place; returns ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model


def save_train_state(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, epoch: int) -> None:
    """(head, optimizer, epoch) in one file - the reference saves (model,
    optimizer) per epoch during tuning (core_utils_tuning.py:235-237)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"params": _cpu_state(model),
                "opt_state": optimizer.state_dict(), "epoch": int(epoch)},
               path)


def load_train_state(path: str, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> int:
    """Restore what ``save_train_state`` wrote into ``model`` (and
    ``optimizer``); returns the epoch."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["params"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["opt_state"])
    return int(payload["epoch"])
