"""Checkpointing: the best-validation MIL head per fold.

Counterpart of hipt_abmil_atec23_tpu/engine/checkpoint.py, on the
reference's own contract: one torch state dict per fold at
``results_dir/s_{fold}_checkpoint.pt``, written on every validation-loss
improvement (reference: utils/core_utils.py:92-100). The heads keep the
reference's module layout, so the reference's eval loader and the JAX
package's ``.pt`` fallback (JAX evaluate.py:88-101) read these files. The
JAX package's own ``s_{fold}_checkpoint.msgpack`` (flax) heads load too,
through engine/flax_ckpt.py (``load_mil_state_dict``). Tuning's per-epoch
train states go through ``TrainStateCheckpointer``: ``torch.save`` files
with bounded retention, where the JAX package uses an orbax
``CheckpointManager`` (orbax directories are not read here).
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch


def ckpt_path(results_dir: str, fold: int) -> str:
    return os.path.join(results_dir, f"s_{fold}_checkpoint.pt")


def flax_ckpt_path(results_dir: str, fold: int) -> str:
    """The JAX package's checkpoint of fold ``fold`` (its ckpt_path)."""
    return os.path.join(results_dir, f"s_{fold}_checkpoint.msgpack")


def fold_ckpt(models_dir: str, fold: int) -> str:
    """Fold ``fold``'s head in ``models_dir``: the ``.pt`` when there is
    one, else the JAX package's ``.msgpack`` (each package reads its own
    format first and falls back to the other's)."""
    for path in (ckpt_path(models_dir, fold),
                 flax_ckpt_path(models_dir, fold)):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no checkpoint for fold {fold} in {models_dir}")


def load_mil_state_dict(path: str, model_type: str, n_classes: int, *,
                        with_dropout: bool = False,
                        keep_instance: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """A MIL head's state dict, in the port's layout for a build with or
    without dropout, from a reference-layout torch ``.pt`` or, for any
    other name, a flax ``.msgpack`` the JAX package wrote (its parameter
    tree bridged by models/convert.mil_state_dict_from_jax). Instance
    classifiers stay only with ``keep_instance``."""
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        load_torch_state_dict, mil_state_dict_from_jax,
        mil_state_dict_from_torch)
    if path.endswith(".pt"):
        sd = load_torch_state_dict(path, checkpoint_key=None)
    else:
        from hipt_abmil_atec23_tpu_torch.engine.flax_ckpt import load_params
        sd = mil_state_dict_from_jax(load_params(path), model_type,
                                     n_classes)
    return mil_state_dict_from_torch(sd, with_dropout=with_dropout,
                                     keep_instance=keep_instance)


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


class TrainStateCheckpointer:
    """Per-epoch (head, optimizer, epoch) checkpoints with retention.

    The reference saves (model, optimizer) every epoch while tuning, under
    Ray's ``tune.checkpoint_dir`` (core_utils_tuning.py:235-240); the JAX
    package keeps them with an orbax ``CheckpointManager``
    (JAX checkpoint.py:51-92). Here each step is ``directory/ckpt_{step}.pt``
    (``torch.save``). Only the newest ``max_to_keep`` stay. With
    ``async_save`` the state is copied to the host at ``save`` and written
    by a background thread, so the write overlaps the next epoch; ``close``
    (and the next ``save``) waits for it."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 2,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        try:
            tmp = self._path(step) + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
        except Exception as e:   # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the pending write is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> None:
        self.wait()
        opt = optimizer.state_dict()
        payload = {"params": _cpu_state(model),
                   "opt_state": _to_cpu(opt), "epoch": int(step)}
        if self.async_save:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, payload),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, payload)
            self.wait()

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None):
        """Load step ``step`` (None: the latest) into ``model`` (and
        ``optimizer``), in place. Returns (model, optimizer, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        model.load_state_dict(payload["params"])
        if optimizer is not None:
            optimizer.load_state_dict(payload["opt_state"])
        return model, optimizer, step

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        self.wait()


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x
