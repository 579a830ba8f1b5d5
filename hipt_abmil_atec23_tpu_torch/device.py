"""Explicit device resolution. Nothing in the port picks a device on its
own: callers pass one, and the CUDA entry points ask for it here."""
from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: the CUDA path of "
            "hipt_abmil_atec23_tpu_torch needs an NVIDIA GPU (built for "
            "sm_90a, H100)")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """torch.device from a device or its name; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
