"""Explicit device resolution. Nothing in the port picks a device on its
own: callers pass one, and the CUDA entry points ask for it here."""
from __future__ import annotations

import contextlib
import os

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
    """torch.device from a device or its name; a CUDA device must exist.

    An index-less ``"cuda"`` is the launcher's card where one set
    ``LOCAL_RANK`` (``torchrun``, ``dryrun_multichip``: one process per
    card), else the current device. A ``LOCAL_RANK`` at or past the card
    count raises; an explicit index is kept."""
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            if local is None:
                return torch.device("cuda", torch.cuda.current_device())
            k, n = int(local), torch.cuda.device_count()
            if not 0 <= k < n:
                raise RuntimeError(f"LOCAL_RANK={k} names no card: "
                                   f"{n} CUDA device(s) visible")
            device = torch.device("cuda", k)
    return device


@contextlib.contextmanager
def true_f32():
    """CUDA f32 matrix products without TF32 for the block's duration
    (``torch.backends.cuda.matmul.allow_tf32`` restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
