"""The epilogue of a ResNet convolution: folded bias, residual and ReLU in
one pass.

``conv_epilogue(a, bias, r, bias_r)`` computes
relu(a + bias [+ (r [+ bias_r])]) per channel of NHWC (channels_last)
activations, the sum in f32 and rounded once to ``a``'s dtype. ``a`` is a
convolution's bias-free output; ``r`` a block's residual (its input, or
its downsample convolution's bias-free output with that convolution's
folded bias as ``bias_r``). On a CUDA tensor it is one launch of
kernels/csrc/conv_epilogue.cu, which writes the result into ``a`` and
returns it; on a CPU tensor it is ``conv_epilogue_reference``. The JAX
package leaves the same steps to XLA, which fuses them into its
convolutions; eager PyTorch ran them as up to four passes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build

MAX_CHANNELS = 4096      # the kernel's two f32 bias rows in shared memory
DTYPES = (torch.bfloat16, torch.float32)


def conv_epilogue_reference(a: torch.Tensor, bias: torch.Tensor,
                            r: Optional[torch.Tensor] = None,
                            bias_r: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the epilogue on any device: a new tensor
    relu((a + bias) + (r + bias_r)) in f32, ``r`` and ``bias_r`` optional,
    rounded once to ``a.dtype``. ``a`` and ``r`` are [N, C, H, W], the
    biases [C]."""
    if bias_r is not None and r is None:
        raise ValueError("conv_epilogue: bias_r without r")
    s = a.float() + bias.float()[:, None, None]
    if r is not None:
        s = s + (r.float() if bias_r is None
                 else r.float() + bias_r.float()[:, None, None])
    return torch.relu(s).to(a.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_epilogue")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_epilogue_launch.argtypes = [vp] * 4 + [
            i, ctypes.c_int64, i, i, vp]
        lib.conv_epilogue_launch.restype = i
        lib.conv_epilogue_error_string.argtypes = [i]
        lib.conv_epilogue_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_epilogue(a: torch.Tensor, bias: torch.Tensor,
                  r: Optional[torch.Tensor] = None,
                  bias_r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(a + bias [+ (r [+ bias_r])]) for [N, C, H, W] activations and
    [C] biases. CUDA tensors (bf16 or f32, ``a`` and
    ``r`` channels_last and 16-byte aligned, C % 8 == 0, C <= 4096) launch
    kernels/csrc/conv_epilogue.cu once, which overwrites ``a`` with the
    result and returns it; anything else on CUDA raises. CPU tensors run
    ``conv_epilogue_reference``."""
    if a.device.type == "cpu":
        return conv_epilogue_reference(a, bias, r, bias_r)
    if a.dim() != 4 or a.dtype not in DTYPES or a.device.type != "cuda":
        raise ValueError(f"conv_epilogue: a must be a bf16 or f32 [N, C, H, "
                         f"W] CUDA tensor, got {a.dtype} {tuple(a.shape)} "
                         f"on {a.device}")
    c = a.shape[1]
    if bias_r is not None and r is None:
        raise ValueError("conv_epilogue: bias_r without r")
    for name, t, shape in (("bias", bias, (c,)), ("r", r, a.shape),
                           ("bias_r", bias_r, (c,))):
        if t is not None and (t.device != a.device or t.dtype != a.dtype
                              or t.shape != shape):
            raise ValueError(
                f"conv_epilogue: {name} must be {a.dtype} {tuple(shape)} on "
                f"{a.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if any(t is not None and t.requires_grad for t in (a, bias, r, bias_r)):
        raise ValueError("conv_epilogue: an input requires grad; the kernel "
                         "writes in place where autograd cannot see")
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"conv_epilogue: C = {c}; the kernel takes "
                         f"multiples of 8 up to {MAX_CHANNELS}")
    for name, t in (("a", a), ("r", r)):
        if t is not None and not (
                t.is_contiguous(memory_format=torch.channels_last)
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"conv_epilogue: {name} must be channels_last "
                             "contiguous and 16-byte aligned")
    for name, t in (("bias", bias), ("bias_r", bias_r)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"conv_epilogue: {name} must be contiguous")
    if a.numel() == 0:
        return a
    lib = _lib()
    err = lib.conv_epilogue_launch(
        a.data_ptr(), bias.data_ptr(),
        None if r is None else r.data_ptr(),
        None if bias_r is None else bias_r.data_ptr(),
        int(a.dtype == torch.bfloat16), a.numel(), c,
        _sm_count(a.device.index),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, "conv_epilogue_error_string", err, "conv_epilogue")
    conv_epilogue.launches += 1
    return a


conv_epilogue.launches = 0  # kernel launches on CUDA
