"""Operand rounding for the plain reference.

``f32`` is the reference itself: every matrix product and convolution in
f32 with TF32 off. The lower precisions serve the controls that prove the
comparison can fail: ``tf32`` rounds both operands of each product to TF32
(10 mantissa bits, nearest), ``fp8`` scales each operand tensor to its
absolute maximum and rounds it to float8 e4m3, as fp8 inference does. The
products still accumulate in f32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")


def linear(x, w, b, precision: str):
    r = round_operand
    return F.linear(r(x, precision), r(w, precision), b)


def matmul(a, b, precision: str):
    return round_operand(a, precision) @ round_operand(b, precision)


def conv2d(x, w, b, stride: int, padding: int, precision: str):
    r = round_operand
    return F.conv2d(r(x, precision), r(w, precision), b, stride, padding)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matrix products and cuDNN while the reference runs."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
