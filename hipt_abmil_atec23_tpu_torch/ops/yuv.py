"""On-device JPEG YCbCr -> RGB reconstruction, and the encoder's input.

Counterpart of hipt_abmil_atec23_tpu/ops/yuv.py: the raw-plane read path
ships the codec's planes (1.5 bytes/px for 4:2:0) and the device rebuilds
RGB the way libjpeg's default decode does — the triangular "fancy" chroma
upsample (jdsample.c h2v2/h2v1_fancy_upsample) and JFIF/BT.601 colour
(jdcolor.c) in f32, clamped to 0..255.

``ycc_to_input`` goes one step further, to what the encoder reads: the
encoder's normalize in its dtype, HIPT's x / 127.5 - 1 (``"hipt"``) or
torchvision's ImageNet one, (x / 255 - mean) / std per channel
(``"imagenet"``, the ResNet and LeViT encoders'). On a CUDA tensor it is
one launch of kernels/csrc/ycc_input.cu (the JAX package leaves the same
steps to XLA, which fuses them); on a CPU tensor, or with ``plain=True``,
it is ``ycc_to_input_reference``.
"""
from __future__ import annotations

import ctypes

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build
from hipt_abmil_atec23_tpu_torch.models.resnet import (
    IMAGENET_MEAN, IMAGENET_STD, imagenet_normalize)

NORMALIZES = ("hipt", "imagenet")


def _fancy_upsample_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """2x triangular upsample along ``axis``: sample 2i = (3 c[i] +
    c[i-1]) / 4, 2i+1 = (3 c[i] + c[i+1]) / 4, edges clamped."""
    n = c.shape[axis]
    cm1 = torch.cat([c.narrow(axis, 0, 1), c.narrow(axis, 0, n - 1)], axis)
    cp1 = torch.cat([c.narrow(axis, 1, n - 1), c.narrow(axis, n - 1, 1)],
                    axis)
    even = (3.0 * c + cm1) * 0.25
    odd = (3.0 * c + cp1) * 0.25
    shape = list(c.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _color(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
           ) -> torch.Tensor:
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def yuv420_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
    """uint8 Y [..., H, W], Cb/Cr [..., H/2, W/2] -> f32 RGB [..., H, W, 3]
    in 0..255."""
    h_axis = y.dim() - 2
    cbf = cb.float() - 128.0
    crf = cr.float() - 128.0
    cbu = _fancy_upsample_axis(_fancy_upsample_axis(cbf, h_axis), h_axis + 1)
    cru = _fancy_upsample_axis(_fancy_upsample_axis(crf, h_axis), h_axis + 1)
    return _color(y.float(), cbu, cru)


def yuv422_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
    """uint8 Y [..., H, W], Cb/Cr [..., H, W/2] -> f32 RGB [..., H, W, 3]
    (horizontal-only subsampling, libjpeg h2v1_fancy_upsample)."""
    w_axis = y.dim() - 1
    cbu = _fancy_upsample_axis(cb.float() - 128.0, w_axis)
    cru = _fancy_upsample_axis(cr.float() - 128.0, w_axis)
    return _color(y.float(), cbu, cru)


def yuv_planes_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                      cr: torch.Tensor) -> torch.Tensor:
    """Dispatch on plane geometry: 4:2:0 when both chroma dimensions are
    half of Y's, 4:2:2 when the rows match and the columns are half. Both
    dimensions are checked (the JAX version checks only the rows in its
    4:2:0 branch)."""
    yh, yw = y.shape[-2:]
    ch, cw = cb.shape[-2:]
    if cr.shape != cb.shape:
        raise ValueError(f"Cb {tuple(cb.shape)} and Cr {tuple(cr.shape)} "
                         "differ")
    if ch * 2 == yh and cw * 2 == yw:
        return yuv420_to_rgb(y, cb, cr)
    if ch == yh and cw * 2 == yw:
        return yuv422_to_rgb(y, cb, cr)
    raise ValueError(
        f"unsupported plane geometry: Y {tuple(y.shape)}, chroma "
        f"{tuple(cb.shape)} (expected 4:2:0 [H/2, W/2] or 4:2:2 [H, W/2])")


def ycc_to_input_reference(y: torch.Tensor, cb: torch.Tensor,
                           cr: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16,
                           normalize: str = "hipt") -> torch.Tensor:
    """Plain PyTorch version of the colour kernel: uint8 planes (4:2:0 or
    4:2:2) -> the encoder's normalized input [..., H, W, 3] in ``dtype``.
    ``normalize``: "hipt" (x / 127.5 - 1) or "imagenet"
    (models/resnet.imagenet_normalize)."""
    rgb = yuv_planes_to_rgb(y, cb, cr)
    if normalize == "imagenet":
        return imagenet_normalize(rgb).to(dtype)
    return (rgb / 127.5 - 1.0).to(dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("ycc_input")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ycc_input_launch.argtypes = ([vp] * 4 + [i] * 7
                                         + [ctypes.c_float] * 6 + [vp])
        lib.ycc_input_launch.restype = i
        lib.ycc_input_error_string.argtypes = [i]
        lib.ycc_input_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def ycc_to_input(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16, *,
                 normalize: str = "hipt", plain: bool = False
                 ) -> torch.Tensor:
    """uint8 Y [n, H, W] and Cb/Cr [n, H/2, W/2] (4:2:0) or [n, H, W/2]
    (4:2:2) -> the encoder's input [n, H, W, 3] in ``dtype`` (bf16 or
    f32), normalized as ``normalize`` says ("hipt": RGB / 127.5 - 1;
    "imagenet": (RGB / 255 - mean) / std). CUDA planes launch
    kernels/csrc/ycc_input.cu once and raise on anything it does not take;
    CPU planes, or ``plain``, run ``ycc_to_input_reference``."""
    if normalize not in NORMALIZES:
        raise ValueError(f"ycc_to_input: normalize {normalize!r}, expected "
                         f"one of {NORMALIZES}")
    if plain or y.device.type == "cpu":
        return ycc_to_input_reference(y, cb, cr, dtype, normalize)
    dev = y.device
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if (t.device != dev or t.dtype != torch.uint8
                or not t.is_contiguous() or t.dim() != 3):
            raise ValueError(f"ycc_to_input: {name} must be a contiguous "
                             f"uint8 [n, H, W] tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n, h, w = y.shape
    if (cr.shape != cb.shape or cb.shape[0] != n or cb.shape[2] * 2 != w
            or (cb.shape[1] * 2 != h and cb.shape[1] != h)):
        raise ValueError(
            f"ycc_to_input: unsupported plane geometry: Y {tuple(y.shape)}, "
            f"Cb {tuple(cb.shape)}, Cr {tuple(cr.shape)} (expected 4:2:0 "
            "[H/2, W/2] or 4:2:2 [H, W/2])")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ycc_to_input: dtype {dtype}, expected bf16 or f32")
    out = torch.empty((n, h, w, 3), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.ycc_input_launch(
        y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), n, h, w, cb.shape[1], cb.shape[2],
        int(normalize == "imagenet"), *IMAGENET_MEAN, *IMAGENET_STD,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "ycc_input_error_string", err, "ycc_to_input")
    ycc_to_input.launches += 1
    return out


ycc_to_input.launches = 0  # kernel launches on CUDA
