"""On-device JPEG YCbCr -> RGB reconstruction (plain PyTorch).

Counterpart of hipt_abmil_atec23_tpu/ops/yuv.py: the raw-plane read path
ships the codec's planes (1.5 bytes/px for 4:2:0) and the device rebuilds
RGB the way libjpeg's default decode does — the triangular "fancy" chroma
upsample (jdsample.c h2v2/h2v1_fancy_upsample) and JFIF/BT.601 colour
(jdcolor.c) in f32, clamped to 0..255.
"""
from __future__ import annotations

import torch


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
