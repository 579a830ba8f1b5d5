"""JPEG YCbCr 4:2:0 planes to the encoders' normalised RGB, as libjpeg's
default decode rebuilds colour (jdsample.c h2v2_fancy_upsample: a
triangular 3:1 filter along each axis, the edge sample repeated; jdcolor.c:
JFIF / BT.601), in f32 without libjpeg's integer rounding, clamped to
0..255."""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _upsample2(c: torch.Tensor, axis: int) -> torch.Tensor:
    prev = torch.cat([c.narrow(axis, 0, 1), c.narrow(axis, 0,
                                                     c.shape[axis] - 1)], axis)
    nxt = torch.cat([c.narrow(axis, 1, c.shape[axis] - 1),
                     c.narrow(axis, c.shape[axis] - 1, 1)], axis)
    out = torch.stack([0.75 * c + 0.25 * prev, 0.75 * c + 0.25 * nxt],
                      axis + 1)
    shape = list(c.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def planes_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
    """uint8 Y [n, H, W], Cb / Cr [n, H/2, W/2] -> f32 RGB [n, H, W, 3]."""
    chroma = []
    for c in (cb, cr):
        c = c.float() - 128.0
        chroma.append(_upsample2(_upsample2(c, 1), 2))
    yf = y.float()
    r = yf + 1.402 * chroma[1]
    g = yf - 0.344136 * chroma[0] - 0.714136 * chroma[1]
    b = yf + 1.772 * chroma[0]
    return torch.stack([r, g, b], -1).clamp(0.0, 255.0)


def normalised(rgb: torch.Tensor, normalize: str) -> torch.Tensor:
    """HIPT's ToTensor + Normalize(0.5, 0.5) (x / 127.5 - 1), or
    torchvision's ImageNet normalisation."""
    if normalize == "hipt":
        return rgb / 127.5 - 1.0
    if normalize == "imagenet":
        mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
        std = torch.tensor(IMAGENET_STD, device=rgb.device)
        return (rgb / 255.0 - mean) / std
    raise ValueError(f"normalize {normalize!r}")
