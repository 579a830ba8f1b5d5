"""DINO position-embedding interpolation.

Counterpart of hipt_abmil_atec23_tpu/ops/interpolate.py, which exists there
because jax.image lacks torch's a=-0.75 bicubic kernel. Here torch's own
bicubic does it, called the way the reference's DINO ViTs call it
(HIPT_4K/vision_transformer.py:213-233): align_corners=False and
scale_factor=((gh + 0.1)/s, (gw + 0.1)/s) with recompute_scale_factor=False,
so source coordinates map with the fudged scale.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def interpolate_pos_embed(pos_embed: torch.Tensor, gh: int,
                          gw: int) -> torch.Tensor:
    """[1, 1 + s*s, D] -> [1, 1 + gh*gw, D]: the CLS slot is kept and the
    s x s patch grid is resized bicubically to gh x gw (f32)."""
    n = pos_embed.shape[1] - 1
    dim = pos_embed.shape[2]
    s = int(round(math.sqrt(n)))
    pe = pos_embed.float()
    if (gh, gw) == (s, s):
        return pe
    grid = pe[:, 1:].reshape(1, s, s, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / s, (gw + 0.1) / s),
                         mode="bicubic", align_corners=False,
                         recompute_scale_factor=False)
    if grid.shape[-2:] != (gh, gw):
        raise ValueError(f"pos-embed resize gave {tuple(grid.shape[-2:])}, "
                         f"expected {(gh, gw)}")
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, dim)
    return torch.cat([pe[:, :1], grid], dim=1)
