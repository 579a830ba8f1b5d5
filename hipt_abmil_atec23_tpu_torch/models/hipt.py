"""HIPT_4K: hierarchical ViT-256 -> ViT-4K region encoder.

Counterpart of hipt_abmil_atec23_tpu/models/hipt.py (``__call__``, the
cls4k features): every 256 x 256 tile of a region is one image of a
ViT-256 batch, the CLS grid reshapes to [R, gh, gw, 384] on the device, and
ViT-4K turns it into one 192-d feature per region (reference:
HIPT_4K/hipt_4k.py:48-76, without its two-GPU host bounce).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu_torch.models.vit import (
    VIT_CONFIGS, ViT4KConfig, ViTConfig, VisionTransformer,
    VisionTransformer4K, init_dino_)


def hipt_eval_normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """HIPT eval transform: ToTensor + Normalize(0.5, 0.5)
    (reference: HIPT_4K/hipt_model_utils.py:113-118) => x/127.5 - 1."""
    return x_uint8.float() / 127.5 - 1.0


class HIPT4K(nn.Module):
    """[R, H, W, 3] normalised regions (H, W multiples of 256) -> [R, D4k]
    f32 ViT-4K CLS features."""

    def __init__(self, vit256_cfg: ViTConfig, vit4k_cfg: ViT4KConfig):
        super().__init__()
        self.vit256 = VisionTransformer(vit256_cfg)
        self.vit4k = VisionTransformer4K(vit4k_cfg)

    @property
    def feat_dim(self) -> int:
        return self.vit4k.cfg.output_embed_dim

    def forward(self, regions: torch.Tensor) -> torch.Tensor:
        r, h, w, c = regions.shape
        gh, gw = h // 256, w // 256
        # cast first: the tile gather below then moves compute-dtype bytes
        x = regions.to(self.vit256.cfg.dtype)
        tiles = x.reshape(r, gh, 256, gw, 256, c).permute(0, 1, 3, 2, 4, 5)
        cls256 = self.vit256(tiles.reshape(r * gh * gw, 256, 256, c))
        return self.vit4k(cls256.reshape(r, gh, gw, -1))


def make_hipt_encoder(dtype: torch.dtype = torch.bfloat16,
                      vit256_cfg: ViTConfig = VIT_CONFIGS["vit_small"],
                      vit4k_cfg: ViT4KConfig = ViT4KConfig(), *,
                      generator: Optional[torch.Generator] = None
                      ) -> HIPT4K:
    """HIPT4K at the given compute dtype and widths (defaults: vit_small
    and vit4k_xs, the reference's HIPT_4K). With a generator the weights
    are seeded random draws in DINO's init scheme; otherwise they are
    zeros until a state dict is loaded."""
    model = HIPT4K(dataclasses.replace(vit256_cfg, dtype=dtype),
                   dataclasses.replace(vit4k_cfg, dtype=dtype))
    if generator is not None:
        init_dino_(model, generator)
    return model
