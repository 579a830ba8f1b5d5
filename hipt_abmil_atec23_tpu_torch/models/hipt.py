"""HIPT_4K: hierarchical ViT-256 -> ViT-4K region encoder.

Counterpart of hipt_abmil_atec23_tpu/models/hipt.py (``__call__``, the
cls4k features, ``asset_dict``, ``region_attention`` and
``center_crop_multiple``): every 256 x 256 tile of a region is
one image of a ViT-256 batch, the CLS grid reshapes to [R, gh, gw, 384] on
the device, and ViT-4K turns it into one 192-d feature per region
(reference: HIPT_4K/hipt_4k.py:48-76, without its two-GPU host bounce).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu_torch.models.vit import (
    VIT_CONFIGS, ViT4KConfig, ViTConfig, VisionTransformer,
    VisionTransformer4K, init_dino_)


def hipt_eval_normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """HIPT eval transform: ToTensor + Normalize(0.5, 0.5)
    (reference: HIPT_4K/hipt_model_utils.py:113-118) => x/127.5 - 1."""
    return x_uint8.float() / 127.5 - 1.0


def center_crop_multiple(x: np.ndarray, multiple: int = 256) -> np.ndarray:
    """Host-side: center-crop H and W ([..., H, W, C]) down to multiples of
    ``multiple`` (reference: prepare_img_tensor, hipt_4k.py:308-330)."""
    h, w = x.shape[-3], x.shape[-2]
    nh, nw = (h // multiple) * multiple, (w // multiple) * multiple
    top, left = (h - nh) // 2, (w - nw) // 2
    return x[..., top:top + nh, left:left + nw, :]


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

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype ``forward`` computes in; regions given in it are
        not cast again."""
        return self.vit256.cfg.dtype

    def _tiles(self, regions: torch.Tensor) -> torch.Tensor:
        """Every 256 x 256 tile of the regions, row-major per region, in
        the compute dtype: [R * gh * gw, 256, 256, 3]."""
        r, h, w, c = regions.shape
        gh, gw = h // 256, w // 256
        # cast first: the tile gather below then moves compute-dtype bytes
        x = regions.to(self.vit256.cfg.dtype)
        tiles = x.reshape(r, gh, 256, gw, 256, c).permute(0, 1, 3, 2, 4, 5)
        return tiles.reshape(r * gh * gw, 256, 256, c)

    def _tile_cls(self, regions: torch.Tensor) -> torch.Tensor:
        """ViT-256 CLS of every 256 x 256 tile: [R, gh, gw, 384] f32."""
        r, h, w, _ = regions.shape
        cls256 = self.vit256(self._tiles(regions))
        return cls256.reshape(r, h // 256, w // 256, -1)

    def forward(self, regions: torch.Tensor) -> torch.Tensor:
        return self.vit4k(self._tile_cls(regions))

    def asset_dict(self, regions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's forward_asset_dict (hipt_4k.py:79-118), f32:
        ``features_cls256`` [R, gh*gw, 384], ``features_mean256`` [R, 384]
        (the mean over a region's tiles), ``features_cls4k`` [R, 192] and
        ``features_mean256_cls4k`` [R, 576]. The CLS grid stays on the
        device."""
        grid = self._tile_cls(regions)
        cls256 = grid.reshape(grid.shape[0], -1, grid.shape[-1])
        mean256 = cls256.float().mean(1)
        cls4k = self.vit4k(grid)
        return {"features_cls256": cls256,
                "features_mean256": mean256,
                "features_cls4k": cls4k,
                "features_mean256_cls4k": torch.cat([mean256, cls4k], -1)}

    def region_attention(self, regions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both levels' last-block attention probabilities for hierarchical
        heatmaps (reference: _get_region_attention_scores, hipt_4k.py:
        121-164): (attn256 [R*gh*gw, heads, 257, 257], attn4k [R, heads,
        1 + gh*gw, 1 + gh*gw]), in the compute dtype.

        The JAX package walks ViT-256 twice over the tiles, once for the
        probabilities and once for the CLS grid. Their prefix before the
        last block is one computation, so it runs once here; the last
        block then runs twice: its exact attention for the probabilities,
        and as configured (the fused block kernel under use_fused_block)
        for the CLS that ViT-4K reads."""
        r, h, w, _ = regions.shape
        v256 = self.vit256
        tok, n = v256.prefix(v256.prepare_tokens(self._tiles(regions)), -1)
        last = v256.blocks[-1]
        attn256 = last.attention_probs(tok[:, :n])
        grid = v256.cls(last(tok, n)).reshape(r, h // 256, w // 256, -1)
        return attn256, self.vit4k.get_last_selfattention(grid)


def make_hipt_encoder(dtype: torch.dtype = torch.bfloat16,
                      use_flash: bool = False, use_fused_mlp: bool = False,
                      use_fused_block: bool = False, *,
                      vit256_cfg: ViTConfig = VIT_CONFIGS["vit_small"],
                      vit4k_cfg: ViT4KConfig = ViT4KConfig(),
                      generator: Optional[torch.Generator] = None
                      ) -> HIPT4K:
    """HIPT4K at the given compute dtype, block configuration and widths
    (defaults: vit_small and vit4k_xs, the reference's HIPT_4K), as the JAX
    package's make_hipt_encoder: ``use_fused_block`` runs each block as the
    fused block kernel; ``use_flash`` / ``use_fused_mlp`` select the per-op
    attention and LN + MLP kernels. With a generator the weights are seeded
    random draws in DINO's init scheme; otherwise they are zeros until a
    state dict is loaded. Every configuration has the same parameters."""
    flags = dict(dtype=dtype, use_flash=use_flash,
                 use_fused_mlp=use_fused_mlp, use_fused_block=use_fused_block)
    model = HIPT4K(dataclasses.replace(vit256_cfg, **flags),
                   dataclasses.replace(vit4k_cfg, **flags))
    if generator is not None:
        init_dino_(model, generator)
    return model
