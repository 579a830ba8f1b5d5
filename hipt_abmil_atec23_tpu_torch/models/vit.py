"""DINO Vision Transformers: ViT-256 (patch encoder) and ViT-4K (region
encoder), forward only.

Counterpart of hipt_abmil_atec23_tpu/models/vit.py, on the path it takes
with ``use_fused_block``: tokens pad once per network (257 -> 264) and
``n_valid`` threads into every block, so each block is one call of
ops/fused_block.py (CUDA kernels on a CUDA tensor, the plain version on a
CPU tensor); the residual stream stays in the compute dtype between blocks;
the final LayerNorm reads the unpadded CLS token in f32.

Parameters keep the DINO checkpoint layout (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.norm1`` / ``.attn.qkv`` /
``.attn.proj`` / ``.norm2`` / ``.mlp.fc1`` / ``.mlp.fc2``, ``norm``, and
``phi.0`` for ViT-4K), so the reference's ``.pth`` files load as they are.
Parameters are f32; ``dtype`` is the compute dtype, with the JAX package's
casts: inputs and the patch-embedding product in ``dtype`` with an f32
bias, the pos-embed rounded to ``dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)
from hipt_abmil_atec23_tpu_torch.ops.interpolate import interpolate_pos_embed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    patch_size: int = 16
    pretrain_img_size: int = 224   # pos_embed native grid = 14x14
    in_chans: int = 3
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32   # compute dtype


VIT_CONFIGS = {
    "vit_small": ViTConfig(embed_dim=384, depth=12, num_heads=6),
}


@dataclasses.dataclass(frozen=True)
class ViT4KConfig:
    input_embed_dim: int = 384
    output_embed_dim: int = 192
    depth: int = 6
    num_heads: int = 6
    mlp_ratio: float = 4.0
    pretrain_grid: int = 14     # 196 native pos-embed slots
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32


class Attention(nn.Module):
    """DINO attention parameters (qkv, proj); the block kernel reads them."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    """DINO MLP parameters (fc1, fc2); the block kernel reads them."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-norm transformer block; its forward is one fused_vit_block call
    (with ``plain`` set: the plain PyTorch version on any device, for
    holding the kernels against it on the card)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 eps: float):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.plain = False
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, n_valid: Optional[int] = None
                ) -> torch.Tensor:
        fn = fused_vit_block_reference if self.plain else fused_vit_block
        return fn(x, self, num_heads=self.num_heads, n_valid=n_valid,
                  eps=self.eps)


def _pad_tokens(tok: torch.Tensor) -> torch.Tensor:
    """Zero-pad the token axis to a multiple of 8, once per network."""
    n = tok.shape[1]
    return F.pad(tok, (0, 0, 0, (n + 7) // 8 * 8 - n))


class _PosEmbedCache:
    """Interpolated pos-embed per grid shape, recomputed only when the
    parameter changes (a load_state_dict bumps its version) or moves."""

    def __init__(self):
        self._entries: Dict[Tuple[int, int], tuple] = {}

    def get(self, pos_embed: nn.Parameter, gh: int, gw: int) -> torch.Tensor:
        key = (gh, gw)
        stamp = (pos_embed._version, pos_embed.device)
        hit = self._entries.get(key)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                pe = interpolate_pos_embed(pos_embed.detach(), gh, gw)
            hit = self._entries[key] = (stamp, pe)
        return hit[1]


class _Encoder(nn.Module):
    """Shared walk of both ViTs: pad once, run the blocks, LN the CLS."""

    def _init_blocks(self, dim, depth, heads, mlp_ratio, eps):
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, eps) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=eps)
        self._pe = _PosEmbedCache()

    def _run(self, tok: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n = tok.shape[1]
        tok = _pad_tokens(tok).to(dtype)
        for blk in self.blocks:
            tok = blk(tok, n)
        # LN is per token, so normalising the CLS alone equals LN-then-slice
        return F.layer_norm(tok[:, 0].float(), self.norm.normalized_shape,
                            self.norm.weight, self.norm.bias, self.norm.eps)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)


class VisionTransformer(_Encoder):
    """ViT over pixels: NHWC [B, H, W, 3] (normalised) -> CLS [B, D] f32."""

    def __init__(self, cfg: ViTConfig = VIT_CONFIGS["vit_small"]):
        super().__init__()
        self.cfg = cfg
        s = cfg.pretrain_img_size // cfg.patch_size
        self.patch_embed = _PatchEmbed(cfg.patch_size, cfg.in_chans,
                                       cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, s * s + 1, cfg.embed_dim))
        self._init_blocks(cfg.embed_dim, cfg.depth, cfg.num_heads,
                          cfg.mlp_ratio, cfg.ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, h, w, c = x.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        # patch embedding as one GEMM over (kh, kw, c)-ordered taps: the
        # stride-16 conv of the reference, in the JAX package's layout
        tok = x.to(dt).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        tok = tok.reshape(b, gh * gw, p * p * c)
        wk = self.patch_embed.proj.weight.permute(0, 2, 3, 1).reshape(
            cfg.embed_dim, p * p * c)
        tok = (tok @ wk.to(dt).t()).float() + self.patch_embed.proj.bias
        cls = self.cls_token.to(dt).float().expand(b, -1, -1)
        tok = torch.cat([cls, tok], dim=1)
        tok = tok + self._pe.get(self.pos_embed, gh, gw).to(dt).float()
        return self._run(tok, dt)


class VisionTransformer4K(_Encoder):
    """ViT over a [B, gh, gw, 384] grid of ViT-256 CLS features -> [B, 192]
    f32 CLS (reference: vision_transformer4k.py:161-246)."""

    def __init__(self, cfg: ViT4KConfig = ViT4KConfig()):
        super().__init__()
        self.cfg = cfg
        s = cfg.pretrain_grid
        self.phi = nn.Sequential(
            nn.Linear(cfg.input_embed_dim, cfg.output_embed_dim), nn.GELU())
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.output_embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, s * s + 1, cfg.output_embed_dim))
        self._init_blocks(cfg.output_embed_dim, cfg.depth, cfg.num_heads,
                          cfg.mlp_ratio, cfg.ln_eps)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, gh, gw, d = grid.shape
        # phi runs in f32 on dtype-rounded inputs, as the JAX package's
        # f32-param Dense promotes its bf16 input
        x = grid.reshape(b, gh * gw, d).to(dt).float()
        x = F.gelu(F.linear(x, self.phi[0].weight, self.phi[0].bias))
        cls = self.cls_token.to(dt).float().expand(b, -1, -1)
        tok = torch.cat([cls, x], dim=1)
        tok = tok + self._pe.get(self.pos_embed, gh, gw).to(dt).float()
        return self._run(tok, dt)


def init_dino_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in DINO's scheme: truncated-normal(0.02) Linear
    weights, cls_token and pos_embed; zero biases; unit LayerNorms; the
    patch conv like a Linear over its fan-in. Draws on the CPU from
    ``generator`` so a seed gives the same weights on every device."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else model
            if isinstance(owner, nn.LayerNorm):
                prm.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                prm.zero_()
            else:
                std = 0.02
                if isinstance(owner, nn.Conv2d):
                    std = prm[0].numel() ** -0.5
                draw = torch.randn(prm.shape, generator=generator) * std
                prm.copy_(draw.clamp_(-2 * std, 2 * std))
    return model
