"""HIPT_4K in plain PyTorch (Chen et al., CVPR 2022; mahmoodlab/HIPT
HIPT_4K/hipt_4k.py, vision_transformer.py, vision_transformer4k.py).

A region [H, W, 3] is cut into 256 x 256 tiles; ViT-256 (DINO ViT, patch
16) gives each tile's CLS after the final LayerNorm; the CLS grid goes
through ViT-4K (phi = Linear + GELU, then DINO blocks) and its CLS after
the final LayerNorm is the region's feature. Position embeddings are
resized from their pretraining grid as DINO's interpolate_pos_encoding
does: bicubic, scale factor (g + 0.1) / s, the CLS slot kept. Blocks are
pre-norm: x + Attn(LN(x)), then x + MLP(LN(x)) with exact GELU.

Weights are a state dict in DINO's layout under ``vit256.`` and
``vit4k.``. Everything runs in f32; ``precision`` rounds the operands of
each product for a control (reference/precision.py).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.precision import conv2d, linear, matmul


def resize_pos_embed(pe: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    n = pe.shape[1] - 1
    s = int(round(n ** 0.5))
    if (gh, gw) == (s, s):
        return pe
    grid = pe[:, 1:].reshape(1, s, s, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / s, (gw + 0.1) / s),
                         mode="bicubic", align_corners=False,
                         recompute_scale_factor=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
    return torch.cat([pe[:, :1], grid], 1)


def _block(x, w, p, heads, eps, prec):
    b, n, d = x.shape
    h = F.layer_norm(x, (d,), w[p + "norm1.weight"], w[p + "norm1.bias"], eps)
    qkv = linear(h, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], prec)
    q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    att = torch.softmax(matmul(q, k.transpose(-1, -2), prec)
                        * (d // heads) ** -0.5, -1)
    o = matmul(att, v, prec).permute(0, 2, 1, 3).reshape(b, n, d)
    x = x + linear(o, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"],
                   prec)
    h = F.layer_norm(x, (d,), w[p + "norm2.weight"], w[p + "norm2.bias"], eps)
    h = F.gelu(linear(h, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"],
                      prec))
    return x + linear(h, w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"], prec)


def _encode(tok, w, pre, cfg, prec):
    for i in range(cfg["depth"]):
        tok = _block(tok, w, f"{pre}blocks.{i}.", cfg["num_heads"],
                     cfg["ln_eps"], prec)
    d = tok.shape[-1]
    return F.layer_norm(tok[:, 0], (d,), w[pre + "norm.weight"],
                        w[pre + "norm.bias"], cfg["ln_eps"])


def vit256(tiles: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
           prec: str = "f32") -> torch.Tensor:
    """Normalised tiles [B, T, T, 3] -> CLS [B, D]."""
    p = cfg["patch_size"]
    x = conv2d(tiles.permute(0, 3, 1, 2), w["vit256.patch_embed.proj.weight"],
               w["vit256.patch_embed.proj.bias"], p, 0, prec)
    b, d, gh, gw = x.shape
    tok = torch.cat([w["vit256.cls_token"].expand(b, -1, -1),
                     x.flatten(2).transpose(1, 2)], 1)
    tok = tok + resize_pos_embed(w["vit256.pos_embed"], gh, gw)
    return _encode(tok, w, "vit256.", cfg, prec)


def vit4k(grid: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
          prec: str = "f32") -> torch.Tensor:
    """CLS grid [R, gh, gw, 384] -> region features [R, 192]."""
    r, gh, gw, _ = grid.shape
    x = F.gelu(linear(grid.reshape(r, gh * gw, -1), w["vit4k.phi.0.weight"],
                      w["vit4k.phi.0.bias"], prec))
    tok = torch.cat([w["vit4k.cls_token"].expand(r, -1, -1), x], 1)
    tok = tok + resize_pos_embed(w["vit4k.pos_embed"], gh, gw)
    return _encode(tok, w, "vit4k.", cfg, prec)


def hipt4k(regions: torch.Tensor, w: Dict[str, torch.Tensor], enc: dict,
           prec: str = "f32", tiles_per_call: int = 256) -> torch.Tensor:
    """Normalised regions [R, S, S, 3] (f32) -> features [R, 192], one
    region at a time and ``tiles_per_call`` tiles per ViT-256 call."""
    t = enc["tile_size"]
    out = []
    for reg in regions:
        g = reg.shape[0] // t
        tiles = reg.reshape(g, t, g, t, 3).permute(0, 2, 1, 3, 4) \
            .reshape(g * g, t, t, 3)
        cls = torch.cat([vit256(tiles[i:i + tiles_per_call], w,
                                enc["vit256"], prec)
                         for i in range(0, g * g, tiles_per_call)])
        out.append(vit4k(cls.reshape(1, g, g, -1), w, enc["vit4k"], prec))
    return torch.cat(out)
