"""DINO Vision Transformers: ViT-256 (patch encoder) and ViT-4K (region
encoder), inference only: the CLS feature, the last block's attention
probabilities and the intermediate layers.

Counterpart of hipt_abmil_atec23_tpu/models/vit.py, with its three block
configurations (the JAX defaults: all off):

- ``use_fused_block``: tokens pad once per network (257 -> 264) and
  ``n_valid`` threads into every block, so each block is one call of
  ops/fused_block.py; the residual stream stays in the compute dtype.
- per-op (otherwise), on the 257 unpadded tokens: LayerNorm (f32 out) ->
  ``qkv`` Dense -> attention -> ``proj`` Dense + residual -> the MLP half.
  Dense layers compute in ``dtype`` and add their bias in ``dtype``, as
  flax ``Dense(dtype=...)`` does. Attention is the XLA-path einsum chain,
  or with ``use_flash`` ops/flash_attention.py ``attention``; the MLP half
  is LN + Dense/GELU/Dense + residual, or with ``use_fused_mlp`` one
  ops/fused_mlp.py ``fused_ln_mlp_residual`` call. Block 0 reads the f32
  tokens unrounded; the residual stream follows torch's promotion, which
  is JAX's here (f32 + bf16 -> f32, bf16 + bf16 -> bf16).

Kernel ops run their CUDA kernels on a CUDA tensor and their plain versions
on a CPU tensor. The final LayerNorm reads the unpadded CLS token in f32.
``get_last_selfattention`` walks the blocks before the last one as
configured, then takes the last block's probabilities by the exact path
(no kernel; softmax in f32, rounded to ``dtype``), as the JAX package's
``return_attn`` does.

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
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.ops.flash_attention import attention
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)
from hipt_abmil_atec23_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp_residual, fused_mlp, fused_mlp_reference, mlp_weights)
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
    use_flash: bool = False        # attention through ops/flash_attention
    use_fused_mlp: bool = False    # LN + MLP + residual as one kernel
    use_fused_block: bool = False  # the whole block as ops/fused_block


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
    use_flash: bool = False
    use_fused_mlp: bool = False
    use_fused_block: bool = False


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax Dense(dtype=dtype): input, kernel and bias promoted to
    ``dtype``, so the product rounds to ``dtype`` before a ``dtype`` bias
    add."""
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def _ln_f32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax LayerNorm with f32 parameters: f32 math and output whatever the
    input dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class Attention(nn.Module):
    """DINO attention (qkv, proj). The fused block kernel reads these
    parameters; the per-op forward runs qkv -> softmax(q k^T) v -> proj,
    the middle through ops/flash_attention.py with ``use_flash``."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def _qkv(self, x: torch.Tensor):
        b, n, c = x.shape
        h = self.num_heads
        qkv = _dense(x, self.qkv, self.dtype).view(b, n, 3, h, c // h)
        return qkv.permute(2, 0, 3, 1, 4)                 # [3, b, h, n, hd]

    def _probs(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        return torch.softmax(s, dim=-1).to(self.dtype)

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """The exact path's attention probabilities [b, h, n, n]: softmax
        in f32, rounded to the compute dtype (JAX vit.py:190), whatever
        ``use_flash`` says."""
        q, k, _ = self._qkv(x)
        return self._probs(q, k)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self._qkv(x)
        if self.use_flash:
            out = attention(*(t.reshape(b * h, n, hd) for t in (q, k, v)),
                            plain=plain).view(b, h, n, hd)
        else:
            out = (self._probs(q, k).float() @ v.float()).to(self.dtype)
        out = out.permute(0, 2, 1, 3).reshape(b, n, c)
        return _dense(out, self.proj, self.dtype)


class Mlp(nn.Module):
    """DINO MLP (fc1, fc2). The fused block kernel reads these parameters;
    the forward is Dense -> exact GELU -> Dense, or with ``use_fused`` one
    ops/fused_mlp.py ``fused_mlp`` call on the same parameters."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_fused = use_fused
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if self.use_fused:
            w1, b1, w2, b2 = mlp_weights(self, self.dtype, x.device)
            x = x.to(self.dtype)
            if plain:
                return fused_mlp_reference(x, None, None, w1, b1, w2, b2,
                                           with_ln=False, residual=False)
            return fused_mlp(x, w1, b1, w2, b2)
        return _dense(F.gelu(_dense(x, self.fc1, self.dtype)), self.fc2,
                      self.dtype)


class Block(nn.Module):
    """Pre-norm transformer block, dispatched as the JAX Block is: with
    ``use_fused_block`` one fused_vit_block call on padded tokens and
    ``n_valid``; otherwise the per-op path (module docstring). With
    ``plain`` set every kernel op runs its plain PyTorch version on any
    device, for holding the kernels against it on the card."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 eps: float, *, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, use_fused_mlp: bool = False,
                 use_fused_block: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.dtype = dtype
        self.use_fused_mlp = use_fused_mlp
        self.use_fused_block = use_fused_block
        self.plain = False
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, dtype, use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor, n_valid: Optional[int] = None
                ) -> torch.Tensor:
        if self.use_fused_block:
            x = x.to(self.dtype)
            if not self.plain:
                return fused_vit_block(x, self, num_heads=self.num_heads,
                                       n_valid=n_valid, eps=self.eps)
            # what fused_vit_block computes on this device: bf16 operands
            # on the card at any residual dtype, the exact block on the CPU
            return fused_vit_block_reference(
                x, self, num_heads=self.num_heads, n_valid=n_valid,
                eps=self.eps,
                operand_dtype=torch.bfloat16 if x.is_cuda else None)
        x = x + self.attn(_ln_f32(x, self.norm1), plain=self.plain)
        if not self.use_fused_mlp:
            return x + self.mlp(_ln_f32(x, self.norm2), plain=self.plain)
        w1, b1, w2, b2 = mlp_weights(self.mlp, self.dtype, x.device)
        args = (x.to(self.dtype), self.norm2.weight, self.norm2.bias, w1, b1,
                w2, b2)
        if self.plain:
            return fused_mlp_reference(*args, with_ln=True, residual=True,
                                       eps=self.eps)
        return fused_ln_mlp_residual(*args, eps=self.eps)

    def attention_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The block's attention probabilities on unpadded tokens x, by the
        exact LN -> Attention path whatever the block's configuration, as
        the JAX Block computes them for ``return_attn`` (vit.py:225): never
        a kernel. The MLP half cannot change them, so it does not run."""
        return self.attn.probs(_ln_f32(x, self.norm1))


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
    """The block walk both ViTs share, with ``forward`` (LN of the CLS after
    every block), ``get_last_selfattention`` and ``get_intermediate_layers``
    on it; subclasses give ``prepare_tokens``."""

    def _init_blocks(self, dim, depth, cfg):
        self.blocks = nn.ModuleList(
            Block(dim, cfg.num_heads, cfg.mlp_ratio, cfg.ln_eps,
                  dtype=cfg.dtype, use_flash=cfg.use_flash,
                  use_fused_mlp=cfg.use_fused_mlp,
                  use_fused_block=cfg.use_fused_block)
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=cfg.ln_eps)
        self._pe = _PosEmbedCache()

    def walk(self, tok: torch.Tensor, stop: Optional[int] = None
             ) -> Iterator[Tuple[torch.Tensor, int]]:
        """(tokens, n) on entry and after each of ``blocks[:stop]``, n the
        count of valid tokens. Under ``use_fused_block`` the tokens pad
        once, here, to a multiple of 8 and stay padded (slice ``[:, :n]``),
        and every block masks the padded keys by n; otherwise a block
        ignores n."""
        n = tok.shape[1]
        if self.cfg.use_fused_block:
            tok = _pad_tokens(tok)
        yield tok, n
        for blk in self.blocks[:stop]:
            tok = blk(tok, n)
            yield tok, n

    def prefix(self, tok: torch.Tensor, stop: Optional[int] = None
               ) -> Tuple[torch.Tensor, int]:
        """The last (tokens, n) of ``walk``."""
        for out in self.walk(tok, stop):
            pass
        return out

    def cls(self, tok: torch.Tensor) -> torch.Tensor:
        """LN of the CLS token, f32; LN is per token, so normalising the CLS
        alone equals LN-then-slice."""
        return _ln_f32(tok[:, 0], self.norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cls(self.prefix(self.prepare_tokens(x))[0])

    def get_last_selfattention(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's attention probabilities [B, heads, n, n] over
        the unpadded tokens (reference: vision_transformer.py:255-262),
        after the configured walk of the blocks before it."""
        tok, n = self.prefix(self.prepare_tokens(x), -1)
        return self.blocks[-1].attention_probs(tok[:, :n])

    def get_intermediate_layers(self, x: torch.Tensor, n: int = 1
                                ) -> List[torch.Tensor]:
        """LN of every unpadded token after each of the last ``n`` blocks,
        f32."""
        steps = self.walk(self.prepare_tokens(x))
        next(steps)
        depth = len(self.blocks)
        return [_ln_f32(tok[:, :nv], self.norm)
                for i, (tok, nv) in enumerate(steps) if depth - i <= n]


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
        self._init_blocks(cfg.embed_dim, cfg.depth, cfg)

    @property
    def feat_dim(self) -> int:
        return self.cfg.embed_dim

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype ``forward`` computes in; pixels given in it are not
        cast again."""
        return self.cfg.dtype

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Patch embedding, CLS and pos-embed: [B, 1 + gh*gw, D] f32."""
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
        return tok


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
        self._init_blocks(cfg.output_embed_dim, cfg.depth, cfg)

    def prepare_tokens(self, grid: torch.Tensor) -> torch.Tensor:
        """phi over the grid, CLS and pos-embed: [B, 1 + gh*gw, 192] f32."""
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
        return tok


def vit_small(dtype: torch.dtype = torch.float32, *,
              use_fused_block: bool = False,
              cfg: ViTConfig = VIT_CONFIGS["vit_small"],
              generator: Optional[torch.Generator] = None
              ) -> VisionTransformer:
    """ViT-256 alone (the vit256 encoder): ``cfg`` (vit_small by default)
    at the compute dtype, each block the fused block kernel with
    ``use_fused_block``; seeded DINO-scheme weights with a generator,
    zeros otherwise."""
    model = VisionTransformer(dataclasses.replace(
        cfg, dtype=dtype, use_fused_block=use_fused_block))
    if generator is not None:
        init_dino_(model, generator)
    return model


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
