"""Prov-GigaPath's slide encoder (``gigapath_slide_enc12l768d``, Xu et al.,
Nature 2024; prov-gigapath gigapath/slide_encoder.py) and its linear head,
the model type ``gigapath_slide`` of ``build_mil_model``.

A bag of tile embeddings f [N, in_dim] (1536 from the published tile
encoder) with the tiles' level-0 coordinates c [N, 2] becomes:

1. tokens x_i = W_e f_i + b_e + P[pos_i], pos_i = floor(c_i0 / 256) *
   1000 + floor(c_i1 / 256) + 1, P MAE's fixed 2-D sin-cos table over a
   1000 x 1000 grid (row 0 zeros, row 1 + a 1000 + b = [sincos(b),
   sincos(a)]), and a CLS token cls + P[0] in front: N + 1 tokens;
2. 12 torchscale encoder layers, pre-LN with sub-LN (LayerNorm eps 1e-5):
   x += W_o LN_a(DilAttn(LN_1(x))), x += W_2 LN_f(GELU(W_1 LN_2(x))), the
   attention LongNet's dilated attention (ops/dilated_attention.py) over
   16 heads at the schedule ``get_optimal_segment_length(262144, 256)``
   with ratios 1, 2, 4, 8, 16;
3. the encoder's final LayerNorm, the slide encoder's ``norm`` (eps 1e-6);
   the CLS row is the slide embedding, and Linear(768 -> n_classes) the
   head.

Parameter names are the published state dict's (``patch_embed.proj``,
``encoder.layers.{i}.self_attn.{q,k,v,out}_proj``, ``.inner_attn_ln``,
``.self_attn_layer_norm``, ``.ffn.fc1 / fc2 / ffn_layernorm``,
``.final_layer_norm``, ``encoder.layer_norm``, ``norm``, ``cls_token``)
under ``slide_encoder.``, with the head at ``classifier.0`` as in
Prov-GigaPath's ``ClassificationHead``.

Precision: the weights and the linears' operands are in ``dtype`` (bf16 on
the card); the residual stream, LayerNorm statistics and the attention's
softmax, lse and merge in f32, GELU in f32 rounded to ``dtype``, as the
published fp16 autocast and torchscale keep them. The position rows
are gathered from two 1000 x 384 f32 tables (the sin-cos of each grid
coordinate, computed in float64 as MAE does, then rounded), which give
the published 3.07 GB table's rows bit for bit.

Unlike the attention-pool heads of models/abmil.py, the forward takes
``(bag, coords)``, one slide of any N at a time (no mask, no padding: a
pad row would change the segments and the answer), and has no per-tile
scores: its ``MILOutput.a_raw`` is None, ``extras["slide_embedding"]``
holds the CLS row [1, 768] and ``extras["tokens"]`` every token of the
last layer.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.models.abmil import MILOutput
from hipt_abmil_atec23_tpu_torch.ops import dilated_attention as _ops
from hipt_abmil_atec23_tpu_torch.ops.dilated_attention import (
    dilated_attention)
from hipt_abmil_atec23_tpu_torch.utils.logging import (
    count_event, recording, span_end, span_start)

TILE_SIZE = 256
SLIDE_NGRIDS = 1000
MAX_WSI_SIZE = 262144
DILATED_RATIOS = (1, 2, 4, 8, 16)


def optimal_segment_lengths(max_wsi_size: int = MAX_WSI_SIZE,
                            tile_size: int = TILE_SIZE) -> Tuple[int, ...]:
    """``LongNetViT.get_optimal_segment_length``: five lengths, 2^k for k
    evenly spaced from 10 to log2((max_wsi_size / tile_size)^2),
    truncated: (1024, 5792, 32768, 185363, 1048576) at the defaults."""
    max_seq_len = (max_wsi_size // tile_size) ** 2
    k = np.linspace(np.log2(1024), int(np.log2(max_seq_len)), 5)
    return tuple(int(v) for v in np.power(2, k).astype(int))


PUBLISHED_SCHEDULE = tuple(zip(optimal_segment_lengths(), DILATED_RATIOS))


def sincos_axis(dim: int, n: int) -> torch.Tensor:
    """[n, dim] f32: [sin(p w_k)]_k ++ [cos(p w_k)]_k for p = 0 .. n-1,
    w_k = 10000^(-k / (dim / 2)), in float64 then rounded (MAE's
    ``get_1d_sincos_pos_embed_from_grid``)."""
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.arange(n, dtype=np.float32), omega)
    # torch.tensor, not from_numpy: a model built under a device context
    # gets its table there
    return torch.tensor(np.concatenate([np.sin(out), np.cos(out)], 1)
                        .astype(np.float32))


def tile_positions(coords: torch.Tensor, tile_size: int = TILE_SIZE,
                   ngrids: int = SLIDE_NGRIDS) -> torch.Tensor:
    """``LongNetViT.coords_to_pos``: floor(c / tile_size), then c0 ngrids
    + c1 + 1, as int64 row indices of the position table; ValueError for
    a tile off the grid (CPU coords)."""
    grid = torch.floor(coords.double() / tile_size)
    pos = (grid[:, 0] * ngrids + grid[:, 1]).long() + 1
    # checked where it costs no wait for the card: serve's entry checks
    # its host coords before the copy
    if coords.device.type == "cpu" and len(pos) and (
            int(pos.min()) < 1 or int(pos.max()) > ngrids ** 2):
        raise ValueError(f"coords place a tile outside the {ngrids} x "
                         f"{ngrids} grid of {tile_size} px tiles")
    return pos


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, schedule, eps: float):
        super().__init__()
        self.heads, self.schedule = heads, schedule
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.inner_attn_ln = nn.LayerNorm(dim, eps=eps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        n = h.shape[0]
        q, k, v = (p(h).view(n, self.heads, -1)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        a = dilated_attention(q, k, v, self.schedule)
        return self.out_proj(_ln(self.inner_attn_ln, a, h.dtype))


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden: int, eps: float):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.ffn_layernorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # GELU in f32, rounded to the linears' dtype, as torchscale's
        # activation_fn(x.float()).type_as(x) (PyTorch's bf16 GELU is that)
        return self.fc2(_ln(self.ffn_layernorm, F.gelu(self.fc1(h)),
                            h.dtype))


class _Layer(nn.Module):
    def __init__(self, dim, heads, hidden, schedule, eps):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=eps)
        self.self_attn = _Attention(dim, heads, schedule, eps)
        self.final_layer_norm = nn.LayerNorm(dim, eps=eps)
        self.ffn = _FFN(dim, hidden, eps)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x + self.self_attn(_ln(self.self_attn_layer_norm, x, dtype))
        return x + self.ffn(_ln(self.final_layer_norm, x, dtype))


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """LayerNorm in f32 with its f32 parameters, rounded to ``dtype`` for
    the next linear (PyTorch's CUDA LayerNorm takes no bf16 input beside
    f32 parameters)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


class _Encoder(nn.Module):
    def __init__(self, dim, depth, heads, hidden, schedule, eps):
        super().__init__()
        self.layers = nn.ModuleList(
            [_Layer(dim, heads, hidden, schedule, eps) for _ in range(depth)])
        self.layer_norm = nn.LayerNorm(dim, eps=eps)


class _PatchEmbed(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, dim)


class LongNetViT(nn.Module):
    """The slide encoder: (bag [N, in_dim], coords [N, 2]) -> (the slide
    embedding [1, dim], the last layer's tokens [N + 1, dim] before the
    encoder's final LayerNorm, f32)."""

    def __init__(self, in_dim: int = 1536, dim: int = 768, depth: int = 12,
                 heads: int = 16, mlp_ratio: float = 4.0,
                 schedule: Sequence[Tuple[int, int]] = PUBLISHED_SCHEDULE,
                 tile_size: int = TILE_SIZE, ngrids: int = SLIDE_NGRIDS,
                 eps: float = 1e-5, norm_eps: float = 1e-6):
        super().__init__()
        self.tile_size, self.ngrids = tile_size, ngrids
        self.schedule = tuple((int(w), int(r)) for w, r in schedule)
        self.patch_embed = _PatchEmbed(in_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.encoder = _Encoder(dim, depth, heads, int(dim * mlp_ratio),
                                self.schedule, eps)
        self.norm = nn.LayerNorm(dim, eps=norm_eps)
        # the per-axis halves of MAE's table, not a checkpoint's entry
        self.register_buffer("pos_axis", sincos_axis(dim // 2, ngrids),
                             persistent=False)

    def position_rows(self, coords: torch.Tensor) -> torch.Tensor:
        """P[pos_i] [N, dim] f32 for the tiles at ``coords``."""
        pos = tile_positions(coords, self.tile_size, self.ngrids) - 1
        a, b = pos // self.ngrids, pos % self.ngrids
        return torch.cat([self.pos_axis[b], self.pos_axis[a]], 1)

    def forward(self, bag: torch.Tensor, coords: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.patch_embed.proj.weight.dtype
        t = span_start()
        x = self.patch_embed.proj(bag.to(dtype)).float() \
            + self.position_rows(coords)
        x = torch.cat([self.cls_token[0].float(), x])
        t = span_end(t, "longnet.embed", rows=len(bag))
        for layer in self.encoder.layers:
            x = layer(x, dtype)
        # both final norms act row by row: the CLS row alone is the output
        emb = _ln(self.norm, _ln(self.encoder.layer_norm, x[:1],
                                 torch.float32), torch.float32)
        span_end(t, "longnet.layers", rows=len(bag))
        return emb, x


class GigaPathSlide(nn.Module):
    """``gigapath_slide``: the slide encoder and a linear head on the
    slide embedding. ``size`` is [in_dim, dim], as a MIL head's
    [input_dim, hidden_dim]. The encoder's Linear layers hold ``dtype``;
    LayerNorms, the CLS token and the head stay f32."""

    def __init__(self, n_classes: int = 2, in_dim: int = 1536,
                 dim: int = 768, depth: int = 12, heads: int = 16,
                 schedule: Sequence[Tuple[int, int]] = PUBLISHED_SCHEDULE,
                 dtype: torch.dtype = torch.float32, **encoder_kw):
        super().__init__()
        self.size = [in_dim, dim]
        self.n_classes = n_classes
        self.slide_encoder = LongNetViT(in_dim, dim, depth, heads,
                                        schedule=schedule, **encoder_kw)
        self.classifier = nn.Sequential(nn.Linear(dim, n_classes))
        for m in self.slide_encoder.modules():
            if isinstance(m, nn.Linear):
                m.to(dtype)

    def forward(self, bag: torch.Tensor, coords: torch.Tensor,
                **_) -> MILOutput:
        """bag [N, in_dim], coords [N, 2] (level-0 x, y) -> MILOutput with
        logits [1, C], y_prob, y_hat [1], a_raw None,
        ``extras["slide_embedding"]`` [1, dim] and ``extras["tokens"]``
        [N + 1, dim] (the last layer's output, before the final norms;
        both f32). While a profiler runs
        it records the count ``longnet.pairs`` (attention pairs of tokens
        per branch of one layer, ``ops.dilated_attention.branch_pairs``) and ``longnet.kernel`` (the dilated-attention
        wrapper's card calls and device launches in this forward)."""
        if bag.dim() != 2 or coords.shape != (bag.shape[0], 2):
            raise ValueError(f"gigapath_slide takes one bag [N, D] and its "
                             f"coords [N, 2], got {tuple(bag.shape)} and "
                             f"{tuple(coords.shape)}")
        enc, kernel = self.slide_encoder, _ops.dilated_attention
        calls, launches = kernel.calls, kernel.launches
        emb, tokens = enc(bag, coords)
        if recording():
            heads = enc.encoder.layers[0].self_attn.heads
            count_event("longnet.pairs", [
                _ops.branch_pairs(len(bag) + 1, w, r, heads)
                for w, r in enc.schedule])
            count_event("longnet.kernel", (kernel.calls - calls,
                                           kernel.launches - launches))
        logits = self.classifier(emb)
        return MILOutput(logits, torch.softmax(logits, -1),
                         torch.argmax(logits, -1), None,
                         {"slide_embedding": emb, "tokens": tokens})
