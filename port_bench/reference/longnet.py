"""Prov-GigaPath's slide encoder and linear head in plain PyTorch (Xu et
al., Nature 2024; prov-gigapath gigapath/slide_encoder.py ``LongNetViT``,
``gigapath_slide_enc12l768d``, on torchscale's LongNet encoder with
``DilatedAttention``; LongNet: Ding et al., arXiv 2307.02486).

1. Tokens: x_i = W_e f_i + b_e + P[pos_i] with pos_i = floor(c_i0 / 256) *
   1000 + floor(c_i1 / 256) + 1 and P MAE's ``get_2d_sincos_pos_embed(D,
   1000, cls_token=True)`` (float64, then f32; row 0 zeros); CLS = cls + P[0]
   in front.
2. Each of the 12 layers, pre-LN with torchscale's sub-LN (eps 1e-5):
   x += W_o LN_a(DilAttn(LN_1(x))); x += W_2 LN_f(GELU(W_1 LN_2(x))); every
   projection with a bias; dropout and drop-path inert.
3. DilAttn, branch by branch as torchscale's ``gathering``,
   ``dense_to_sparse``, ``sparse_to_dense`` and ``scattering`` write it:
   zero-pad the tokens to a multiple of w' = min(w, N), cut segments of
   w', zero-pad each to a multiple of r, rearrange 'b (l r1) (r2 h) d ->
   b l h d r1 r2' and keep the diagonal r1 = r2 (head group j takes the
   positions = j mod r), dense softmax attention per segment and head at
   scale d^-1/2 with no key mask (pads count, logit 0, value 0), out and
   log-sum-exp back through ``diag_embed`` (lse 0 -> -1e8), segments
   concatenated, padded rows cut, and the branches merged by the softmax
   of their lse.
4. The encoder's final LayerNorm (eps 1e-5), the slide encoder's norm
   (eps 1e-6); the CLS row is the slide embedding; logits = Linear(D ->
   C) of it.

Departures from the published code: none in the arithmetic. It runs in
f32 (TF32 off, reference/precision.py; ``prec`` rounds each product's
operands for a control) where the published demo runs fp16 autocast with
flash-attn; the position rows are computed for the tiles' positions
only, by the table's own float64 formula, rather than read from the
3.07 GB table; each branch's queries go in blocks so that 33k tokens fit.
``scattering`` concatenates segments of ceil(w'/r) r rows, which puts a
segment's rows off their tokens where N > w and r does not divide w; no
branch of the published schedule does that below 185,363 tiles, and this
reference refuses it.

The configuration's ``assumed`` list names what could not be checked
against the published code here: the sub-LN placement, zero-padded keys
unmasked, 16 heads, no embedding scale, the head on the final CLS.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.precision import linear, matmul

Weights = Dict[str, torch.Tensor]


def mae_pos_table(dim: int, grid: int) -> torch.Tensor:
    """MAE's ``get_2d_sincos_pos_embed(dim, grid, cls_token=True)`` as a
    [1 + grid^2, dim] f32 table, built whole as the published code builds
    it (numpy float64, then f32). For tests at small grids."""
    import numpy as np

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid, grid)
    emb = np.concatenate([one_d(dim // 2, mesh[0]), one_d(dim // 2, mesh[1])],
                         axis=1)
    emb = np.concatenate([np.zeros([1, dim]), emb], axis=0)
    return torch.from_numpy(emb).float()


def pos_rows(pos: torch.Tensor, dim: int, grid: int = 1000) -> torch.Tensor:
    """Rows ``pos`` of ``mae_pos_table(dim, grid)`` without the table: row
    1 + a grid + b is [sincos(b), sincos(a)], each half [sin(p w_k)] ++
    [cos(p w_k)], w_k = 10000^(-k / (dim / 4)), in float64 then f32."""
    k = torch.arange(dim // 4, dtype=torch.float64, device=pos.device)
    omega = 1.0 / 10000 ** (k / (dim / 4.0))
    a = ((pos - 1) // grid).double()
    b = ((pos - 1) % grid).double()

    def half(p):
        out = p[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], 1)

    rows = torch.cat([half(b), half(a)], 1)
    return torch.where((pos > 0)[:, None], rows, 0.0).float()


def _ln(x, w, name, eps):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], eps)


def _dense_to_sparse(x: torch.Tensor, r: int) -> torch.Tensor:
    """[S, g, H, d] -> [S, l, H, d]: pad g to a multiple of r, 'b (l r1)
    (r2 h) d -> b l h d r1 r2', the diagonal, 'b l h d r -> b l (r h)
    d'."""
    s, g, h, d = x.shape
    x = F.pad(x, (0, 0, 0, 0, 0, -g % r))
    length = x.shape[1] // r
    x = x.view(s, length, r, r, h // r, d)           # b l r1 r2 h d
    x = torch.diagonal(x, dim1=2, dim2=3)             # b l h d r
    return x.permute(0, 1, 4, 2, 3).reshape(s, length, h, d)


def _sparse_to_dense(o: torch.Tensor, lse: torch.Tensor, r: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """o [S, l, H, d], lse [S, H, l] -> o [S, H, l r, d] and lse [S, H, l r]
    through ``diag_embed``: position l r + r1 of head group r2 holds the
    value where r1 = r2, 0 (o) and -1e8 (lse, also where it was 0)
    elsewhere."""
    s, length, h, d = o.shape
    o = o.reshape(s, length, r, h // r, d).permute(0, 1, 3, 4, 2)  # b l h d r
    o = torch.diag_embed(o, dim1=4, dim2=5)          # b l h d r1 r2
    o = o.permute(0, 5, 2, 1, 4, 3).reshape(s, h, length * r, d)
    lse = lse.reshape(s, r, h // r, length).permute(0, 3, 2, 1)    # b l h r
    lse = torch.diag_embed(lse, dim1=3, dim2=4)       # b l h r1 r2
    lse = lse.masked_fill(lse == 0, -1e8)
    lse = lse.permute(0, 4, 2, 1, 3).reshape(s, h, length * r)
    return o, lse


def _attend(q, k, v, prec: str, block: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense softmax attention per batch row, q, k, v [B, l, d] -> (out [B,
    l, d], lse [B, l]), queries in blocks."""
    scale = q.shape[-1] ** -0.5
    outs, lses = [], []
    kt = k.transpose(1, 2)
    for i in range(0, q.shape[1], block):
        s = matmul(q[:, i:i + block], kt, prec) * scale
        lse = torch.logsumexp(s, -1)
        outs.append(matmul(torch.exp(s - lse[..., None]), v, prec))
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      schedule: Sequence[Tuple[int, int]],
                      prec: str = "f32") -> torch.Tensor:
    """q, k, v [N, H, d] -> the merged attention [N, H d]."""
    n, h, d = q.shape
    outs, lses = [], []
    for w, r in schedule:
        wp = min(w, n)
        if h % r or (n > wp and wp % r):
            raise ValueError(f"branch ({w}, {r}) at N {n}: H % r or a "
                             "segment length r does not divide")

        def gathering(x):
            x = F.pad(x, (0, 0, 0, 0, 0, -n % wp))
            x = _dense_to_sparse(x.view(-1, wp, h, d), r)
            return x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], d)

        qi, ki, vi = gathering(q), gathering(k), gathering(v)
        o, lse = _attend(qi, ki, vi, prec)
        segs, length = qi.shape[0] // h, qi.shape[1]
        o, lse = _sparse_to_dense(o.view(segs, h, length, d).transpose(1, 2),
                                  lse.view(segs, h, length), r)
        outs.append(o.permute(1, 0, 2, 3).reshape(h, -1, d)[:, :n])
        lses.append(lse.permute(1, 0, 2).reshape(h, -1)[:, :n])
    lse = torch.stack(lses)                              # [B, H, N]
    wgt = torch.exp(lse - lse.max(0).values)
    wgt = wgt / wgt.sum(0)
    out = sum(o * a[..., None] for o, a in zip(outs, wgt))  # [H, N, d]
    return out.transpose(0, 1).reshape(n, h * d)


def gigapath_slide(bag: torch.Tensor, coords: torch.Tensor, w: Weights,
                   cfg: dict, prec: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bag [N, in_dim] f32, coords [N, 2] -> (slide embedding [D], logits
    [C], the last layer's tokens [N + 1, D] before the final norms).
    ``cfg`` is the configuration's ``model`` entry; ``w`` a state dict in
    the published layout (``slide_encoder.``, ``classifier.0.``)."""
    e = "slide_encoder."
    dim, heads = cfg["embed_dim"], cfg["num_heads"]
    schedule = list(zip(cfg["segment_length"], cfg["dilated_ratio"]))
    grid = torch.floor(coords.double() / cfg["tile_size"])
    pos = (grid[:, 0] * cfg["slide_ngrids"] + grid[:, 1]).long() + 1
    x = linear(bag, w[e + "patch_embed.proj.weight"],
               w[e + "patch_embed.proj.bias"], prec)
    x = x + pos_rows(pos, dim, cfg["slide_ngrids"])
    x = torch.cat([w[e + "cls_token"][0], x])            # + P[0] = 0
    eps = cfg["ln_eps"]
    for i in range(cfg["depth"]):
        p = f"{e}encoder.layers.{i}."
        a = p + "self_attn."
        hx = _ln(x, w, p + "self_attn_layer_norm", eps)
        q, k, v = (linear(hx, w[a + f"{t}_proj.weight"],
                          w[a + f"{t}_proj.bias"], prec).view(
                              len(hx), heads, -1) for t in "qkv")
        att = _ln(dilated_attention(q, k, v, schedule, prec), w,
                  a + "inner_attn_ln", eps)
        x = x + linear(att, w[a + "out_proj.weight"], w[a + "out_proj.bias"],
                       prec)
        hx = _ln(x, w, p + "final_layer_norm", eps)
        hx = F.gelu(linear(hx, w[p + "ffn.fc1.weight"], w[p + "ffn.fc1.bias"],
                           prec))
        hx = _ln(hx, w, p + "ffn.ffn_layernorm", eps)
        x = x + linear(hx, w[p + "ffn.fc2.weight"], w[p + "ffn.fc2.bias"],
                       prec)
    emb = _ln(_ln(x, w, e + "encoder.layer_norm", eps), w, e + "norm",
              cfg["norm_eps"])[0]
    logits = linear(emb, w["classifier.0.weight"], w["classifier.0.bias"],
                    prec)
    return emb, logits, x

