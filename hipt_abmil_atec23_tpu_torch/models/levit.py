"""LeViT hybrid conv / attention texture encoder.

Counterpart of hipt_abmil_atec23_tpu/models/levit.py: the original LeViT
(Graham et al., ICCV 2021; the model behind the reference's
``timm.create_model('levit_256')``, extract_features_fp.py:211-212): a
conv-16x stem, three attention stages with learned relative attention-bias
tables, stride-2 query-subsampled attention between stages, and
mean-pooled features. Both ``levit_128s`` (384-d) and ``levit_256``
(512-d) specs.

Inference only: every Linear+BN1d / Conv+BN2d pair of an original-layout
checkpoint is folded into one biased Linear / Conv2d when it is converted
(``levit_state_dict_from_torch``), as the JAX package folds it. The
parameters live in the compute dtype. The attention is plain einsum and
softmax (XLA in the JAX package, no Pallas kernel): logits in f32 from the
compute-dtype q and k, the softmax in f32, its probabilities cast back.

The forward takes normalized NHWC [B, H, W, 3] and centre-crops it to the
model's 224 px input first when it is larger (the reference crops 256 ->
224 before LeViT, extract_features_fp.py:149-150).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SPECS: Dict[str, Dict[str, Any]] = {
    # embed_dim per stage, key_dim, num_heads per stage, depth per stage
    "levit_128s": dict(embed_dim=(128, 256, 384), key_dim=16,
                       num_heads=(4, 6, 8), depth=(2, 3, 4)),
    "levit_256": dict(embed_dim=(256, 384, 512), key_dim=32,
                      num_heads=(4, 6, 8), depth=(4, 4, 4)),
}
ATTN_RATIO = 2          # v width multiple in stage attention
SUB_ATTN_RATIO = 4      # v width multiple in subsample attention
MLP_RATIO = 2
BN_EPS = 1e-5


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def _bias_idxs(res: int) -> Tuple[np.ndarray, int]:
    """[N, N] indices into the per-head offset table (unique |dx|, |dy|
    offsets, in the order the original Attention.__init__ meets them)."""
    points = list(itertools.product(range(res), repeat=2))
    offsets: Dict[Tuple[int, int], int] = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            idxs.append(offsets.setdefault(off, len(offsets)))
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n), len(offsets)


def _sub_bias_idxs(res: int, stride: int) -> Tuple[np.ndarray, int, int]:
    """[N_, N] indices for the subsample attention (queries on the strided
    grid, keys on the full grid); also the table size and N_'s side."""
    res_ = (res - 1) // stride + 1
    points = list(itertools.product(range(res), repeat=2))
    points_ = list(itertools.product(range(res_), repeat=2))
    offsets: Dict[Tuple[int, int], int] = {}
    idxs = []
    for p1 in points_:
        for p2 in points:
            off = (abs(p1[0] * stride - p2[0]), abs(p1[1] * stride - p2[1]))
            idxs.append(offsets.setdefault(off, len(offsets)))
    return (np.asarray(idxs, np.int64).reshape(len(points_), len(points)),
            len(offsets), res_)


def stage_plan(spec: Mapping[str, Any], res0: int) -> List[Dict[str, Any]]:
    """The flat block list of the original ``blocks`` Sequential: attn /
    mlp pairs per stage, subsample + mlp between stages."""
    plan, res = [], res0
    kd = spec["key_dim"]
    dims = spec["embed_dim"]
    for si, (dim, depth, nh) in enumerate(zip(dims, spec["depth"],
                                              spec["num_heads"])):
        for _ in range(depth):
            plan.append(dict(kind="attn", dim=dim, nh=nh, kd=kd, res=res))
            plan.append(dict(kind="mlp", dim=dim, hidden=MLP_RATIO * dim))
        if si + 1 < len(dims):
            plan.append(dict(kind="sub", dim=dim, dim_out=dims[si + 1],
                             nh=dim // kd, kd=kd, res=res, stride=2))
            res = (res - 1) // 2 + 1
            plan.append(dict(kind="mlp", dim=dims[si + 1],
                             hidden=MLP_RATIO * dims[si + 1]))
    return plan


def _softmax_attn(q, k, v, table, idxs, kd):
    """softmax(q k^T / sqrt(kd) + bias) v with q, k, v [B, N, H, d]: the
    logits and softmax in f32, the probabilities and output in v's
    dtype."""
    attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (kd ** -0.5)
    attn = (attn + table[:, idxs].float()).softmax(-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class Attention(nn.Module):
    """Stage attention with its residual."""

    def __init__(self, dim: int, nh: int, kd: int, res: int):
        super().__init__()
        self.nh, self.kd, self.d = nh, kd, ATTN_RATIO * kd
        self.qkv = nn.Linear(dim, nh * (2 * kd + self.d))
        self.proj = nn.Linear(nh * self.d, dim)
        idxs, n_off = _bias_idxs(res)
        self.attention_biases = nn.Parameter(torch.zeros(nh, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs),
                             persistent=False)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.qkv(x).view(b, n, self.nh, -1).split(
            [self.kd, self.kd, self.d], -1)
        out = _softmax_attn(q, k, v, self.attention_biases,
                            self.attention_bias_idxs, self.kd)
        return x + self.proj(hardswish(out.reshape(b, n, self.nh * self.d)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return x + self.lin2(hardswish(self.lin1(x)))


class Subsample(nn.Module):
    """Shrink block: queries from the stride-2 grid, the width changes, no
    residual."""

    def __init__(self, dim: int, dim_out: int, nh: int, kd: int, res: int,
                 stride: int):
        super().__init__()
        self.nh, self.kd, self.d = nh, kd, SUB_ATTN_RATIO * kd
        self.res, self.stride = res, stride
        self.kv = nn.Linear(dim, nh * (kd + self.d))
        self.q = nn.Linear(dim, nh * kd)
        self.proj = nn.Linear(nh * self.d, dim_out)
        idxs, n_off, _ = _sub_bias_idxs(res, stride)
        self.attention_biases = nn.Parameter(torch.zeros(nh, n_off))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs),
                             persistent=False)

    def forward(self, x):
        b, n, c = x.shape
        k, v = self.kv(x).view(b, n, self.nh, -1).split([self.kd, self.d],
                                                        -1)
        xq = x.view(b, self.res, self.res, c)[:, ::self.stride, ::self.stride]
        xq = xq.reshape(b, -1, c)
        q = self.q(xq).view(b, xq.shape[1], self.nh, self.kd)
        out = _softmax_attn(q, k, v, self.attention_biases,
                            self.attention_bias_idxs, self.kd)
        return self.proj(hardswish(out.reshape(b, xq.shape[1],
                                               self.nh * self.d)))


class LeViT(nn.Module):
    """Folded LeViT: normalized NHWC [B, H, W, 3] -> [B, feat_dim] f32
    mean-pooled features (timm ``num_classes=0``)."""

    def __init__(self, spec: str = "levit_128s",
                 dtype: torch.dtype = torch.float32, img_size: int = 224):
        super().__init__()
        self.spec_name, self.spec = spec, SPECS[spec]
        self.dtype, self.img_size = dtype, img_size
        self.feat_dim = self.spec["embed_dim"][-1]
        d0 = self.spec["embed_dim"][0]
        chans = (3, d0 // 8, d0 // 4, d0 // 2, d0)
        self.stem = nn.ModuleList(nn.Conv2d(a, b, 3, 2, 1)
                                  for a, b in zip(chans, chans[1:]))
        blocks = []
        for blk in stage_plan(self.spec, img_size // 16):
            if blk["kind"] == "attn":
                blocks.append(Attention(blk["dim"], blk["nh"], blk["kd"],
                                        blk["res"]))
            elif blk["kind"] == "mlp":
                blocks.append(Mlp(blk["dim"], blk["hidden"]))
            else:
                blocks.append(Subsample(blk["dim"], blk["dim_out"],
                                        blk["nh"], blk["kd"], blk["res"],
                                        blk["stride"]))
        self.blocks = nn.ModuleList(blocks)
        self.to(dtype)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.img_size
        if x.shape[1] != s:
            off = (x.shape[1] - s) // 2
            x = x[:, off:off + s, off:off + s, :]
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.stem):
            x = conv(x)
            if i < 3:
                x = hardswish(x)
        x = x.flatten(2).transpose(1, 2)            # [B, res0^2, C]
        for blk in self.blocks:
            x = blk(x)
        return x.mean(1).float()


def init_levit_(model: LeViT, generator: torch.Generator) -> LeViT:
    """The JAX package's LeViT.init scheme from ``generator``: linears
    normal(0, sqrt(2 / (in + out))), convs normal(0, sqrt(2 / (9 in))),
    biases and bias tables zero."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                std = (2.0 / (m.in_features + m.out_features)) ** 0.5
            elif isinstance(m, nn.Conv2d):
                std = (2.0 / (9 * m.in_channels)) ** 0.5
            else:
                if isinstance(m, (Attention, Subsample)):
                    m.attention_biases.zero_()
                continue
            w = torch.empty(m.weight.shape).normal_(0.0, std,
                                                    generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
    return model


def levit_texture_encoder(spec: str = "levit_128s",
                          dtype: torch.dtype = torch.float32, *,
                          generator: Optional[torch.Generator] = None
                          ) -> LeViT:
    m = LeViT(spec, dtype)
    return init_levit_(m, generator) if generator is not None else m


# --------------------------------------------------------------------------
# Checkpoint conversion (the original facebookresearch/LeViT naming, which
# timm's LeViT weights fuse down to)
# --------------------------------------------------------------------------

def _fold_linear_bn(sd: Mapping, prefix: str) -> Tuple[np.ndarray, ...]:
    """``{prefix}.c`` Linear(bias=False) + ``{prefix}.bn`` BatchNorm1d ->
    (weight [out, in], bias), exact at eval."""
    w = np.asarray(sd[f"{prefix}.c.weight"], np.float32)
    scale, shift = _bn_affine(sd, f"{prefix}.bn")
    return w * scale[:, None], shift


def _fold_conv_bn(sd: Mapping, prefix: str) -> Tuple[np.ndarray, ...]:
    """Conv2d(bias=False) + BatchNorm2d -> (OIHW weight, bias)."""
    w = np.asarray(sd[f"{prefix}.c.weight"], np.float32)
    scale, shift = _bn_affine(sd, f"{prefix}.bn")
    return w * scale[:, None, None, None], shift


def _bn_affine(sd: Mapping, bn: str):
    g, b = (np.asarray(sd[f"{bn}.{k}"], np.float32) for k in ("weight",
                                                             "bias"))
    rm, rv = (np.asarray(sd[f"{bn}.running_{k}"], np.float32)
              for k in ("mean", "var"))
    scale = g / np.sqrt(rv + BN_EPS)
    return scale, (b - rm * scale).astype(np.float32)


def _as_tensors(pairs: Dict[str, Tuple[np.ndarray, np.ndarray]]
                ) -> Dict[str, torch.Tensor]:
    out = {}
    for name, (w, b) in pairs.items():
        out[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(w))
        out[f"{name}.bias"] = torch.tensor(np.asarray(b, np.float32))
    return out


def levit_state_dict_from_torch(sd: Mapping[str, Any],
                                spec: str = "levit_128s",
                                img_size: int = 224
                                ) -> Dict[str, torch.Tensor]:
    """An original-layout LeViT state dict (patch_embed.{0,2,4,6}.c / bn,
    blocks.{i}.m.qkv ...) -> the port's folded state dict: every
    Linear / Conv + BN pair folded (the JAX package's
    levit_params_from_torch, models/levit.py:278-317). The checkpoint's
    bias index buffers are redundant (the port recomputes them)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    pairs = {f"stem.{j}": _fold_conv_bn(sd, f"patch_embed.{i}")
             for j, i in enumerate((0, 2, 4, 6))}
    tables = {}
    for ti, blk in enumerate(stage_plan(SPECS[spec], img_size // 16)):
        p = f"blocks.{ti}"
        if blk["kind"] == "attn":
            pairs[f"{p}.qkv"] = _fold_linear_bn(sd, f"{p}.m.qkv")
            pairs[f"{p}.proj"] = _fold_linear_bn(sd, f"{p}.m.proj.1")
            tables[p] = sd[f"{p}.m.attention_biases"]
        elif blk["kind"] == "mlp":
            pairs[f"{p}.lin1"] = _fold_linear_bn(sd, f"{p}.m.0")
            pairs[f"{p}.lin2"] = _fold_linear_bn(sd, f"{p}.m.2")
        else:
            pairs[f"{p}.kv"] = _fold_linear_bn(sd, f"{p}.kv")
            pairs[f"{p}.q"] = _fold_linear_bn(sd, f"{p}.q.1")
            pairs[f"{p}.proj"] = _fold_linear_bn(sd, f"{p}.proj.1")
            tables[p] = sd[f"{p}.attention_biases"]
    out = _as_tensors(pairs)
    for q, t in tables.items():
        out[f"{q}.attention_biases"] = torch.tensor(np.asarray(t, np.float32))
    return out


def levit_state_dict_from_jax(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's folded LeViT params ({'stem': [conv x4],
    'blocks': [...]}, kernels HWIO / [in, out]) -> the port's state
    dict."""
    def lin(p):
        return np.asarray(p["kernel"], np.float32).T, p["bias"]

    pairs = {f"stem.{i}": (np.asarray(p["kernel"], np.float32)
                           .transpose(3, 2, 0, 1), p["bias"])
             for i, p in enumerate(params["stem"])}
    tables = {}
    for ti, p in enumerate(params["blocks"]):
        q = f"blocks.{ti}"
        for name in ("qkv", "proj", "lin1", "lin2", "kv", "q"):
            if name in p:
                pairs[f"{q}.{name}"] = lin(p[name])
        if "bias_table" in p:
            tables[q] = p["bias_table"]
    out = _as_tensors(pairs)
    for q, t in tables.items():
        out[f"{q}.attention_biases"] = torch.tensor(np.asarray(t, np.float32))
    return out
