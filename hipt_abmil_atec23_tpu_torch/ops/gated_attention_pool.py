"""Gated-attention MIL pooling as a hand-written CUDA kernel
(kernels/csrc/gated_pool.cu), with its plain PyTorch version beside it.

Counterpart of hipt_abmil_atec23_tpu/ops/gated_attention_pool.py (the TPU
kernel ``_kernel``, launcher ``_pallas_pool``): over a masked bag

    h = relu(X W_f + b_f), a = tanh(h W_a + b_a), g = sigmoid(h W_b + b_b),
    s = (a * g) w_c + b_c, masked to -1e30,
    logits = (sum_i w_i h_i) W_cls + b_cls with w = softmax over valid s,

returning the logits and the raw scores (the heatmap contract,
model_clam.py:151). Masked rows weigh exactly 0, so an all-masked bag gives
the bias logits. All math is f32.

A CUDA bag launches the kernel, a CPU bag runs
``gated_attention_pool_reference``. Nothing else falls back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build

NEG_INF = -1e30


class GatedPoolParams(NamedTuple):
    """Pooling weights in the JAX package's [in, out] layout, f32."""
    w_f: torch.Tensor    # [D_in, L]
    b_f: torch.Tensor    # [L]
    w_a: torch.Tensor    # [L, D]
    b_a: torch.Tensor    # [D]
    w_b: torch.Tensor    # [L, D]
    b_b: torch.Tensor    # [D]
    w_c: torch.Tensor    # [D, 1]
    b_c: torch.Tensor    # [1]
    w_cls: torch.Tensor  # [L, C]
    b_cls: torch.Tensor  # [C]


def params_from_clam(model) -> GatedPoolParams:
    """The pooling weights of a models.abmil.CLAM_SB."""
    fc, _, attn = model.attention_net

    def t(lin):
        return lin.weight.detach().float().t().contiguous()

    def b(lin):
        return lin.bias.detach().float().contiguous()

    a, g, c = attn.attention_a[0], attn.attention_b[0], attn.attention_c
    cls = model.classifiers
    return GatedPoolParams(t(fc), b(fc), t(a), b(a), t(g), b(g), t(c), b(c),
                           t(cls), b(cls))


def gated_attention_pool_reference(bag: torch.Tensor, mask: torch.Tensor,
                                   p: GatedPoolParams
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (logits [C], scores [N]).

    Equals the JAX package's jnp oracle whenever one instance is valid; on
    an all-masked bag it follows the TPU kernel (bias logits), not the
    oracle's uniform softmax over padding."""
    bag = bag.float()
    h = torch.relu(bag @ p.w_f + p.b_f)
    a = torch.tanh(h @ p.w_a + p.b_a)
    g = torch.sigmoid(h @ p.w_b + p.b_b)
    s = ((a * g) @ p.w_c + p.b_c)[:, 0]
    s = torch.where(mask.to(torch.bool), s, torch.full_like(s, NEG_INF))
    valid = s > 0.5 * NEG_INF
    e = torch.where(valid, torch.exp(s - s.max()), torch.zeros_like(s))
    pooled = (e @ h) / torch.clamp(e.sum(), min=1e-30)
    return pooled @ p.w_cls + p.b_cls, s


def _lib() -> ctypes.CDLL:
    lib = build.load("gated_pool")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gated_pool_forward.argtypes = (
            [vp, vp, i, i, i, i, i, i] + [vp] * 10 + [vp] * 3 + [vp])
        lib.gated_pool_forward.restype = i
        lib.gated_pool_tile.argtypes = []
        lib.gated_pool_tile.restype = i
        lib.gated_pool_error_string.argtypes = [i]
        lib.gated_pool_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def gated_attention_pool(bag: torch.Tensor, p: GatedPoolParams,
                         n_valid: Optional[int] = None,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled forward: (logits [1, C], raw scores [N]). bag [N, D_in];
    validity from ``mask`` [N] bool or a prefix length ``n_valid`` (both
    data, no rebuild). The CUDA kernel takes L <= 128."""
    n, d_in = bag.shape
    if n == 0:
        raise ValueError("gated_attention_pool needs a non-empty bag")
    if mask is None and n_valid is None:
        n_valid = n
    if bag.device.type == "cpu":
        if mask is None:
            mask = torch.arange(n) < n_valid
        logits, scores = gated_attention_pool_reference(bag, mask, p)
        return logits[None, :], scores
    l_dim, d_att = p.w_a.shape
    c_dim = p.w_cls.shape[1]
    if l_dim > 128:
        raise ValueError(f"gated_attention_pool kernel takes L <= 128, "
                         f"got {l_dim}")
    dev = bag.device
    bag = bag.float().contiguous()
    w = [t.detach().to(dev, torch.float32).contiguous() for t in p]
    mask_u8 = None if mask is None else \
        mask.to(dev, torch.uint8).contiguous()
    lib = _lib()
    tiles = -(-n // lib.gated_pool_tile())
    scores = torch.empty(n, device=dev, dtype=torch.float32)
    part = torch.empty((tiles, 2 + l_dim), device=dev, dtype=torch.float32)
    logits = torch.empty((1, c_dim), device=dev, dtype=torch.float32)
    err = lib.gated_pool_forward(
        bag.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(),
        0 if n_valid is None else int(n_valid), n, d_in, l_dim, d_att, c_dim,
        *[t.data_ptr() for t in w], scores.data_ptr(), part.data_ptr(),
        logits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "gated_pool_error_string", err, "gated_attention_pool")
    gated_attention_pool.launches += 1
    return logits, scores


gated_attention_pool.launches = 0  # kernel launches on CUDA


def apply_pooled(model, bag: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
    """Full-bag deterministic MIL forward with pooled-kernel dispatch: a
    single-branch gated CLAM head pools every bag through
    ``gated_attention_pool`` (the CUDA kernel on the card, its plain version
    on the CPU); any other head runs ``model(bag, mask)``.

    The JAX package also routes by bag size (a band set on a TPU). No size
    band is kept here: on the H100 the kernel beat the plain version at
    every bag size measured, 512 to 100k instances.

    Returns a ``models.abmil.MILOutput`` (extras empty on the pooled path).
    """
    from hipt_abmil_atec23_tpu_torch.models.abmil import MILOutput

    eligible = (getattr(model, "multi_branch", True) is False
                and getattr(model, "gate", False) is True)
    if not eligible:
        return model(bag, mask)
    logits, scores = gated_attention_pool(bag, params_from_clam(model),
                                          mask=mask)
    y_prob = torch.softmax(logits, dim=-1)
    y_hat = torch.argmax(logits, dim=-1)
    return MILOutput(logits, y_prob, y_hat, scores[None, :], {})
