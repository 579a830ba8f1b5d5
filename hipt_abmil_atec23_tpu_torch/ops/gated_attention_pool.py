"""Gated-attention MIL pooling as a hand-written CUDA kernel
(kernels/csrc/gated_pool.cu), with its plain PyTorch version beside it.

Counterpart of hipt_abmil_atec23_tpu/ops/gated_attention_pool.py (the TPU
kernels ``_kernel`` and ``_kernel_dma``, launchers ``_pallas_pool`` and
``_pallas_pool_dma``): over a masked bag

    h = relu(X W_f + b_f), a = tanh(h W_a + b_a), g = sigmoid(h W_b + b_b),
    s = (a * g) w_c + b_c, masked to -1e30,
    logits = (sum_i w_i h_i) W_cls + b_cls with w = softmax over valid s,

returning the logits and the raw scores (the heatmap contract,
model_clam.py:151), or, in partial mode (the TPU kernel's ``partial_out``),
the shard-local online-softmax state (acc, m, l) that
``combine_partials`` merges across shards. Masked rows weigh exactly 0, so
an all-masked bag gives the bias logits. All math is f32.

A CUDA bag launches the kernel, a CPU bag runs
``gated_attention_pool_reference``. Nothing else falls back. Heads wider
than the HIPT ones run both products on the tensor cores as three tf32
products each; the kernel reads their weights in the layout
``split_weights`` makes once per parameter set.
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
    """The pooling weights of a models.abmil.CLAM_SB, made once and kept on
    the model until a parameter changes (its version) or moves, so the
    kernel's split weights (``split_weights``) are made once too."""
    stamp = tuple((t._version, t.data_ptr()) for t in model.parameters())
    hit = getattr(model, "_pool_params", None)
    if hit is None or hit[0] != stamp:
        hit = model._pool_params = (stamp, _params_from_clam(model))
    return hit[1]


def _params_from_clam(model) -> GatedPoolParams:
    fc, attn = model.attention_net[0], model.attention_net[-1]

    def t(lin):
        return lin.weight.detach().float().t().contiguous()

    def b(lin):
        return lin.bias.detach().float().contiguous()

    a, g, c = attn.attention_a[0], attn.attention_b[0], attn.attention_c
    cls = model.classifiers
    return GatedPoolParams(t(fc), b(fc), t(a), b(a), t(g), b(g), t(c), b(c),
                           t(cls), b(cls))


def gated_attention_pool_partial_reference(
        bag: torch.Tensor, mask: Optional[torch.Tensor], p: GatedPoolParams
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the partial kernel: (acc [1, L], m [], l [],
    scores [N]) with ``mask`` None meaning every row is valid. An
    all-masked bag gives m = -1e30, l = 0 and acc = 0, as the TPU kernel
    does."""
    bag = bag.float()
    h = torch.relu(bag @ p.w_f + p.b_f)
    a = torch.tanh(h @ p.w_a + p.b_a)
    g = torch.sigmoid(h @ p.w_b + p.b_b)
    s = ((a * g) @ p.w_c + p.b_c)[:, 0]
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, NEG_INF))
    m = s.max()
    e = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), torch.zeros_like(s))
    return (e @ h)[None, :], m, e.sum(), s


def gated_attention_pool_reference(bag: torch.Tensor, mask: torch.Tensor,
                                   p: GatedPoolParams
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (logits [C], scores [N]).

    Equals the JAX package's jnp oracle whenever one instance is valid; on
    an all-masked bag it follows the TPU kernel (bias logits), not the
    oracle's uniform softmax over padding."""
    acc, _, l, s = gated_attention_pool_partial_reference(bag, mask, p)
    return (acc[0] / torch.clamp(l, min=1e-30)) @ p.w_cls + p.b_cls, s


def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     p: GatedPoolParams) -> torch.Tensor:
    """Logits [1, C] from K shards' partials (acc [K, L], m [K], l [K]),
    the flash-attention combine of parallel/sharded_bag.py: shards rescale
    to the global max, an all-masked shard (m = -1e30, l = 0) weighs 0 and
    an all-masked bag gives the bias logits."""
    gmax = m.max()
    scale = torch.exp(m - gmax)
    l_g = (l * scale).sum()
    acc_g = (acc * scale[:, None]).sum(0, keepdim=True)
    return acc_g / torch.clamp(l_g, min=1e-30) @ p.w_cls + p.b_cls


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits, nearest, ties away from 0),
    as cvt.rna.tf32.f32 rounds on the card."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def k_permuted(w: torch.Tensor) -> torch.Tensor:
    """w [rows, K] with K zero-padded to a multiple of 8 and permuted in
    each 8: column 8b + t takes 8b + 2t and 8b + t + 4 takes 8b + 2t + 1
    (t < 4). The tf32 A fragment holds columns t and t + 4 of each 8, the
    accumulator the pairs 2t, 2t + 1: with B's K in this order a thread's
    A values are its own float2 pairs."""
    k8 = -(-w.shape[1] // 8) * 8
    w = torch.nn.functional.pad(w, (0, k8 - w.shape[1]))
    t = torch.arange(4, device=w.device)
    perm = (8 * torch.arange(k8 // 8, device=w.device)[:, None]
            + torch.cat([2 * t, 2 * t + 1])[None, :]).reshape(-1)
    return w[:, perm].contiguous()


def split_weights(p: GatedPoolParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core pass's weights: wf2 [2, L, Dk], the tf32 hi and lo
    of W_f^T, and wz2 [2, 2 D, Lk], of [W_a | W_b]^T with rows 2d = W_a[:,
    d] and 2d + 1 = W_b[:, d] (z_a[d] and z_b[d] side by side in a
    thread's accumulator); K permuted by ``k_permuted``. Kept on p.w_f
    until a weight changes in place (inference tensors keep no version and
    are taken as unchanged while they are the same objects)."""
    key = tuple((id(t), None if t.is_inference() else t._version)
                for t in (p.w_f, p.w_a, p.w_b))
    hit = getattr(p.w_f, "_hk_split", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    wa, wb = p.w_a.float(), p.w_b.float()
    wz = torch.stack([wa.t(), wb.t()], 1).reshape(-1, wa.shape[0])
    out = []
    for w in (p.w_f.float().t(), wz):
        w = k_permuted(w)
        hi = _tf32(w)
        out.append(torch.stack([hi, _tf32(w - hi)]).contiguous())
    p.w_f._hk_split = (key, tuple(out))
    return tuple(out)


def _lib() -> ctypes.CDLL:
    lib = build.load("gated_pool")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gated_pool_forward.argtypes = (
            [vp, vp, i, i, i, i, i, i] + [vp] * 10 + [vp] * 2 + [vp] * 4
            + [vp])
        lib.gated_pool_forward.restype = i
        lib.gated_pool_partial.argtypes = (
            [vp, vp, i, i, i, i, i] + [vp] * 8 + [vp] * 2 + [vp] * 5 + [vp])
        lib.gated_pool_partial.restype = i
        for fn in ("gated_pool_tile", "gated_pool_max_parts",
                   "gated_pool_max_l"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.gated_pool_variant.argtypes = [i, i]
        lib.gated_pool_variant.restype = i
        lib.gated_pool_scratch_float2.argtypes = [i, i, i]
        lib.gated_pool_scratch_float2.restype = ctypes.c_longlong
        lib.gated_pool_error_string.argtypes = [i]
        lib.gated_pool_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _check_impl(impl: str) -> None:
    if impl not in ("grid", "dma"):
        raise ValueError(f"impl must be 'grid' or 'dma', got {impl!r}")


def _launch(bag, p, n_valid, mask, partial: bool):
    """Run the CUDA kernel: (logits [1, C], scores) or, with ``partial``,
    (acc [1, L], m, l, scores)."""
    n, d_in = bag.shape
    l_dim, d_att = p.w_a.shape
    lib = _lib()
    variant = lib.gated_pool_variant(l_dim, d_att)
    if variant < 0:
        raise ValueError(f"gated_attention_pool kernel: a head of L={l_dim} "
                         f"is past the {lib.gated_pool_max_l()} columns its "
                         "running sums hold")
    dev = bag.device
    bag = bag.float().contiguous()
    w = [t.detach().to(dev, torch.float32).contiguous() for t in p]
    mask_u8 = None if mask is None else mask.to(dev, torch.uint8).contiguous()
    if mask_u8 is not None and mask_u8.shape != (n,):
        raise ValueError(f"mask {tuple(mask_u8.shape)} for a bag of {n}")
    tiles = -(-n // lib.gated_pool_tile())
    parts = min(tiles, lib.gated_pool_max_parts())
    f32 = dict(device=dev, dtype=torch.float32)
    scores = torch.empty(n, **f32)
    part = torch.empty((parts, 2 + l_dim), **f32)
    split, scratch = [None, None], None
    if variant == 1:
        split = [t.to(dev) for t in split_weights(p)]
        pairs = lib.gated_pool_scratch_float2(n, l_dim, d_att)
        if pairs < 0:
            raise RuntimeError("gated_attention_pool: the CUDA occupancy "
                               "query failed")
        scratch = torch.empty(2 * pairs, **f32)
    ptrs = [None if t is None else t.data_ptr() for t in split]
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (bag.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(),
            0 if n_valid is None else int(n_valid), n, d_in, l_dim, d_att)
    tail = (scores.data_ptr(), part.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    if partial:
        acc = torch.empty((1, l_dim), **f32)
        ml = torch.empty(2, **f32)
        err = lib.gated_pool_partial(
            *head, *[t.data_ptr() for t in w[:8]], *ptrs, *tail,
            acc.data_ptr(), ml.data_ptr(), stream)
        build.check(lib, "gated_pool_error_string", err,
                    "gated_attention_pool_partial")
        return acc, ml[0], ml[1], scores
    logits = torch.empty((1, w[8].shape[1]), **f32)
    err = lib.gated_pool_forward(
        *head, w[8].shape[1], *[t.data_ptr() for t in w], *ptrs, *tail,
        logits.data_ptr(), stream)
    build.check(lib, "gated_pool_error_string", err, "gated_attention_pool")
    return logits, scores


def gated_attention_pool(bag: torch.Tensor, p: GatedPoolParams,
                         n_valid: Optional[int] = None,
                         mask: Optional[torch.Tensor] = None,
                         tile: int = 2048, impl: str = "grid", nbuf: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled forward: (logits [1, C], raw scores [N]). bag [N, D_in];
    validity from ``mask`` [N] bool or a prefix length ``n_valid`` (both
    data, no rebuild). ``tile``, ``impl`` ("grid" or "dma") and ``nbuf``
    keep the JAX signature: the TPU's two launchers (block pipeline, DMA
    ring) are one CUDA launch here, which sizes its own tiles, so they
    select nothing. The kernel takes any D_in and D_att and L up to 768
    (its running sums live in shared memory); a wider head raises."""
    _check_impl(impl)
    n = bag.shape[0]
    if n == 0:
        raise ValueError("gated_attention_pool needs a non-empty bag")
    if mask is None and n_valid is None:
        n_valid = n
    if bag.device.type == "cpu":
        if mask is None:
            mask = torch.arange(n) < n_valid
        logits, scores = gated_attention_pool_reference(bag, mask, p)
        return logits[None, :], scores
    logits, scores = _launch(bag, p, n_valid, mask, partial=False)
    gated_attention_pool.launches += 1
    return logits, scores


gated_attention_pool.launches = 0  # kernel launches on CUDA


def gated_attention_pool_partial(
        bag: torch.Tensor, p: GatedPoolParams,
        mask: Optional[torch.Tensor] = None, tile: int = 2048,
        impl: str = "grid", nbuf: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard-local pooling partials for instance-sharded MIL
    (parallel/sharded_bag.py): (acc [1, L] un-normalised weighted sum of h
    at the local score max, m [] that max, l [] the local sum of weights,
    scores [N]); ``mask`` None means every row is valid. Combine shards
    with ``combine_partials``. ``tile``/``impl``/``nbuf`` as in
    ``gated_attention_pool``."""
    _check_impl(impl)
    n = bag.shape[0]
    if n == 0:
        raise ValueError("gated_attention_pool_partial needs a non-empty bag")
    if bag.device.type == "cpu":
        return gated_attention_pool_partial_reference(bag, mask, p)
    out = _launch(bag, p, n if mask is None else None, mask, partial=True)
    gated_attention_pool_partial.launches += 1
    return out


gated_attention_pool_partial.launches = 0  # kernel launches on CUDA


def pool_eligible(model) -> bool:
    """True for the heads the pool computes: a gated single-branch CLAM."""
    return (getattr(model, "multi_branch", True) is False
            and getattr(model, "gate", False) is True)


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

    if not pool_eligible(model):
        return model(bag, mask)
    logits, scores = gated_attention_pool(bag, params_from_clam(model),
                                          mask=mask)
    y_prob = torch.softmax(logits, dim=-1)
    y_hat = torch.argmax(logits, dim=-1)
    return MILOutput(logits, y_prob, y_hat, scores[None, :], {})
