"""Every block of a pre-norm ViT stack in one hand-written CUDA launch
(kernels/csrc/fused_network.cu), with its plain PyTorch version beside it.

Counterpart of hipt_abmil_atec23_tpu/ops/fused_network.py (the TPU kernel
``_network_kernel``, launcher ``fused_vit_network``), with its signature:
the weights arrive stacked on a leading depth axis in the JAX layout
(``ORDER``: [T, D] vectors, Wqkv [T, D, 3D], Wproj [T, D, D], W1 [T, D, H],
W2 [T, H, D]), x is [B, n_pad, D] in bf16 or f32, and the output has x's
dtype. Each block is ops/fused_block.py's arithmetic with bf16 GEMM
operands; the residual stays f32 across all T blocks and rounds once,
after the last.

    from hipt_abmil_atec23_tpu_torch.ops.fused_network import (
        fused_vit_network, stack_blocks)
    ws = stack_blocks(model.vit256.blocks)      # 12 stacked tensors
    out = fused_vit_network(tokens, *ws, num_heads=6, n_valid=257)

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (one
cooperative launch for all T blocks), a CPU tensor runs
``fused_vit_network_reference``. ``group`` and ``unroll`` are the TPU
kernel's (images per grid step, a static block loop) and change nothing
here. Nothing falls back: a contract the kernel does not take raises
ValueError, a build or launch failure RuntimeError.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    _SMEM_LIMIT, block_f32, block_params)

ORDER = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wproj", "bproj",
         "ln2_g", "ln2_b", "w1", "b1", "w2", "b2")


def _check_contract(x: torch.Tensor, num_heads: int, group: int) -> None:
    """The JAX launcher's assertions, as ValueError."""
    b, n_pad, d = x.shape
    if n_pad % 8 or b % group or d % num_heads:
        raise ValueError(
            f"fused_vit_network needs n_pad % 8 == 0, B % group == 0 and "
            f"D % num_heads == 0; got B={b}, n_pad={n_pad}, D={d}, "
            f"group={group}, num_heads={num_heads}")


def fused_vit_network_reference(x: torch.Tensor, *weights: torch.Tensor,
                                num_heads: int,
                                n_valid: Optional[int] = None,
                                eps: float = 1e-6, group: int = 2,
                                unroll: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per block ops/fused_block.py's
    arithmetic with bf16 operands on an f32 residual, rounded to x's dtype
    once, after block T. ``weights`` in ``ORDER``, JAX layout."""
    n_valid = x.shape[1] if n_valid is None else n_valid
    xf = x.float()
    for t in range(weights[0].shape[0]):
        # JAX [in, out] -> torch [out, in], the layout block_f32 takes
        prm = [w[t].t().contiguous() if w.dim() == 3 else w[t]
               for w in weights]
        xf = block_f32(xf, prm, num_heads=num_heads, n_valid=n_valid,
                       eps=eps, cdt=torch.bfloat16)
    return xf.to(x.dtype)


def stack_blocks(blocks: Sequence) -> Tuple[torch.Tensor, ...]:
    """The stacked weights of ``blocks`` (models.vit.Block, depth order) in
    ``ORDER`` and the JAX layout, f32 on the blocks' device. Made once and
    kept on the first block until a parameter changes (a load_state_dict
    bumps its version) or moves."""
    blocks = list(blocks)
    prms = [block_params(blk) for blk in blocks]
    stamp = (tuple(id(blk) for blk in blocks),
             tuple((p._version, p.data_ptr(), p.device)
                   for ps in prms for p in ps))
    hit = getattr(blocks[0], "_stacked_blocks", None)
    if hit is None or hit[0] != stamp:
        # outside inference mode, so the stack keeps a version counter
        with torch.inference_mode(False), torch.no_grad():
            stacked = tuple(
                torch.stack([(ps[i].t() if ps[i].dim() == 2 else ps[i])
                             .detach() for ps in prms])
                for i in range(len(ORDER)))
        hit = blocks[0]._stacked_blocks = (stamp, stacked)
    return hit[1]


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_network")
    if not getattr(lib, "_hk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_network_forward.argtypes = (
            [p] * 22 + [i] * 8 + [ctypes.c_float, ctypes.c_float, i, p])
        lib.fused_network_forward.restype = i
        lib.fused_network_smem.argtypes = [i, i]
        lib.fused_network_smem.restype = ctypes.c_size_t
        lib.fused_network_clock_len.argtypes = [i]
        lib.fused_network_clock_len.restype = i
        lib.fused_network_counters_len.argtypes = [i]
        lib.fused_network_counters_len.restype = i
        lib.fused_network_error_string.argtypes = [i]
        lib.fused_network_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _kernel_weights(weights: Sequence[torch.Tensor],
                    dev: torch.device) -> list:
    """The stacked weights as the kernel takes them on ``dev``: GEMM
    weights bf16 in torch [T, out, in] layout, vectors f32. Made once per
    version of the inputs and kept on the first; inference tensors carry
    no version counter, so for them the copies are made on every call."""
    cacheable = not any(w.is_inference() for w in weights)
    stamp = (dev, tuple((w._version, w.data_ptr()) for w in weights)) \
        if cacheable else None
    hit = getattr(weights[0], "_hk_network", None)
    if stamp is not None and hit is not None and hit[0] == stamp:
        return hit[1]
    wts = [w.detach().to(dev).transpose(1, 2).to(torch.bfloat16)
           .contiguous() if w.dim() == 3 else
           w.detach().to(dev, torch.float32).contiguous() for w in weights]
    if stamp is not None:
        weights[0]._hk_network = (stamp, wts)
    return wts


def _check_kernel_shapes(x, weights, num_heads, n_valid) -> int:
    """Raise ValueError on what the kernel does not take; returns the MLP
    hidden width."""
    b, n_pad, d = x.shape
    depth, hidden = weights[0].shape[0], weights[8].shape[-1]
    want = [(depth, d), (depth, d), (depth, d, 3 * d), (depth, 3 * d),
            (depth, d, d), (depth, d), (depth, d), (depth, d),
            (depth, d, hidden), (depth, hidden), (depth, hidden, d),
            (depth, d)]
    got = [tuple(w.shape) for w in weights]
    if len(weights) != len(ORDER) or got != want:
        raise ValueError(f"fused_vit_network weights {got} do not stack "
                         f"{ORDER} for D={d}")
    hd = d // num_heads
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_vit_network kernel takes a bf16 or f32 "
                         f"residual stream, got {x.dtype}")
    if (depth < 1 or hd not in (32, 64) or d % 32 or d > 384 or hidden % 32
            or not 0 < n_valid <= n_pad):
        raise ValueError(
            f"fused_vit_network kernel does not take T={depth}, "
            f"n_pad={n_pad}, D={d}, heads={num_heads}, hidden={hidden}, "
            f"n_valid={n_valid} (needs T >= 1, head size 32 or 64, D <= 384 "
            "and a multiple of 32)")
    return hidden


def clock_len(depth: int) -> int:
    """Timestamps one clocked launch of a ``depth``-block stack writes: the
    start, then the arrival at and the departure from each grid barrier
    (seven per block: after LN1, QKV, attention, PROJ, LN2, FC1 and FC2;
    CTA 0's %globaltimer, ns)."""
    return _lib().fused_network_clock_len(depth)


def _launch(x, weights, *, num_heads, n_valid, eps, grid=0,
            clock: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cooperative launch of the kernel over all T blocks; ``grid``
    CTAs, or all that are co-resident. ``clock``: None, or an int64 CUDA
    tensor of ``clock_len(T)`` that the stage timer fills (only a
    measurement passes one)."""
    b, n_pad, d = x.shape
    hidden = _check_kernel_shapes(x, weights, num_heads, n_valid)
    hd = d // num_heads
    lib = _lib()
    smem = lib.fused_network_smem(n_pad, hd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{n_pad} tokens need {smem} B of shared memory "
                         f"per block (limit {_SMEM_LIMIT})")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    x = x.contiguous()
    m = b * n_pad
    wts = _kernel_weights(weights, dev)
    scratch = [torch.empty((m, d), device=dev, dtype=f32),           # xres
               torch.empty((m, d), device=dev, dtype=bf16),          # xn
               torch.empty((3, b, num_heads, n_pad, hd), device=dev,
                           dtype=bf16),                              # qkv
               torch.empty((m, d), device=dev, dtype=bf16),          # attn
               torch.empty((m, d), device=dev, dtype=f32),           # x2
               torch.empty((m, hidden), device=dev, dtype=bf16)]     # h
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    depth = weights[0].shape[0]
    if clock is not None and (clock.dtype != torch.int64 or clock.device != dev
                              or clock.numel() != clock_len(depth)):
        raise ValueError(f"clock must be {clock_len(depth)} int64 on {dev}")
    counters = torch.empty(lib.fused_network_counters_len(depth),
                           device=dev, dtype=torch.int32)
    ptrs = [t.data_ptr() for t in [x, *wts, *scratch, out, counters]]
    ptrs.append(None if clock is None else clock.data_ptr())
    err = lib.fused_network_forward(
        *ptrs, depth, b, n_pad, d, num_heads, n_valid, hidden,
        int(x.dtype == f32), eps, hd ** -0.5, grid, stream)
    build.check(lib, "fused_network_error_string", err, "fused_vit_network")
    return out


def fused_vit_network(x: torch.Tensor, *weights: torch.Tensor,
                      num_heads: int, n_valid: Optional[int] = None,
                      eps: float = 1e-6, group: int = 2,
                      unroll: bool = False) -> torch.Tensor:
    """All T pre-norm blocks: one CUDA launch on a CUDA tensor, the plain
    version on a CPU tensor. x: [B, n_pad, D] (padded once by the caller;
    keys past n_valid are masked); ``weights`` in ``ORDER``, stacked on a
    leading depth axis in the JAX layout."""
    _check_contract(x, num_heads, group)
    if x.device.type == "cpu":
        return fused_vit_network_reference(
            x, *weights, num_heads=num_heads, n_valid=n_valid, eps=eps)
    n_valid = x.shape[1] if n_valid is None else n_valid
    out = _launch(x, weights, num_heads=num_heads, n_valid=n_valid, eps=eps)
    fused_vit_network.launches += 1
    return out


fused_vit_network.launches = 0  # kernel launches (one per call on CUDA)
