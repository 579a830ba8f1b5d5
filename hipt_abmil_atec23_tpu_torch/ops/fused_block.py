"""One pre-norm ViT block as hand-written CUDA kernels (kernels/csrc/
fused_block.cu), with its plain PyTorch version beside it.

Counterpart of hipt_abmil_atec23_tpu/ops/fused_block.py (the TPU kernel
``_block_kernel``): LN1 -> one [rows, D] x [D, 3D] QKV product -> per-head
softmax(q k^T hd^-1/2) v with padded keys at -1e30 -> proj + bias +
residual -> LN2 -> fc1 -> exact-erf GELU -> fc2 + residual. bf16 operands,
f32 accumulation, f32 LayerNorm and softmax statistics, and the same
rounding points: q is scaled in f32 before its bf16 cast, the attention
probabilities and head outputs round to bf16, x2 = x + attn stays f32, the
MLP hidden rounds to bf16, the output to the residual dtype.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (bf16
or f32 residual stream, D <= 384 and a multiple of 32, head size 32 or 64),
a CPU tensor runs ``fused_vit_block_reference``. Nothing else falls back: a
build or launch failure raises.

An f32 residual on the card keeps bf16 GEMM operands, as the TPU kernel
does; on the CPU it runs the exact f32 block, as the JAX package's CPU path
does (ROADMAP.md section C).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.kernels import build

NEG_INF = -1e30
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def block_params(blk) -> list:
    """A models.vit.Block's parameters in the kernels' order (torch
    layouts): ln1 g, b; qkv W [3D, D], b; proj W, b; ln2 g, b; fc1 W
    [H, D], b; fc2 W [D, H], b."""
    return [blk.norm1.weight, blk.norm1.bias,
            blk.attn.qkv.weight, blk.attn.qkv.bias,
            blk.attn.proj.weight, blk.attn.proj.bias,
            blk.norm2.weight, blk.norm2.bias,
            blk.mlp.fc1.weight, blk.mlp.fc1.bias,
            blk.mlp.fc2.weight, blk.mlp.fc2.bias]


def block_f32(xf: torch.Tensor, prm: Sequence[torch.Tensor], *,
              num_heads: int, n_valid: int, eps: float,
              cdt: torch.dtype) -> torch.Tensor:
    """One block on an f32 residual ``xf`` [B, n_pad, D] with the
    parameters of ``block_params``; GEMM operands round to ``cdt`` and
    multiply in f32. Returns the f32 residual after the block."""
    ln1_g, ln1_b, wqkv, bqkv, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2 = prm
    b, n_pad, d = xf.shape
    hd = d // num_heads

    def mm(a, w, bias):  # a [..., K] . W^T + b, W in torch Linear [out, in]
        return a.to(cdt).float() @ w.to(cdt).float().t() + bias.float()

    xn = _ln(xf, ln1_g, ln1_b, eps).to(cdt)
    qkv = mm(xn, wqkv, bqkv).view(b, n_pad, 3, num_heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)                    # [3, B, H, n, hd]
    q = (qkv[0] * hd ** -0.5).to(cdt).float()
    k = qkv[1].to(cdt).float()
    v = qkv[2].to(cdt).float()
    s = q @ k.transpose(-1, -2)                         # [B, H, n, n] f32
    if n_valid < n_pad:
        s[..., n_valid:] = NEG_INF
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(cdt).float()
    o = (p @ v).to(cdt).permute(0, 2, 1, 3).reshape(b, n_pad, d)
    x2 = xf + mm(o, wproj, bproj)
    xn2 = _ln(x2, ln2_g, ln2_b, eps).to(cdt)
    h1 = F.gelu(mm(xn2, w1, b1)).to(cdt)
    return x2 + mm(h1, w2, b2)


def fused_vit_block_reference(x: torch.Tensor, blk, *, num_heads: int,
                              n_valid: Optional[int] = None,
                              eps: float = 1e-6,
                              operand_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel on x's residual dtype: operands
    round to ``operand_dtype`` (default x's dtype) and multiply in f32,
    exactly where the kernel rounds; the output has x's dtype. bf16 x, or
    ``operand_dtype=torch.bfloat16`` with any x, is the kernel's
    arithmetic; f32 x by default the exact f32 block. x: [B, n_pad, D];
    blk: a models.vit.Block."""
    cdt = x.dtype if operand_dtype is None else operand_dtype
    n_valid = x.shape[1] if n_valid is None else n_valid
    return block_f32(x.float(), block_params(blk), num_heads=num_heads,
                     n_valid=n_valid, eps=eps, cdt=cdt).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_block")
    if not getattr(lib, "_hk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_block_forward.argtypes = (
            [p] * 19 + [i] * 7 + [ctypes.c_float, ctypes.c_float, p])
        lib.fused_block_forward.restype = i
        lib.fused_block_attention_smem.argtypes = [i, i]
        lib.fused_block_attention_smem.restype = ctypes.c_size_t
        lib.fused_block_error_string.argtypes = [i]
        lib.fused_block_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _kernel_weights(blk, dev: torch.device) -> list:
    """The block's parameters as the kernel takes them (bf16 GEMM weights,
    f32 LayerNorm parameters and biases, on ``dev``), cast once and kept on
    the block until a parameter changes (a load_state_dict bumps its
    version) or moves."""
    prms = block_params(blk)
    stamp = (dev, tuple((t._version, t.data_ptr()) for t in prms))
    hit = getattr(blk, "_kernel_weights", None)
    if hit is None or hit[0] != stamp:
        wts = [t.detach().to(dev, torch.bfloat16 if t.dim() == 2
                             else torch.float32).contiguous() for t in prms]
        hit = blk._kernel_weights = (stamp, wts)
    return hit[1]


def fused_vit_block(x: torch.Tensor, blk, *, num_heads: int,
                    n_valid: Optional[int] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """Whole block: the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. x: [B, n_pad, D], bf16 or f32 (the output's dtype), with
    n_pad % 8 == 0 (pad once per network and pass n_valid, so padded keys
    are masked)."""
    if x.device.type == "cpu":
        return fused_vit_block_reference(x, blk, num_heads=num_heads,
                                         n_valid=n_valid, eps=eps)
    b, n_pad, d = x.shape
    hd = d // num_heads
    hidden = blk.mlp.fc1.weight.shape[0]
    n_valid = n_pad if n_valid is None else n_valid
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_vit_block kernel takes a bf16 or f32 "
                         f"residual stream, got {x.dtype}")
    if (d % num_heads or hd not in (32, 64) or d % 32 or d > 384
            or hidden % 32 or n_pad % 8 or not 0 < n_valid <= n_pad
            or b > 65535):
        raise ValueError(
            f"fused_vit_block kernel does not take B={b}, n_pad={n_pad}, "
            f"D={d}, heads={num_heads}, hidden={hidden}, n_valid={n_valid} "
            "(needs head size 32 or 64, D <= 384 and a multiple of 32, "
            "n_pad % 8 == 0)")
    lib = _lib()
    smem = lib.fused_block_attention_smem(n_pad, hd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{n_pad} tokens need {smem} B of shared memory "
                         f"per attention block (limit {_SMEM_LIMIT})")
    dev = x.device
    bf16 = torch.bfloat16
    x = x.contiguous()
    m = b * n_pad
    wts = _kernel_weights(blk, dev)
    xn = torch.empty((m, d), device=dev, dtype=bf16)
    qkv = torch.empty((3, b, num_heads, n_pad, hd), device=dev, dtype=bf16)
    attn = torch.empty((m, d), device=dev, dtype=bf16)
    x2 = torch.empty((m, d), device=dev, dtype=torch.float32)
    hid = torch.empty((m, hidden), device=dev, dtype=bf16)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in [x, *wts, xn, qkv, attn, x2, hid, out]]
    err = lib.fused_block_forward(*ptrs, b, n_pad, d, num_heads, n_valid,
                                  hidden, int(x.dtype == torch.float32), eps,
                                  hd ** -0.5, stream)
    build.check(lib, "fused_block_error_string", err, "fused_vit_block")
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0  # kernel launches (one per block call on CUDA)
