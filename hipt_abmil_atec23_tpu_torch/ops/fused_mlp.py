"""Fused transformer MLP (optional LN -> fc1 -> exact GELU -> fc2 -> optional
residual) as one hand-written CUDA kernel (kernels/csrc/fused_mlp.cu), with
its plain PyTorch version beside it.

Counterpart of hipt_abmil_atec23_tpu/ops/fused_mlp.py (the TPU kernel
``_kernel``): f32 math on the loaded rows, weights in their stored dtype,
the [rows, H] hidden never in device memory, output in x's dtype. Weights
take the JAX layout: ``w1`` [D, H], ``w2`` [H, D].

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (bf16
rows and weights, D <= 384 and a multiple of 32, H a multiple of 64), a CPU
tensor runs ``fused_mlp_reference``. Nothing else falls back: a build or
launch failure raises, and so does any input the kernel does not take.

The kernel reads both weights K-major (W1^T [H, D], W2^T [D, H], torch
Linear's layout), as wgmma reads its operands. ``_k_major`` makes that copy
of a JAX-layout weight once and keeps it on the weight until the weight
changes; ``mlp_weights`` makes both layouts together.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.kernels import build


def fused_mlp_reference(x: torch.Tensor, gamma: Optional[torch.Tensor],
                        beta: Optional[torch.Tensor], w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        *, with_ln: bool, residual: bool,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the kernel: x upcast to f32 after the load, LN in
    f32, both products in f32 on the stored weights, exact-erf GELU, the
    residual adds the (rounded) x, output in x.dtype."""
    xf = x.float()
    if with_ln:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xn = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    else:
        xn = xf
    h = F.gelu(xn @ w1.float() + b1.float())
    o = h @ w2.float() + b2.float()
    if residual:
        o = o + xf
    return o.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    if not getattr(lib, "_hk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_forward.argtypes = (
            [p] * 8 + [i] * 5 + [ctypes.c_float, p])
        lib.fused_mlp_forward.restype = i
        lib.fused_mlp_error_string.argtypes = [i]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _version(t: torch.Tensor):
    """t's in-place version, or None for an inference tensor (which keeps
    no version counter)."""
    return None if t.is_inference() else t._version


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """w.t() made contiguous: the K-major layout the kernel reads of a
    JAX-layout weight. Kept on ``w`` (``_hk_k_major``) until ``w`` changes
    in place; ``mlp_weights`` sets it on the weights it makes. An inference
    tensor from elsewhere has no version to check, so it is transposed on
    every call."""
    hit = getattr(w, "_hk_k_major", None)
    if hit is not None and hit[0] == _version(w):
        return hit[1]
    kt = w.t().contiguous()
    if not w.is_inference():
        w._hk_k_major = (w._version, kt)
    return kt


def _f32_vec(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if t.shape != (n,):
        raise ValueError(f"fused_mlp kernel: {what} must be [{n}], got "
                         f"{tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def _run(x, gamma, beta, w1, b1, w2, b2, *, with_ln, residual, eps):
    if x.device.type == "cpu":
        return fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2,
                                   with_ln=with_ln, residual=residual,
                                   eps=eps)
    d = x.shape[-1]
    h = w1.shape[-1]
    bf16 = torch.bfloat16
    if x.dtype != bf16 or w1.dtype != bf16 or w2.dtype != bf16:
        raise ValueError(f"fused_mlp kernel takes bf16 rows and weights, got "
                         f"x {x.dtype}, w1 {w1.dtype}, w2 {w2.dtype}")
    if (w1.shape != (d, h) or w2.shape != (h, d) or d % 32 or d > 384
            or h % 64 or not (w1.is_contiguous() and w2.is_contiguous())):
        raise ValueError(
            f"fused_mlp kernel does not take D={d}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} (needs D <= 384 and a multiple of 32, "
            "H a multiple of 64, contiguous w1 [D, H] and w2 [H, D])")
    rows = x.numel() // d
    xs = x.reshape(rows, d).contiguous()
    b1 = _f32_vec(b1, h, "b1")
    b2 = _f32_vec(b2, d, "b2")
    if with_ln:
        gamma = _f32_vec(gamma, d, "gamma")
        beta = _f32_vec(beta, d, "beta")
    out = torch.empty_like(xs)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ln = [gamma.data_ptr(), beta.data_ptr()] if with_ln else [None, None]
    err = lib.fused_mlp_forward(
        xs.data_ptr(), *ln, _k_major(w1).data_ptr(), b1.data_ptr(),
        _k_major(w2).data_ptr(), b2.data_ptr(), out.data_ptr(), rows, d, h,
        int(with_ln), int(residual), eps, stream)
    build.check(lib, "fused_mlp_error_string", err, "fused_mlp")
    fused_mlp.launches += 1
    return out.reshape(x.shape)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [..., D]; w1 [D, H], w2 [H, D] -> gelu(x @ w1 + b1) @ w2 + b2 in
    x.dtype, the hidden never in device memory on the card."""
    return _run(x, None, None, w1, b1, w2, b2, with_ln=False,
                residual=False, eps=0.0)


def fused_ln_mlp_residual(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, eps: float = 1e-6
                          ) -> torch.Tensor:
    """The block's second half in one kernel: x + MLP(LayerNorm(x)), in
    x.dtype."""
    return _run(x, gamma, beta, w1, b1, w2, b2, with_ln=True, residual=True,
                eps=eps)


fused_mlp.launches = 0  # kernel launches, in either mode (one per call)


def mlp_weights(mlp, dtype: torch.dtype, dev: torch.device) -> list:
    """A models.vit.Mlp's parameters as the kernel takes them: w1 [D, H]
    and w2 [H, D] in ``dtype`` (the JAX layout), f32 biases, on ``dev``,
    each weight carrying its K-major copy for ``_k_major``. Made once and
    kept on the module until a parameter changes (a load_state_dict bumps
    its version) or moves."""
    prms = [mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias]
    stamp = (dtype, dev, tuple((t._version, t.data_ptr()) for t in prms))
    hit = getattr(mlp, "_kernel_weights", None)
    if hit is None or hit[0] != stamp:
        w1, b1, w2, b2 = (t.detach().to(dev) for t in prms)
        wts = [w1.t().to(dtype).contiguous(), b1.float(),
               w2.t().to(dtype).contiguous(), b2.float()]
        for w, kt in ((wts[0], w1), (wts[2], w2)):
            w._hk_k_major = (_version(w), kt.to(dtype).contiguous())
        hit = mlp._kernel_weights = (stamp, wts)
    return hit[1]
