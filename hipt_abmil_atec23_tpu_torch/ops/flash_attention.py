"""Attention softmax(q k^T d^-1/2) v over [BH, N, d] as hand-written CUDA
kernels (kernels/csrc/flash_attention.cu), with their plain PyTorch
versions beside them.

Counterpart of hipt_abmil_atec23_tpu/ops/flash_attention.py:

- ``fused_attention`` (TPU ``_fused_attn_kernel``): scores in f32 from the
  storage-dtype operands, scaled after the product, keys >= n_valid at
  -1e30, full-row f32 softmax, p normalised and rounded to v's dtype, f32
  P . V, output in q's dtype. ``group`` and ``block_q`` shape only the TPU
  grid; the card runs every shape through one two-pass kernel, with each
  head's K and V resident in shared memory up to RESIDENT_KEYS valid keys
  and streamed in 64-key chunks past them.
- ``flash_attention`` (TPU ``_flash_kernel``): the online-softmax
  recurrence in f32 with p not normalised before P . V and a final
  division by max(l, 1e-30); the card kernel walks the keys in tiles of
  FLASH_KEY_TILE.
- ``attention``: the JAX dispatcher's three branches at the same
  boundaries, so a shape takes the counterpart of the same TPU kernel.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel (bf16
q, k, v, head size 32 or 64, 0 < valid_len <= N), a CPU tensor runs the
plain version. Nothing else falls back: a build or launch failure raises,
and so does any input the kernel does not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build

NEG_INF = -1e30
_SHORT_N = 1024            # the JAX dispatcher's short-branch limit
# The card kernels' tiling (kernels/csrc/flash_attention.cu), for tests that
# sit at its edges: the flash kernel's keys per tile, and the most valid
# keys (n_valid rounded up to 16) whose K and V the two-pass kernel holds in
# two shared-memory stages, by head size.
FLASH_KEY_TILE = 128
RESIDENT_KEYS = {64: 400, 32: 848}
_CHUNK_BYTES = 256 << 20   # f32 score bytes one plain step may hold


def _q_chunk(bh: int, n_keys: int) -> int:
    """Query rows per plain step, so a [bh, rows, n_keys] f32 block stays
    under _CHUNK_BYTES."""
    return max(1, _CHUNK_BYTES // (4 * bh * n_keys))


def _masked_scores(q, k, n_valid: int) -> torch.Tensor:
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if n_valid < k.shape[1]:
        s[..., n_valid:] = NEG_INF
    return s


def attention_reference(q, k, v, valid_len: Optional[int] = None):
    """Naive oracle (the JAX package's ``attention_reference``): f32
    softmax, p unrounded, output in q's dtype."""
    n_valid = k.shape[1] if valid_len is None else valid_len
    p = torch.softmax(_masked_scores(q, k, n_valid), dim=-1)
    return (p @ v.float()).to(q.dtype)


def fused_attention_reference(q, k, v, valid_len: Optional[int] = None,
                              group: int = 8,
                              block_q: Optional[int] = None) -> torch.Tensor:
    """Plain version of the single-pass kernel, with its rounding points:
    p = e / sum(e) rounded to v's dtype before the f32 P . V. Queries go
    in chunks so long N does not hold [N, N] scores at once."""
    bh, n, _ = q.shape
    n_valid = n if valid_len is None else valid_len
    out = torch.empty_like(q)
    step = _q_chunk(bh, n)
    for i in range(0, n, step):
        s = _masked_scores(q[:, i:i + step], k, n_valid)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).to(v.dtype).float()
        out[:, i:i + step] = (p @ v.float()).to(q.dtype)
    return out


def flash_attention_reference(q, k, v, valid_len: Optional[int] = None,
                              block_q: int = 128,
                              block_k: int = 256) -> torch.Tensor:
    """Plain version of the online-softmax kernel: the TPU kernel's
    recurrence over ``block_k`` keys, all f32."""
    bh, n, _ = q.shape
    n_valid = n if valid_len is None else valid_len
    out = torch.empty_like(q)
    step = _q_chunk(bh, block_k)
    vf = v.float()
    for i in range(0, n, step):
        qc = q[:, i:i + step]
        m = torch.full(qc.shape[:2] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, device=q.device)
        for j in range(0, n, block_k):
            s = _masked_scores(qc, k[:, j:j + block_k], max(0, n_valid - j))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, j:j + block_k]
            m = m_new
        out[:, i:i + step] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_hk_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attention_forward.argtypes = (
            [p] * 4 + [i] * 4 + [ctypes.c_float, i, p])
        lib.attention_forward.restype = i
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _launch(q, k, v, valid_len, flash: bool, what: str) -> torch.Tensor:
    bh, n, d = q.shape
    n_valid = n if valid_len is None else valid_len
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"{what} kernel takes bf16 q, k, v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if (k.shape != q.shape or v.shape != q.shape or d not in (32, 64)
            or not 0 < n_valid <= n):
        raise ValueError(
            f"{what} kernel does not take q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, valid_len {n_valid} "
            "(needs equal [BH, N, d] shapes, d 32 or 64, 0 < valid_len <= N)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), bh, n, d, n_valid,
                                d ** -0.5, int(flash), stream)
    build.check(lib, "attention_error_string", err, what)
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[int] = None, group: int = 8,
                    block_q: Optional[int] = None) -> torch.Tensor:
    """q, k, v [BH, N, d] -> [BH, N, d] in q's dtype: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, valid_len, group, block_q)
    out = _launch(q, k, v, valid_len, False, "fused_attention")
    fused_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[int] = None, block_q: int = 128,
                    block_k: int = 256) -> torch.Tensor:
    """Tiled online-softmax attention, q, k, v [BH, N, d] -> [BH, N, d]:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, valid_len, block_q,
                                         block_k)
    out = _launch(q, k, v, valid_len, True, "flash_attention")
    flash_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches (one per call on CUDA)
flash_attention.launches = 0


def attention_branch(n: int, d: int, itemsize: int) -> str:
    """The JAX dispatcher's choice at this shape: "fused" for the grouped
    or query-tiled single-pass kernel, "flash" for the online-softmax
    kernel."""
    if n <= _SHORT_N or 2 * n * d * itemsize <= 12 * 1024 * 1024:
        return "fused"
    return "flash"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid_len: Optional[int] = None, *,
              plain: bool = False) -> torch.Tensor:
    """Dispatch by sequence length as the JAX package does: short N to the
    grouped single-pass kernel, medium N (K/V within 12 MiB) to the
    query-tiled one, long N to flash. ``plain`` runs the chosen kernel's
    plain version on any device (for holding the kernels against it)."""
    if attention_branch(q.shape[1], q.shape[2], q.element_size()) == "fused":
        fn = fused_attention_reference if plain else fused_attention
    else:
        fn = flash_attention_reference if plain else flash_attention
    return fn(q, k, v, valid_len)
