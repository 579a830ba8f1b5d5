"""LongNet's dilated attention (Ding et al., arXiv 2307.02486) over one
slide's tokens, as Prov-GigaPath's slide encoder runs it (torchscale's
``DilatedAttention``), with a hand-written kernel for the card.

q, k, v are [N, H, d] (already projected). The schedule is a list of
branches (w, r). In each branch the tokens are zero-padded to a multiple
of w' = min(w, N) and cut into segments of w'; each segment is zero-padded
to a multiple of r, and head group j (heads j H/r .. (j+1) H/r - 1) takes
the positions p of the segment with p = j (mod r), counted from the
segment's start. Dense softmax attention runs among those positions at
scale d^-1/2 with no key mask: a zero-padded key takes part with logit 0
and value 0. Each selected (position, head) keeps its output o_b and its
log-sum-exp lse_b; a (position, head) that a branch does not select has
lse_b = -1e8, and so has an lse that is exactly 0 (torchscale's
``masked_fill_(lse == 0, -1e8)``). The branches merge per position and
head as sum_b softmax_b(lse_b) o_b; padded rows are dropped.

``dilated_attention(q, k, v, schedule)`` returns the merged [N, H d] in
q's dtype. A CPU tensor takes ``dilated_attention_reference``, the plain
version. A CUDA tensor (bf16, d 16, 32, 48 or 64, every r dividing H, at
most 8 branches) launches the two kernels of
kernels/csrc/dilated_attention.cu, and raises on anything else:
``dilated_attention_kernel`` (every branch's segment-local, head-group-
strided attention in one grid on mma.sync, an f32 online softmax, the pad
keys past the bag's last token added analytically, o_b and lse_b into a
compact f32 buffer) and ``dilated_merge_kernel`` (the branches' lse
softmax and weighted sum, once in bf16). The source is built by nvcc at
the path's first call (kernels/build.py), so nothing of it is built
before a LongNet forward runs.

There is no TPU kernel for this: the JAX package has no slide-level
transformer. Bound on this card: the tensor cores (4 d operations per
(query, key) pair of tokens, ``branch_pairs``: ~4 x 10^8 per layer at N
~ 3.3 x 10^4); the merge and the buffer are memory-bound and small beside
it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from hipt_abmil_atec23_tpu_torch.kernels import build

Schedule = Sequence[Tuple[int, int]]

UNSELECTED_LSE = -1e8
BLOCK_M = 128          # selected queries per CTA of the attention kernel
MAX_BRANCHES = 8       # branches one launch takes
HEAD_DIMS = (16, 32, 48, 64)
_CHUNK_BYTES = 256 << 20   # f32 score bytes one plain step may hold


# ------------------------------------------------------------ the schedule
def check_schedule(schedule: Schedule, heads: int,
                   n: int = 1) -> List[Tuple[int, int]]:
    """The schedule as a list of (w, r) ints; ValueError unless every w
    and r is positive, every r divides ``heads``, and r divides w wherever
    the ``n`` tokens take more than one segment (torchscale concatenates
    segments of ceil(w / r) r rows, which leaves a segment's rows off its
    tokens otherwise)."""
    out = [(int(w), int(r)) for w, r in schedule]
    if not out:
        raise ValueError("dilated_attention: an empty schedule")
    for w, r in out:
        if w < 1 or r < 1 or heads % r or (n > w and w % r):
            raise ValueError(
                f"dilated_attention: branch (w {w}, r {r}) with {heads} "
                f"heads at N {n}; w and r must be positive, r must divide "
                "H, and w too where N > w")
    return out


def branch_shape(n: int, w: int, r: int) -> Tuple[int, int, int]:
    """(w', segments, selected positions per segment and head group) of
    branch (w, r) over ``n`` tokens: w' = min(w, n), ceil(n / w')
    segments, ceil(w' / r) positions each, padding included."""
    wp = min(w, n)
    return wp, -(-n // wp), -(-wp // r)


def branch_pairs(n: int, w: int, r: int, heads: int) -> int:
    """(query, key) pairs of tokens of branch (w, r) over ``n`` tokens,
    summed over segments and heads: head group j of a segment of lim
    tokens holds ceil((lim - j) / r) of them. Zero-padded keys are left
    out: each adds exp(0 - m) to a denominator and needs no product."""
    wp, segs, _ = branch_shape(n, w, r)
    hg, total = heads // r, 0
    for lim, count in ((wp, n // wp), (n % wp, 1)):
        if lim and count:
            total += count * hg * sum((-(-(lim - j) // r)) ** 2
                                      for j in range(min(r, lim)))
    return total


def branch_index(n: int, w: int, r: int, heads: int, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [S, H, L], real [S, H, L]) of branch (w, r): the token row of
    each selected position per segment and head, and whether it is a token
    (False for a zero pad of the segment or of the bag; its row then
    holds 0)."""
    wp, segs, length = branch_shape(n, w, r)
    group = (torch.arange(heads, device=device) // (heads // r))
    t = torch.arange(length, device=device)
    in_seg = group[:, None] + r * t[None, :]                    # [H, L]
    rows = torch.arange(segs, device=device)[:, None, None] * wp + in_seg
    real = (in_seg < wp) & (rows < n)
    return torch.where(real, rows, 0), real


# ------------------------------------------------------- the plain version
def _branch_plain(q, k, v, w: int, r: int):
    """One branch on any device: (o [N, H, d] f32, lse [N, H] f32), o 0
    and lse -1e8 where the branch does not select the (row, head). The
    kernel's arithmetic: f32 scores of the storage-dtype operands, an f32
    softmax, the unnormalised p rounded to v's dtype for P . V."""
    n, heads, d = q.shape
    rows, real = branch_index(n, w, r, heads, q.device)
    s_, h_, length = rows.shape
    hh = torch.arange(heads, device=q.device)[None, :, None]

    def gather(x):
        g = x[rows, hh.expand_as(rows)].float()            # [S, H, L, d]
        return torch.where(real[..., None], g, 0.0)

    qs, ks, vs = gather(q), gather(k), gather(v)
    qs, ks = qs.flatten(0, 1), ks.flatten(0, 1)
    vs = vs.flatten(0, 1)
    o = torch.empty(s_ * h_, length, d, device=q.device)
    lse = torch.empty(s_ * h_, length, device=q.device)
    step = max(1, _CHUNK_BYTES // (4 * s_ * h_ * length))
    for i in range(0, length, step):
        s = (qs[:, i:i + step] @ ks.transpose(1, 2)) * d ** -0.5
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        den = e.sum(-1, keepdim=True)
        o[:, i:i + step] = (e.to(v.dtype).float() @ vs) / den
        lse[:, i:i + step] = (m + torch.log(den))[..., 0]
    o_full = torch.zeros(n, heads, d, device=q.device)
    lse_full = torch.full((n, heads), UNSELECTED_LSE, device=q.device)
    keep = real.flatten()
    r_idx = rows.flatten()[keep]
    h_idx = hh.expand_as(rows).flatten()[keep]
    o_full[r_idx, h_idx] = o.view(-1, d)[keep]
    lse_full[r_idx, h_idx] = lse.view(-1)[keep]
    return o_full, lse_full


def merge_branches(outs: List[torch.Tensor],
                   lses: List[torch.Tensor]) -> torch.Tensor:
    """sum_b softmax_b(lse_b) o_b per (row, head), in f32; an lse of
    exactly 0 counts as unselected, as torchscale's merge reads it."""
    lse = torch.stack(lses)                                     # [B, N, H]
    lse = torch.where(lse == 0, UNSELECTED_LSE, lse)
    wgt = torch.softmax(lse, 0)
    return (torch.stack(outs) * wgt[..., None]).sum(0)


def dilated_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, schedule: Schedule
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernels on any device: q, k, v [N, H,
    d] -> [N, H d] in q's dtype."""
    n, heads, d = q.shape
    outs, lses = [], []
    for w, r in check_schedule(schedule, heads, n):
        o, lse = _branch_plain(q, k, v, w, r)
        outs.append(o)
        lses.append(lse)
    return merge_branches(outs, lses).reshape(n, heads * d).to(q.dtype)


# --------------------------------------------------------------- the card
def _lib() -> ctypes.CDLL:
    lib = build.load("dilated_attention")
    if not getattr(lib, "_hk_bound", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dilated_attention_launch.argtypes = [vp] * 6 + [i, i, i] + [
            ll] * 3 + [ctypes.POINTER(i), i, i, i, ctypes.c_float, vp]
        lib.dilated_attention_launch.restype = i
        lib.dilated_attention_error_string.argtypes = [i]
        lib.dilated_attention_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def kernel_plan(n: int, schedule: Schedule, heads: int,
                block_m: int) -> Tuple[List[List[int]], int, int]:
    """(descriptor rows, programs, compact columns) of one launch: per
    branch [w', r, L, segments, query blocks, first program, heads per
    group, first column], the heaviest branch's programs (most keys per
    program) first, so the grid's tail holds the short ones."""
    rows, col = [], 0
    for w, r in schedule:
        wp, segs, length = branch_shape(n, w, r)
        rows.append([wp, r, length, segs, -(-length // block_m), 0,
                     heads // r, col])
        col += heads // r
    first = 0
    for row in sorted(rows, key=lambda x: -x[2]):
        row[5] = first
        first += row[3] * heads * row[4]
    return sorted(rows, key=lambda x: x[5]), first, col


@functools.lru_cache(maxsize=256)
def _plan_rows(n: int, schedule: Tuple[Tuple[int, int], ...], heads: int):
    """kernel_plan as the launcher's host int array, kept for the last 256
    shapes: (rows, programs, compact columns)."""
    rows, programs, cols = kernel_plan(n, schedule, heads, BLOCK_M)
    flat = [x for row in rows for x in row]
    return (ctypes.c_int * len(flat))(*flat), programs, cols


def _launch(q, k, v, schedule) -> torch.Tensor:
    n, heads, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.stride(2) != 1 \
                or t.stride(1) != d or t.stride(0) % 8 \
                or t.data_ptr() % 16:
            raise ValueError(
                f"dilated_attention: {name} must be bf16 [N, H, d] with "
                "its heads dense, rows a multiple of 8 elements apart and "
                f"16-byte aligned, got {t.dtype} strides {t.stride()}")
    if d not in HEAD_DIMS:
        raise ValueError(f"dilated_attention: head size {d}; the kernel "
                         f"takes {HEAD_DIMS}")
    if len(schedule) > MAX_BRANCHES:
        raise ValueError(f"dilated_attention: {len(schedule)} branches; the "
                         f"kernel takes at most {MAX_BRANCHES}")
    rows, programs, cols = _plan_rows(n, tuple(schedule), heads)
    o = torch.empty(n, cols, d, device=q.device, dtype=torch.float32)
    lse = torch.empty(n, cols, device=q.device, dtype=torch.float32)
    out = torch.empty(n, heads * d, device=q.device, dtype=q.dtype)
    lib = _lib()
    err = lib.dilated_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), out.data_ptr(), n, heads, d, q.stride(0),
        k.stride(0), v.stride(0), rows, len(schedule), programs, cols,
        d ** -0.5 * math.log2(math.e),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "dilated_attention_error_string", err,
                "dilated_attention")
    dilated_attention.launches += 2
    return out


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      schedule: Schedule) -> torch.Tensor:
    """The merged dilated attention of one slide: q, k, v [N, H, d] ->
    [N, H d] in q's dtype. CUDA tensors launch the kernels (``calls``
    counts the wrapper's runs on the card, ``launches`` the device
    launches, two per call); CPU tensors run the plain version; anything
    else raises."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape \
            or q.shape[0] < 1:
        raise ValueError(f"dilated_attention: q, k, v must be one [N, H, "
                         f"d] shape with N >= 1, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError("dilated_attention: q, k, v on different devices")
    schedule = check_schedule(schedule, q.shape[1], q.shape[0])
    if q.device.type == "cpu":
        return dilated_attention_reference(q, k, v, schedule)
    if q.device.type != "cuda":
        raise ValueError(f"dilated_attention: no kernel for {q.device}")
    out = _launch(q, k, v, schedule)
    dilated_attention.calls += 1
    return out


dilated_attention.calls = 0      # wrapper runs on the card
dilated_attention.launches = 0   # device launches (two per call)
