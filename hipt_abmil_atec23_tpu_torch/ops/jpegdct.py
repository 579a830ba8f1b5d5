"""On-device JPEG decode from sparse quantized DCT coefficients.

Counterpart of hipt_abmil_atec23_tpu/ops/jpegdct.py. The host ships the
JPEG codec's own quantized coefficients in the sparse pack v3 (format in the
JAX module's docstring and in slideio/reader.DctRegions) instead of decoded
pixels; the card runs

    unpack (kernels/csrc/dct_unpack.cu) -> DC chain and explicit escape
    scatters -> dequantized 8x8 IDCT -> crop -> white mask -> planes

and ops/yuv.py rebuilds RGB from the planes.

The stream expansion (bitmap prefix bytes -> bits -> nibble values ->
escape bytes at the -8 sentinels -> x quant table) is the CUDA kernel on a
CUDA tensor and ``dct_unpack_reference`` on a CPU tensor: ranks from a
``cumsum`` of the marks, then a gather from the stream. The JAX package's
factorized one-hot expansion (``_expand`` / ``_kexpand``) works around the
TPU's matrix unit and Mosaic's layout rules and has no counterpart here.
The DC chain, the ``|v| > 127`` escapes and the DC-delta escapes stay plain
torch on both devices, as they stay XLA in the JAX package.

Numerics: the f32 IDCT sums in another order than the JAX package's einsum,
so planes agree with it within 1 LSB; the unpacked coefficients are
integers times the table and agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.kernels import build
from hipt_abmil_atec23_tpu_torch.ops.yuv import yuv420_to_rgb

# 8-point IDCT basis with the JPEG normalization: sample block
# s = M^T F M (+128 level shift), M[u, x] = c(u) cos((2x+1)u pi / 16).
_M8 = (np.cos((2 * np.arange(8)[None, :] + 1) * np.arange(8)[:, None]
              * np.pi / 16)
       * np.concatenate([[np.sqrt(1 / 8)], np.full(7, 0.5)])[:, None]
       ).astype(np.float32)

# Blocks per padded value group — mirrors the native packer's kDctGroup
# (ws_dct_group_size; a test holds the two together).
_G = 16


def _block_counts(bmc: torch.Tensor, bl: int, ng: int) -> torch.Tensor:
    """4-bit per-block bitmap byte counts [n, ceil(bl/2)] u8 -> [n, ng, G]
    int64; blocks past bl (the last group's padding) count 0."""
    n = bmc.shape[0]
    b = bmc.to(torch.int64)
    c = torch.stack([b & 0xF, b >> 4], -1).reshape(n, -1)[:, :bl]
    return torch.nn.functional.pad(c, (0, ng * _G - bl)).reshape(n, ng, _G)


def _place(stream: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """out[..., j] = stream[..., rank(j) - 1] at marked j, where rank is the
    inclusive count of marks up to j; 0 at unmarked j and where the rank
    runs past the stream."""
    cap = stream.shape[-1]
    if cap == 0:
        return torch.zeros(marks.shape, dtype=stream.dtype,
                           device=stream.device)
    slot = torch.cumsum(marks.to(torch.int64), -1) - 1
    got = torch.gather(stream, -1, slot.clamp(0, cap - 1))
    return torch.where(marks & (slot < cap), got, torch.zeros_like(got))


def dct_unpack_reference(bmc: torch.Tensor, bmb: torch.Tensor,
                         valn: torch.Tensor, esc8: torch.Tensor,
                         q: torch.Tensor, bl: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one component's pack streams
    for n regions -> dequantized AC coefficients [n, ng, G*64] f32, the DC
    column 0 (ng = ceil(bl / G) groups per region)."""
    n = bmc.shape[0]
    ng = -(-bl // _G)
    capbm = bmb.shape[-1] // ng
    capg = valn.shape[-1] * 2 // ng
    capge = esc8.shape[-1] // ng
    k8 = torch.arange(8, device=bmc.device)
    # bitmap bytes: block b's shipped byte i lands at position b*8 + i
    bmarks = (k8 < _block_counts(bmc, bl, ng)[..., None]).reshape(
        n, ng, _G * 8)
    bytes_ = _place(bmb.reshape(n, ng, capbm).to(torch.int64), bmarks)
    bits = ((bytes_[..., None] >> k8) & 1).reshape(n, ng, _G * 64) > 0
    # nibbles in bitmap order, sign-extended; -8 marks an escape byte
    v = valn.to(torch.int64)
    nib = torch.stack([v & 0xF, v >> 4], -1).reshape(n, ng, capg)
    nib = torch.where(nib > 7, nib - 16, nib)
    vals = _place(nib, bits)
    em = bits & (vals == -8)
    esc = _place(esc8.reshape(n, ng, capge).to(torch.int64), em)
    coef = torch.where(em, esc, vals).to(torch.float32)
    return coef * q.to(torch.float32).repeat(_G)


def _lib() -> ctypes.CDLL:
    lib = build.load("dct_unpack")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dct_unpack_launch.argtypes = (
            [vp] * 6 + [ctypes.c_int64, i, i, i, i, i, vp])
        lib.dct_unpack_launch.restype = i
        lib.dct_unpack_error_string.argtypes = [i]
        lib.dct_unpack_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def dct_unpack(bmc: torch.Tensor, bmb: torch.Tensor, valn: torch.Tensor,
               esc8: torch.Tensor, q: torch.Tensor, bl: int) -> torch.Tensor:
    """One component's pack streams for n regions -> dequantized AC
    coefficients [n, ng, G*64] f32.

    bmc [n, ceil(bl/2)] u8, bmb [n, ng*capbm] u8, valn [n, ng*capg/2] u8,
    esc8 [n, ng*capge] int8, q [64] f32; bl blocks per region. A CUDA pack
    launches kernels/csrc/dct_unpack.cu; a CPU pack runs
    ``dct_unpack_reference``."""
    if bmc.device.type == "cpu":
        return dct_unpack_reference(bmc, bmb, valn, esc8, q, bl)
    n = bmc.shape[0]
    ng = -(-bl // _G)
    dev = bmc.device
    for name, t, dt in (("bmc", bmc, torch.uint8), ("bmb", bmb, torch.uint8),
                        ("valn", valn, torch.uint8),
                        ("esc8", esc8, torch.int8), ("q", q, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"dct_unpack: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if (bmc.shape != (n, (bl + 1) // 2) or q.shape != (64,)
            or any(t.dim() != 2 or t.shape[0] != n or t.shape[1] % ng
                   for t in (bmb, valn, esc8))):
        raise ValueError(
            f"dct_unpack: shapes bmc {tuple(bmc.shape)}, bmb "
            f"{tuple(bmb.shape)}, valn {tuple(valn.shape)}, esc8 "
            f"{tuple(esc8.shape)}, q {tuple(q.shape)} do not fit {n} regions "
            f"of {bl} blocks")
    out = torch.empty((n, ng, _G * 64), device=dev, dtype=torch.float32)
    if n == 0:
        return out
    lib = _lib()
    err = lib.dct_unpack_launch(
        bmc.data_ptr(), bmb.data_ptr(), valn.data_ptr(), esc8.data_ptr(),
        q.data_ptr(), out.data_ptr(), n * ng, ng, bl, bmb.shape[1] // ng,
        valn.shape[1] * 2 // ng, esc8.shape[1] // ng,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "dct_unpack_error_string", err, "dct_unpack")
    dct_unpack.launches += 1
    return out


dct_unpack.launches = 0  # kernel launches on CUDA


def _unpack_component(dc8, bmc, bmb, valn, esc8, aidx, aval, didx, dval, q,
                      *, plain: bool = False):
    """One component's v3 pack -> dequantized coefficient blocks
    [n, bh*bw, 8, 8] f32. ``plain`` runs the unpack's plain version on any
    device (the card's plain reference pass); otherwise the device of the
    pack picks kernel or plain version."""
    n, bh, bw = dc8.shape
    bl = bh * bw
    qf = q.to(torch.float32).contiguous()
    unpack = dct_unpack_reference if plain else dct_unpack
    coef = unpack(bmc, bmb, valn, esc8, qf, bl)         # [n, ng, G*64]
    lg = coef.shape[1] * _G                             # padded block count
    flat = coef.view(-1)
    # |v| > 127 escapes overwrite their sentinels by coefficient index,
    # pre-dequantized. Pad slots carry idx = -1, and torch has no
    # mode='drop': a pad is sent to its region's coefficient (0, 0), the DC
    # slot of block 0, which the DC chain below overwrites — never wrapped.
    a = aidx.to(torch.int64)
    ok = (a >= 0) & (a < bl * 64)
    base = torch.arange(n, device=a.device)[:, None] * (lg * 64)
    qk = qf[torch.where(ok, a % 64, 0)]
    flat.index_put_((torch.where(ok, base + a, base).reshape(-1),),
                    torch.where(ok, aval.to(torch.float32) * qk,
                                torch.zeros_like(qk)).reshape(-1))
    # DC: scatter escape deltas (pads land in a spare column), chain row
    # starts down column 0, then prefix-sum each row
    d = didx.to(torch.int64)
    d32 = torch.zeros((n, bl + 1), dtype=torch.int64, device=dc8.device)
    d32[:, :bl] = dc8.reshape(n, bl)
    d32.scatter_(1, torch.where((d >= 0) & (d < bl), d, bl),
                 dval.to(torch.int64))
    d32 = d32[:, :bl].reshape(n, bh, bw)
    d32[:, :, 0] = torch.cumsum(d32[:, :, 0], 1)
    dc = torch.cumsum(d32, 2).reshape(n, bl)
    coef = coef.view(n, lg, 64)[:, :bl]
    coef[..., 0] = dc.to(torch.float32) * qf[0]
    return coef.reshape(n, bl, 8, 8)


def _idct_plane(coef: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """Coefficient blocks [n, bh*bw, 8, 8] -> uint8 sample plane
    [n, bh*8, bw*8]: s = M^T F M + 128, rounded half to even and clipped as
    the JAX package does. Both products are plain batched matmuls (outside
    any kernel there too); in f32, so the caller keeps TF32 off."""
    m = torch.from_numpy(_M8).to(coef.device)
    st = (coef @ m).transpose(-1, -2) @ m      # st[.., x, y] = s[.., y, x]
    n = coef.shape[0]
    plane = (st + 128.0).reshape(n, bh, bw, 8, 8).permute(0, 1, 4, 2, 3)
    plane = plane.reshape(n, bh * 8, bw * 8)
    return torch.clamp(torch.round(plane), 0.0, 255.0).to(torch.uint8)


def _crop_planes(plane: torch.Tensor, off: torch.Tensor, out_h: int,
                 out_w: int, denom: int) -> torch.Tensor:
    """Per-region crop of planes [n, H, W] to [n, out_h, out_w] at
    (off / denom), gathered on the device (no host round trip). The host
    packs the 16-aligned window plus one MCU row and column; cropping
    before the chroma upsample keeps plane-level libjpeg parity."""
    n = plane.shape[0]
    dev = plane.device
    rows = (off[:, 1] // denom).to(torch.int64)[:, None] \
        + torch.arange(out_h, device=dev)
    cols = (off[:, 0] // denom).to(torch.int64)[:, None] \
        + torch.arange(out_w, device=dev)
    return plane[torch.arange(n, device=dev)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]


def dct_regions_to_planes(y_dc8, y_bmc, y_bmb, y_valn, y_esc8, y_aidx,
                          y_aval, y_didx, y_dval, cb_dc8, cb_bmc, cb_bmb,
                          cb_valn, cb_esc8, cb_aidx, cb_aval, cb_didx,
                          cb_dval, cr_dc8, cr_bmc, cr_bmb, cr_valn, cr_esc8,
                          cr_aidx, cr_aval, cr_didx, cr_dval, qt, valid,
                          off=None, *, plain: bool = False):
    """Sparse v3 coefficient pack -> uint8 YCbCr planes (Y [n, h, w],
    Cb/Cr [n, h/2, w/2]); white past the per-region valid extents.

    qt [3, 64] quant tables (natural order); valid [n, 2] (valid_w,
    valid_h): pixels at or past the extent render white (Y=255,
    Cb=Cr=128). off: per-region even (dx, dy) luma crop offsets in
    [0, 16) when [n, 2] (the pack covers the 16-aligned origin plus one MCU
    row and column); [n, 0] or None for exact packs."""
    ybh, ybw = y_dc8.shape[1], y_dc8.shape[2]
    cbh, cbw = cb_dc8.shape[1], cb_dc8.shape[2]
    h, w = ybh * 8, ybw * 8
    y = _idct_plane(_unpack_component(
        y_dc8, y_bmc, y_bmb, y_valn, y_esc8, y_aidx, y_aval, y_didx, y_dval,
        qt[0], plain=plain), ybh, ybw)
    cb = _idct_plane(_unpack_component(
        cb_dc8, cb_bmc, cb_bmb, cb_valn, cb_esc8, cb_aidx, cb_aval, cb_didx,
        cb_dval, qt[1], plain=plain), cbh, cbw)
    cr = _idct_plane(_unpack_component(
        cr_dc8, cr_bmc, cr_bmb, cr_valn, cr_esc8, cr_aidx, cr_aval, cr_didx,
        cr_dval, qt[2], plain=plain), cbh, cbw)
    if off is not None and off.shape[-1] == 2:
        h, w = h - 16, w - 16
        y = _crop_planes(y, off, h, w, 1)
        cb = _crop_planes(cb, off, h // 2, w // 2, 2)
        cr = _crop_planes(cr, off, h // 2, w // 2, 2)
    dev = y.device
    vw = valid[:, 0].to(torch.int64)[:, None, None]
    vh = valid[:, 1].to(torch.int64)[:, None, None]
    col = torch.arange(w, device=dev)[None, None, :]
    row = torch.arange(h, device=dev)[None, :, None]
    y = torch.where((col < vw) & (row < vh), y, torch.full_like(y, 255))
    # chroma is written per 2x2 unit whose top-left pixel is in-slide
    ccol = torch.arange(w // 2, device=dev)[None, None, :]
    crow = torch.arange(h // 2, device=dev)[None, :, None]
    cvalid = (ccol < (vw + 1) // 2) & (crow < (vh + 1) // 2)
    cb = torch.where(cvalid, cb, torch.full_like(cb, 128))
    cr = torch.where(cvalid, cr, torch.full_like(cr, 128))
    return y, cb, cr


def dct_regions_to_rgb(*pack, plain: bool = False) -> torch.Tensor:
    """Sparse v3 coefficient pack -> f32 RGB [n, h, w, 3] in 0..255
    (yuv420_to_rgb over the decoded planes)."""
    return yuv420_to_rgb(*dct_regions_to_planes(*pack, plain=plain))
