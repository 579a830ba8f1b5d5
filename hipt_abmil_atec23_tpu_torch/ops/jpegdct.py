"""On-device JPEG decode from sparse quantized DCT coefficients.

Counterpart of hipt_abmil_atec23_tpu/ops/jpegdct.py. The host ships the
JPEG codec's own quantized coefficients in the sparse pack v3 (format in the
JAX module's docstring and in slideio/reader.DctRegions) instead of decoded
pixels, and the card decodes them to the planes ops/yuv.py takes:

    unpack of the bitmap, nibble and escape streams -> |v| > 127 explicit
    escapes -> DC chain with its escapes -> dequantize -> 8x8 IDCT -> crop
    -> white mask -> uint8 planes

On a CUDA pack all of that is kernels/csrc/dct_decode.cu, a DC pre-pass
and one decode launch (``dct_regions_to_planes``); on a CPU pack, or with
``plain=True``, it is ``dct_regions_to_planes_reference``: the stream
expansion by ranks from a ``cumsum`` of the marks and a gather from the
stream (``dct_unpack_reference``), the DC chain and escapes as scatters
and cumsums (``_unpack_component``), the IDCT as batched matmuls. The JAX
package's factorized one-hot expansion (``_expand`` / ``_kexpand``) works
around the TPU's matrix unit and Mosaic's layout rules and has no
counterpart here.

Numerics: the f32 IDCT sums in another order than the JAX package's einsum
and than the kernel, so planes agree within 1 LSB; the dequantized
coefficients are integers times the table and agree bit for bit.
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
    """The plain decode's stream expansion: one component's pack streams
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


def _unpack_component(dc8, bmc, bmb, valn, esc8, aidx, aval, didx, dval, q):
    """One component's v3 pack -> dequantized coefficient blocks
    [n, bh*bw, 8, 8] f32 (plain PyTorch; what the decode kernel's tap
    writes)."""
    n, bh, bw = dc8.shape
    bl = bh * bw
    qf = q.to(torch.float32).contiguous()
    coef = dct_unpack_reference(bmc, bmb, valn, esc8, qf, bl)  # [n, ng, G*64]
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


def dct_regions_to_planes_reference(
        y_dc8, y_bmc, y_bmb, y_valn, y_esc8, y_aidx, y_aval, y_didx, y_dval,
        cb_dc8, cb_bmc, cb_bmb, cb_valn, cb_esc8, cb_aidx, cb_aval, cb_didx,
        cb_dval, cr_dc8, cr_bmc, cr_bmb, cr_valn, cr_esc8, cr_aidx, cr_aval,
        cr_didx, cr_dval, qt, valid, off=None):
    """Plain PyTorch version of the decode kernel: sparse v3 coefficient
    pack -> uint8 YCbCr planes (Y [n, h, w], Cb/Cr [n, h/2, w/2]); white
    past the per-region valid extents.

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
        qt[0]), ybh, ybw)
    cb = _idct_plane(_unpack_component(
        cb_dc8, cb_bmc, cb_bmb, cb_valn, cb_esc8, cb_aidx, cb_aval, cb_didx,
        cb_dval, qt[1]), cbh, cbw)
    cr = _idct_plane(_unpack_component(
        cr_dc8, cr_bmc, cr_bmb, cr_valn, cr_esc8, cr_aidx, cr_aval, cr_didx,
        cr_dval, qt[2]), cbh, cbw)
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


# pack fields per component, in DctBatch order, and the dtypes the kernel
# reads them as
_FIELDS = ("dc8", "bmc", "bmb", "valn", "esc8", "aidx", "aval", "didx",
          "dval")
_DTYPES = (torch.int8, torch.uint8, torch.uint8, torch.uint8, torch.int8,
           torch.int32, torch.int16, torch.int32, torch.int16)
_SMEM_LIMIT = 232448  # shared memory a CTA may have on Hopper


def _lib() -> ctypes.CDLL:
    lib = build.load("dct_decode")
    if not getattr(lib, "_hk_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dct_decode_launch.argtypes = [vp] * 9 + [i, vp]
        lib.dct_decode_launch.restype = i
        lib.dct_decode_smem_bytes.argtypes = [i] * 4
        lib.dct_decode_smem_bytes.restype = i
        lib.dct_decode_error_string.argtypes = [i]
        lib.dct_decode_error_string.restype = ctypes.c_char_p
        lib._hk_bound = True
    return lib


def _check_pack(pack, dev) -> None:
    """Raise on what the decode kernel does not take: wrong dtypes,
    devices or layouts, shapes that do not fit the block grids, and any
    geometry but 4:2:0."""
    if len(pack) != 30:
        raise ValueError(f"dct_regions_to_planes: {len(pack)} fields, "
                         "expected 27 component arrays + qt, valid, off")
    n = pack[0].shape[0]
    for c, comp in enumerate(("y", "cb", "cr")):
        fields = pack[9 * c:9 * c + 9]
        for name, t, dt in zip(_FIELDS, fields, _DTYPES):
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError(
                    f"dct_regions_to_planes: {comp}_{name} must be a "
                    f"contiguous {dt} tensor on {dev}, got {t.dtype} on "
                    f"{t.device}")
        dc8, bmc, bmb, valn, esc8, aidx, aval, didx, dval = fields
        if dc8.dim() != 3 or dc8.shape[0] != n:
            raise ValueError(f"dct_regions_to_planes: {comp}_dc8 "
                             f"{tuple(dc8.shape)} is not [{n}, bh, bw]")
        bl = dc8.shape[1] * dc8.shape[2]
        ng = -(-bl // _G)
        if (bmc.shape != (n, (bl + 1) // 2)
                or any(t.dim() != 2 or t.shape[0] != n or t.shape[1] % ng
                       for t in (bmb, valn, esc8))
                or aidx.dim() != 2 or aidx.shape != aval.shape
                or didx.dim() != 2 or didx.shape != dval.shape
                or aidx.shape[0] != n or didx.shape[0] != n):
            raise ValueError(
                f"dct_regions_to_planes: {comp} streams "
                f"{[tuple(t.shape) for t in fields[1:]]} do not fit {n} "
                f"regions of {bl} blocks")
    ygrid, cgrid = pack[0].shape[1:], pack[9].shape[1:]
    if (pack[18].shape[1:] != cgrid or ygrid[0] != 2 * cgrid[0]
            or ygrid[1] != 2 * cgrid[1]):
        raise ValueError(
            f"dct_regions_to_planes: block grids Y {tuple(ygrid)}, Cb "
            f"{tuple(cgrid)}, Cr {tuple(pack[18].shape[1:])} are not 4:2:0")
    qt, valid, off = pack[27:]
    for name, t, shape in (("qt", qt, (3, 64)), ("valid", valid, (n, 2))):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape != shape):
            raise ValueError(f"dct_regions_to_planes: {name} must be a "
                             f"contiguous int32 {shape} tensor on {dev}")
    if off is not None and (off.device != dev or off.dtype != torch.int32
                            or not off.is_contiguous()
                            or off.shape not in ((n, 2), (n, 0))):
        raise ValueError("dct_regions_to_planes: off must be a contiguous "
                         f"int32 [{n}, 2] or [{n}, 0] tensor on {dev}")


def dct_regions_to_planes(*pack, plain: bool = False, tap: bool = False):
    """Sparse v3 coefficient pack (the 30 DctBatch fields; ``off`` may be
    None) -> uint8 YCbCr planes, as ``dct_regions_to_planes_reference``
    computes them. A CUDA pack runs kernels/csrc/dct_decode.cu, a DC
    pre-pass and the decode (4:2:0 only; anything else raises); a CPU
    pack, or ``plain``, runs the plain version. ``tap`` also returns the
    dequantized coefficient blocks [n, bh*bw, 8, 8] f32 of each
    component, as ``_unpack_component`` returns them (the kernel writes
    them beside the planes)."""
    if len(pack) == 29:
        pack = (*pack, None)
    if plain or pack[0].device.type == "cpu":
        planes = dct_regions_to_planes_reference(*pack)
        if not tap:
            return planes
        return (*planes, [_unpack_component(*pack[9 * c:9 * c + 9],
                                            pack[27][c]) for c in range(3)])
    dev = pack[0].device
    _check_pack(pack, dev)
    off = pack[29]
    if off is not None and off.shape[1] == 0:
        off = None
    n, ybh, ybw = pack[0].shape
    crop = 16 if off is not None else 0
    h, w = ybh * 8 - crop, ybw * 8 - crop
    if h <= 0 or w <= 0:
        raise ValueError(f"dct_regions_to_planes: a {ybh * 8}x{ybw * 8} "
                         "pack has nothing left after the 16-pixel crop")
    outs = [torch.empty((n, h, w), dtype=torch.uint8, device=dev),
            *(torch.empty((n, h // 2, w // 2), dtype=torch.uint8,
                          device=dev) for _ in range(2))]
    taps = [torch.empty((n, pack[9 * c].shape[1] * pack[9 * c].shape[2],
                         8, 8), dtype=torch.float32, device=dev)
            for c in range(3)] if tap else None
    if n == 0:
        return (*outs, taps) if tap else tuple(outs)
    dims = []
    for c in range(3):
        dc8, _, bmb, valn, esc8, aidx, _, didx, _ = pack[9 * c:9 * c + 9]
        ng = -(-(dc8.shape[1] * dc8.shape[2]) // _G)
        dims += [dc8.shape[1], dc8.shape[2], bmb.shape[1] // ng,
                 valn.shape[1] * 2 // ng, esc8.shape[1] // ng, aidx.shape[1],
                 didx.shape[1], outs[c].shape[1], outs[c].shape[2]]
    lib = _lib()
    if max(lib.dct_decode_smem_bytes(ybw, *dims[9 * c + 2:9 * c + 5])
           for c in range(3)) > _SMEM_LIMIT:
        raise ValueError(f"dct_regions_to_planes: rows of {ybw} blocks at "
                         "these caps outgrow a CTA's shared memory")
    ptrs = (ctypes.c_void_p * 27)(*(t.data_ptr() for t in pack[:27]))
    out_ptrs = (ctypes.c_void_p * 3)(*(t.data_ptr() for t in outs))
    tap_ptrs = (ctypes.c_void_p * 3)(*(t.data_ptr() for t in taps)) \
        if tap else None
    # the DC pre-pass's output: every block's DC, each row's escape range
    scratch = torch.empty(
        n * sum(pack[9 * c].shape[1] * (pack[9 * c].shape[2] + 2)
                for c in range(3)), dtype=torch.int32, device=dev)
    err = lib.dct_decode_launch(
        ptrs, out_ptrs, tap_ptrs, (ctypes.c_int * 27)(*dims),
        pack[27].data_ptr(), pack[28].data_ptr(),
        off.data_ptr() if off is not None else None, _M8_C,
        scratch.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "dct_decode_error_string", err, "dct_regions_to_planes")
    dct_regions_to_planes.launches += 1
    return (*outs, taps) if tap else tuple(outs)


dct_regions_to_planes.launches = 0  # decodes launched on CUDA (2 kernels)
_M8_C = (ctypes.c_float * 64)(*_M8.reshape(-1).tolist())


def dct_regions_to_rgb(*pack, plain: bool = False) -> torch.Tensor:
    """Sparse v3 coefficient pack -> f32 RGB [n, h, w, 3] in 0..255
    (yuv420_to_rgb over the decoded planes)."""
    return yuv420_to_rgb(*dct_regions_to_planes(*pack, plain=plain))
