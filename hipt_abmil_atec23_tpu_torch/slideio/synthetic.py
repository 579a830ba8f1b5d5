"""Synthetic slides for tests and for the card, where no slide files exist.

- ``make_tissue_image`` / ``write_synthetic_slide``: the port's own copy of
  hipt_abmil_atec23_tpu/slideio/synthetic.py (H&E-like pyramidal TIFFs
  written through the native library).
- ``he_like_planes``: a seeded H&E-like texture and its JFIF YCbCr 4:2:0
  planes, made in numpy.
- ``pack_dct_v3``: a numpy twin of the native sparse-DCT packer
  (native/wsireader.cpp ``pack_dct2_component``), byte for byte.
- ``DctMemorySlide``: an in-memory JPEG-like slide that serves the sparse
  DCT rung (``dct_probe`` / ``read_regions_dct``) and the pixel rungs from
  one set of quantized coefficients. A machine without the libtiff /
  libjpeg headers cannot build the native reader; this slide lets such a
  machine drive the DCT rung end to end. Nothing on the serving path uses
  it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio import native
from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide, DctRegions

# Blocks per padded value group of the pack (native kDctGroup; the same
# constant as ops/jpegdct._G, which a test holds against the native one)
_G = 16

# 8-point DCT basis with the JPEG normalization (ops/jpegdct._M8):
# coefficients F = M s M^T of a level-shifted block s, samples s = M^T F M
_M8 = (np.cos((2 * np.arange(8)[None, :] + 1) * np.arange(8)[:, None]
              * np.pi / 16)
       * np.concatenate([[np.sqrt(1 / 8)], np.full(7, 0.5)])[:, None])

# JPEG Annex K base tables, natural (row-major) order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full((8, 8), 99)
_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                     [47, 66, 99, 99]]


def make_tissue_image(width: int = 4096, height: int = 4096,
                      n_blobs: int = 3, n_holes: int = 2,
                      seed: int = 0) -> np.ndarray:
    """RGB uint8 synthetic H&E-ish slide image (white bg, stained blobs)."""
    import cv2
    rng = np.random.default_rng(seed)
    img = np.full((height, width, 3), 255, np.uint8)
    mask = np.zeros((height, width), np.uint8)
    for _ in range(n_blobs):
        cx = int(rng.uniform(0.2, 0.8) * width)
        cy = int(rng.uniform(0.2, 0.8) * height)
        ax = int(rng.uniform(0.1, 0.3) * width)
        ay = int(rng.uniform(0.1, 0.3) * height)
        cv2.ellipse(mask, (cx, cy), (ax, ay),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
    for _ in range(n_holes):
        cx = int(rng.uniform(0.3, 0.7) * width)
        cy = int(rng.uniform(0.3, 0.7) * height)
        r = int(rng.uniform(0.02, 0.06) * min(width, height))
        cv2.circle(mask, (cx, cy), r, 0, -1)
    # H&E-ish coloring + cellular texture
    noise = rng.integers(-25, 25, size=(height, width, 3), dtype=np.int16)
    tissue = np.array([199, 124, 180], np.int16) + noise  # pink-purple
    img[mask > 0] = np.clip(tissue, 0, 255).astype(np.uint8)[mask > 0]
    return img


def write_synthetic_slide(path: str, width: int = 4096, height: int = 4096,
                          n_levels: int = 4, tile: int = 256,
                          compression: int = native.COMPRESSION_JPEG,
                          seed: int = 0,
                          image: Optional[np.ndarray] = None,
                          ycbcr420: bool = False,
                          quality: int = 80) -> np.ndarray:
    """Write a synthetic pyramidal TIFF; returns the level-0 image.
    ycbcr420=True stores TCGA-style YCbCr 4:2:0 JPEG tiles."""
    img = image if image is not None else make_tissue_image(
        width, height, seed=seed)
    native.write_pyramid(path, img, tile=tile, n_levels=n_levels,
                         compression=compression, ycbcr420=ycbcr420,
                         quality=quality)
    return img


def he_like_planes(seed: int, size: int):
    """Seeded H&E-like RGB texture (white background, pink stroma blobs,
    purple nuclei) and its JFIF YCbCr 4:2:0 planes, made in numpy:
    (rgb [S, S, 3], y [S, S], cb [S/2, S/2], cr [S/2, S/2]) uint8."""
    rng = np.random.default_rng(seed)
    cell = 64
    low = rng.random((size // cell, size // cell)).astype(np.float32)
    for _ in range(3):  # smooth the tissue field a little
        low = (low + np.roll(low, 1, 0) + np.roll(low, 1, 1)
               + np.roll(low, -1, 0) + np.roll(low, -1, 1)) / 5
    tissue = np.kron(low > np.median(low), np.ones((cell, cell), bool))
    nuclei = np.kron(rng.random((size // 8, size // 8)) > 0.85,
                     np.ones((8, 8), bool)) & tissue
    rgb = np.empty((size, size, 3), np.uint8)
    rgb[:] = (236, 230, 238)
    rgb[tissue] = (199, 124, 180)
    rgb[nuclei] = (92, 58, 140)
    noise = rng.integers(-20, 21, size=(size, size, 1), dtype=np.int16)
    rgb = np.clip(rgb.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    f = rgb.astype(np.float32)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128
    cr = 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128

    def sub(c):  # 2x2 box average
        return c.reshape(size // 2, 2, size // 2, 2).mean((1, 3))

    q = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)
    return rgb, q(y), q(sub(cb)), q(sub(cr))


def jpeg_quant_tables(quality: int = 80) -> np.ndarray:
    """[3, 64] uint16 quant tables (Y, Cb, Cr; natural order) as libjpeg's
    jpeg_set_quality(quality, force_baseline=TRUE) scales Annex K."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tabs = [(np.asarray(t).reshape(64) * scale + 50) // 100
            for t in (_LUMA_Q, _CHROMA_Q, _CHROMA_Q)]
    return np.clip(np.stack(tabs), 1, 255).astype(np.uint16)


def dct_quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """uint8 plane [8 bh, 8 bw] -> quantized coefficients [bh, bw, 64]
    int16 (natural order): forward 8x8 DCT of the level-shifted samples,
    divided by the table and rounded, as a JPEG encoder does."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    s = (plane.astype(np.float64) - 128.0).reshape(bh, 8, bw, 8)
    s = s.transpose(0, 2, 1, 3)                            # [bh, bw, 8, 8]
    f = _M8 @ s @ _M8.T
    return np.rint(f.reshape(bh, bw, 64) / q).astype(np.int16)


def dct_decode(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quantized coefficients [bh, bw, 64] -> uint8 plane [8 bh, 8 bw]:
    dequantize, inverse DCT in f64, +128, round, clip."""
    bh, bw = coef.shape[:2]
    f = (coef.astype(np.float64) * q).reshape(bh, bw, 8, 8)
    s = _M8.T @ f @ _M8 + 128.0
    s = s.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def pack_dct_v3(dense_q: np.ndarray, bw: int, bh: int,
                caps: Tuple[int, int, int, int, int]):
    """One component of one region -> its v3 sparse pack, byte for byte as
    native/wsireader.cpp ``pack_dct2_component`` writes it.

    dense_q: [bh*bw, 64] quantized coefficients (raster block order,
    natural coefficient order). caps = (capg, capge, cap_aesc, cap_desc,
    capbm): value slots, escape bytes and bitmap bytes per 16-block group,
    and the explicit AC / DC escape slots per region.

    Returns (dc8, bmc, bmb, valn, esc8, aidx, aval, didx, dval, cnts, ok).
    ``ok`` is False where an explicit stream overflows (the native packer
    then flags the region for a pixel read). The explicit streams' pad
    values are 0 here; the native packer leaves them unwritten.

    The byte budgets are sequential within a group only, so the loop runs
    over the 16 block positions of a group with every group at once, on the
    list of nonzero AC coefficients.
    """
    capg, capge, cap_aesc, cap_desc, capbm = (int(c) for c in caps)
    bl = bh * bw
    ng = -(-bl // _G)
    dense = np.asarray(dense_q).reshape(bl, 64)

    # DC deltas: (r, c>0) vs (r, c-1); row starts vs the previous row start
    dc = dense[:, 0].astype(np.int32).reshape(bh, bw)
    delta = np.empty_like(dc)
    delta[:, 1:] = dc[:, 1:] - dc[:, :-1]
    delta[1:, 0] = dc[1:, 0] - dc[:-1, 0]
    delta[0, 0] = dc[0, 0]
    delta = delta.reshape(bl)
    dflag = (delta < -128) | (delta > 127)
    dc8 = np.where(dflag, 0, delta).astype(np.int8).reshape(bh, bw)
    dpos = np.flatnonzero(dflag)

    # nonzero ACs ordered by (block position p, group, k): one contiguous
    # run of entries per position
    ac = np.zeros((ng * _G, 64), np.int16)
    ac[:bl, 1:] = dense[:, 1:]
    p_, g_, k = np.nonzero(ac.reshape(ng, _G, 64).transpose(1, 0, 2))
    v = ac.reshape(ng, _G, 64)[g_, p_, k].astype(np.int32)
    g_ = g_.astype(np.int64)
    esc = (v < -7) | (v > 7)
    byte = k >> 3
    blk = g_ * _G + p_
    last = np.flatnonzero(np.diff(blk, append=-1) != 0)  # block's last AC
    need = np.zeros(ng * _G, np.int64)
    need[blk[last]] = byte[last] + 1
    need = need.reshape(ng, _G)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(p_, minlength=_G))])

    def runs(g):
        """Start index of each entry's run of equal g (g sorted)."""
        start = np.flatnonzero(np.diff(g, prepend=-1) != 0)
        return np.repeat(start, np.diff(np.append(start, len(g))))

    def ranks(mask, first):
        """0-based rank of each entry among the masked entries of its run."""
        c = np.cumsum(mask)
        return c - (c[first] - mask[first]) - 1

    gfill = np.zeros(ng, np.int64)
    gefill = np.zeros(ng, np.int64)
    gbfill = np.zeros(ng, np.int64)
    slots = np.zeros((ng, capg), np.int8)
    esc8 = np.zeros((ng, capge), np.int8)
    bmb = np.zeros(ng * capbm, np.uint8)
    bcnt = np.zeros((ng, _G), np.int64)
    spilled = []
    for p in range(_G):
        sel = slice(bounds[p], bounds[p + 1])
        g, kk, vv, ee, by = g_[sel], k[sel], v[sel], esc[sel], byte[sel]
        first = runs(g)
        nbytes = np.minimum(need[:, p], capbm - gbfill)
        cand = by < nbytes[g]
        rank = ranks(cand, first)
        ship = cand & (rank < capg - gfill[g])
        eship = ship & ee
        erank = ranks(eship, first)
        eok = eship & (erank < capge - gefill[g])
        big = eok & ((vv < -127) | (vv > 127))
        spilled.append((blk[sel] * 64 + kk)[~ship | (eship & ~eok) | big])
        # value slots: the nibble, -8 for an escape byte, 0 where the
        # escape slots ran out (the true value rides aesc)
        nib = np.where(eok, -8, np.where(eship, 0, vv))
        slots[g[ship], gfill[g[ship]] + rank[ship]] = nib[ship]
        esc8[g[eok], gefill[g[eok]] + erank[eok]] = np.where(
            big, -128, vv)[eok]
        # shipped bitmap prefix, trailing empty bytes trimmed
        gs, bs = g[ship], by[ship]
        b8 = np.bincount(gs * 8 + bs, weights=1 << (kk[ship] & 7),
                         minlength=ng * 8).astype(np.uint8).reshape(ng, 8)
        nb = np.zeros(ng, np.int64)
        end = np.flatnonzero(np.diff(gs, append=-1) != 0)
        nb[gs[end]] = bs[end] + 1
        gi, i = np.nonzero(np.arange(8)[None, :] < nb[:, None])
        bmb[gi * capbm + gbfill[gi] + i] = b8[gi, i]
        bcnt[:, p] = nb
        gbfill += nb
        gfill += np.bincount(gs, minlength=ng)
        gefill += np.bincount(g[eok], minlength=ng)

    s = slots.astype(np.uint8) & 0xF
    valn = (s[:, 0::2] | (s[:, 1::2] << 4)).reshape(-1)
    c = np.zeros(2 * ((bl + 1) // 2), np.uint8)
    c[:bl] = bcnt.reshape(-1)[:bl]
    bmc = c[0::2] | (c[1::2] << 4)
    apos = np.sort(np.concatenate(spilled))
    ok = len(apos) <= cap_aesc and len(dpos) <= cap_desc
    aidx = np.full(cap_aesc, -1, np.int32)
    aval = np.zeros(cap_aesc, np.int16)
    didx = np.full(cap_desc, -1, np.int32)
    dval = np.zeros(cap_desc, np.int16)
    if ok:
        aidx[:len(apos)] = apos
        aval[:len(apos)] = dense.reshape(-1)[apos]
        didx[:len(dpos)] = dpos
        dval[:len(dpos)] = delta[dpos]
    cnts = np.array([len(v), len(apos), len(dpos),
                     np.bincount(g_, minlength=ng).max(initial=0),
                     np.bincount(g_[esc], minlength=ng).max(initial=0),
                     need.sum(1).max(initial=0)], np.int32)
    return (dc8, bmc, bmb, valn, esc8.reshape(-1), aidx, aval, didx, dval,
            cnts, ok)


class DctMemorySlide(BaseSlide):
    """A one-level in-memory slide stored as JPEG YCbCr 4:2:0 would store
    it: quantized DCT coefficients of its planes at ``quality`` (Annex K
    tables scaled as libjpeg scales them). It serves the sparse-DCT rung
    (``dct_probe``, ``read_regions_dct`` with the native reader's signature
    and result) and the pixel rungs (``read_regions_yuv420``,
    ``read_region(s)``) from its own numpy decode of the same coefficients,
    so every rung sees one image. Blocks past the slide edge are zero, as
    the native reader leaves them.

    y [H, W], cb / cr [H/2, W/2] uint8 with H and W multiples of 16."""

    def __init__(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                 quality: int = 80):
        h, w = y.shape
        if h % 16 or w % 16 or cb.shape != (h // 2, w // 2) \
                or cr.shape != cb.shape:
            raise ValueError(f"planes Y {y.shape}, Cb {cb.shape}, Cr "
                             f"{cr.shape}: need 4:2:0 with H, W % 16 == 0")
        self.qt = jpeg_quant_tables(quality)
        self.coef = [dct_quantize(p, self.qt[c].astype(np.float64))
                     for c, p in enumerate((y, cb, cr))]
        self.planes = [dct_decode(k, self.qt[c])
                       for c, k in enumerate(self.coef)]
        self.level_dimensions = [(w, h)]

    def dct_probe(self, level: int = 0):
        return self.qt.copy() if level == 0 else None

    def supports_yuv420(self, level: int = 0) -> bool:
        return level == 0

    def _window(self, c: int, bx: int, by: int, nbw: int, nbh: int):
        """[nbh*nbw, 64] coefficients of a block window, zero off-grid."""
        k = self.coef[c]
        out = np.zeros((nbh, nbw, 64), np.int16)
        y1, x1 = min(by + nbh, k.shape[0]), min(bx + nbw, k.shape[1])
        if y1 > by and x1 > bx:
            out[:y1 - by, :x1 - bx] = k[by:y1, bx:x1]
        return out.reshape(nbh * nbw, 64)

    def read_regions_dct(self, locations, level, size, cap_y_pb: int = 32,
                         cap_c_pb: int = 12, cap_ge_y: int = 64,
                         cap_ge_c: int = 16, cap_aesc_y: int = 1024,
                         cap_aesc_c: int = 256, cap_desc_y: int = 4096,
                         cap_desc_c: int = 1024, cap_bm_y: int = 8,
                         cap_bm_c: int = 8, n_threads: int = 0):
        """Batched sparse-DCT reads with slideio/reader.TiffSlide's
        signature, geometry rules (16-aligned packs, ``off`` for even
        origins off the MCU lattice, odd origins flagged) and DctRegions
        result; packed by ``pack_dct_v3``."""
        if level != 0:
            raise IOError("DctMemorySlide has one level")
        locations = np.asarray(locations, np.int64).reshape(-1, 2)
        w, h = size
        n = len(locations)
        offs = (locations & 15).astype(np.int32)
        odd = bool((locations & 1).any() or (w | h) & 1)
        if odd:
            offs = np.zeros((n, 2), np.int32)
        origin = locations - offs
        if offs.any():
            w, h = w + 16, h + 16
            off_out = offs
        else:
            off_out = np.zeros((n, 0), np.int32)
        geo = [(w // 8, h // 8, 8, _G * cap_y_pb, cap_ge_y, cap_aesc_y,
                cap_desc_y, _G * cap_bm_y)] + \
              [(w // 16, h // 16, 16, _G * cap_c_pb, cap_ge_c, cap_aesc_c,
                cap_desc_c, _G * cap_bm_c)] * 2
        comps = []
        for bw, bh, _, capg, capge, capa, capd, capbm in geo:
            ng = -(-(bw * bh) // _G)
            comps.append([np.zeros((n, bh, bw), np.int8),
                          np.zeros((n, (bw * bh + 1) // 2), np.uint8),
                          np.zeros((n, ng * capbm), np.uint8),
                          np.zeros((n, ng * capg // 2), np.uint8),
                          np.zeros((n, ng * capge), np.int8),
                          np.full((n, capa), -1, np.int32),
                          np.zeros((n, capa), np.int16),
                          np.full((n, capd), -1, np.int32),
                          np.zeros((n, capd), np.int16)])
        cnts = np.zeros((n, 3, 6), np.int32)
        good = np.zeros((n, 3), bool)

        def pack(i, c):
            bw, bh, sub, capg, capge, capa, capd, capbm = geo[c]
            dense = self._window(c, int(origin[i, 0]) // sub,
                                 int(origin[i, 1]) // sub, bw, bh)
            *arrs, cnts[i, c], good[i, c] = pack_dct_v3(
                dense, bw, bh, (capg, capge, capa, capd, capbm))
            for dst, src in zip(comps[c], arrs):
                dst[i] = src.reshape(dst[i].shape)

        todo = [(i, c) for i in range(n) for c in range(3)
                if not odd and w % 16 == 0 and h % 16 == 0
                and (origin[i] >= 0).all()]
        if todo and w * h >= 1 << 20:
            # numpy releases the GIL in its array loops: the packs of a
            # batch of large regions run side by side, as the native
            # reader's threads do
            with ThreadPoolExecutor(n_threads or len(todo)) as ex:
                list(ex.map(lambda t: pack(*t), todo))
        else:
            # a small patch's pack is mostly Python under the GIL, which
            # threads only slow down (~3x at 256^2)
            for t in todo:
                pack(*t)
        status = np.where(good.all(1), 0, 1).astype(np.int8)
        lw, lh = self.level_dimensions[0]
        tw, th = size
        valid = np.stack([np.clip(lw - locations[:, 0], 0, tw),
                          np.clip(lh - locations[:, 1], 0, th)],
                         1).astype(np.int32)
        return DctRegions(*comps[0], *comps[1], *comps[2], cnts, valid,
                          status, off_out)

    def read_regions_yuv420(self, locations, level, size, n_threads=0):
        """(Y [n, h, w], Cb / Cr [n, h/2, w/2]) uint8 from the slide's own
        decode; white past the slide edge. Coords and size must be even."""
        w, h = size
        locations = np.asarray(locations, np.int64).reshape(-1, 2)
        if level != 0 or (locations & 1).any() or (w | h) & 1:
            raise IOError("4:2:0 plane reads need level 0, even coords and "
                          "an even size")
        outs = []
        for c, (fill, sub) in enumerate(((255, 1), (128, 2), (128, 2))):
            p = self.planes[c]
            o = np.full((len(locations), h // sub, w // sub), fill, np.uint8)
            for i, (x, y) in enumerate(locations // sub):
                blk = p[y:y + h // sub, x:x + w // sub]
                o[i, :blk.shape[0], :blk.shape[1]] = blk
            outs.append(o)
        return tuple(outs)

    def read_region(self, location, level, size):
        import torch
        from hipt_abmil_atec23_tpu_torch.ops.yuv import yuv420_to_rgb
        x, y = (int(v) & ~1 for v in location)
        dx, dy = int(location[0]) - x, int(location[1]) - y
        even = ((dx + size[0] + 1) & ~1, (dy + size[1] + 1) & ~1)
        planes = self.read_regions_yuv420([[x, y]], level, even)
        rgb = yuv420_to_rgb(*(torch.from_numpy(p[0]) for p in planes))
        rgb = torch.round(rgb).to(torch.uint8).numpy()
        return rgb[dy:dy + size[1], dx:dx + size[0]].copy()
