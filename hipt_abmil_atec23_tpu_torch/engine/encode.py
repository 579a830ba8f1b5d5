"""Feature extraction: slides + coords -> per-slide feature bags (HIPT_4K
region features; ViT-256, ResNet50-trunc, ResNet-18 or LeViT patch
features).

Counterpart of hipt_abmil_atec23_tpu/engine/encode.py:

  one decode worker (native threaded region reads, ``prefetch`` batches
  ahead; host resize and transform) -> pinned host tensors -> H2D on a
  dedicated CUDA stream -> encoder on the current stream, collected one
  batch deep

or, with ``stage=True``, every batch copied to the card (up to a byte
budget per flush) before the flush dispatches its computes back to back.
``encode_many`` is the encode stage over slide files and coords h5s: the
next slide group opens on a thread, a writer thread persists the bags in
the reference's layout (data/bags.py), and a slide that cannot be opened is
reported, not fatal.

Each batch rides one of three transfer rungs, cheapest wire bytes first:

  1. dct: sparse quantized-DCT packs (ops/jpegdct.py; 0.46 bytes/px on
     chip_smoke.py's quality-80 fixture at its probed caps) for JPEG YCbCr
     4:2:0 slides on an even region grid; the card decodes them to planes
     (kernels/csrc/dct_decode.cu), then as the yuv rung;
  2. yuv: raw YCbCr planes (1.5 bytes/px for 4:2:0), which the card turns
     into the encoder's input (kernels/csrc/ycc_input.cu, ops/yuv.py);
  3. rgb: RGB pixels (3 bytes/px); the only rung for a host transform or
     resize.

With ``adaptive_rungs`` the stream picks the rung per batch by predicted
pipeline cost (``select_rung``) once it has a wire-rate estimate (seeded by
``wire_mbps_hint``), from three EWMAs it keeps itself: host decode ms/Mpx
per rung, device ms/Mpx per rung, and the wire rate from CUDA events around
each H2D on the copy stream. A CPU encoder has no wire, so it keeps the
byte-lightest rung unless a hint or the pace shim (``pace_put_mbps``) gives
it a rate.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu_torch.device import resolve_device
from hipt_abmil_atec23_tpu_torch.models.hipt import (
    hipt_eval_normalize, make_hipt_encoder)
from hipt_abmil_atec23_tpu_torch.models.resnet import imagenet_normalize
from hipt_abmil_atec23_tpu_torch.ops.jpegdct import _G, dct_regions_to_planes
from hipt_abmil_atec23_tpu_torch.ops.yuv import ycc_to_input
from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig


class DctBatch(NamedTuple):
    """One compute batch shipped as sparse quantized-DCT v3 packs instead
    of pixels. Field order matches ops/jpegdct.dct_regions_to_planes (27
    component arrays + qt + valid + off). This is a tuple subtype:
    dispatchers test DctBatch BEFORE the plain-tuple (YUV planes) case."""
    y_dc8: np.ndarray   # [n, h/8, w/8] int8 delta-coded DC
    y_bmc: np.ndarray   # [n, ceil(bl/2)] uint8 4-bit bitmap prefix lengths
    y_bmb: np.ndarray   # [n, ng*capbm] uint8 group-padded bitmap prefixes
    y_valn: np.ndarray  # [n, cap/2] uint8 nibble-packed AC values
    y_esc8: np.ndarray  # [n, ng*capge] int8 group-padded AC escapes
    y_aidx: np.ndarray  # [n, cap_a] int32 |v|>127-escape coef indices
    y_aval: np.ndarray  # [n, cap_a] int16 escape values
    y_didx: np.ndarray  # [n, cap_d] int32 DC-escape block indices
    y_dval: np.ndarray  # [n, cap_d] int16 DC-escape deltas
    cb_dc8: np.ndarray
    cb_bmc: np.ndarray
    cb_bmb: np.ndarray
    cb_valn: np.ndarray
    cb_esc8: np.ndarray
    cb_aidx: np.ndarray
    cb_aval: np.ndarray
    cb_didx: np.ndarray
    cb_dval: np.ndarray
    cr_dc8: np.ndarray
    cr_bmc: np.ndarray
    cr_bmb: np.ndarray
    cr_valn: np.ndarray
    cr_esc8: np.ndarray
    cr_aidx: np.ndarray
    cr_aval: np.ndarray
    cr_didx: np.ndarray
    cr_dval: np.ndarray
    qt: np.ndarray      # [3, 64] int32 quant tables (per slide)
    valid: np.ndarray   # [n, 2] int32 in-slide extents (white past them)
    off: np.ndarray     # [n, 2] int32 device crop offsets (grids off the
                        # 16px MCU lattice), or [n, 0] for exact packs


# --------------------------------------------------------------------------
# Rate-adaptive transfer-rung selection
# --------------------------------------------------------------------------
# Seed per-megapixel stage costs at 4096^2 regions, batch 2, full-width
# HIPT_4K in bf16: device ms/Mpx of each rung's entry with its input
# already on the card (CUDA events), and host read ms/Mpx of chip_smoke.py's
# in-memory fixture slides (slideio/synthetic.DctMemorySlide: the numpy
# packer, numpy-decoded planes and a torch CPU colour conversion, not
# libjpeg). Both from chip_smoke.py's DCT phase ("rung seeds" line) on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit. Seeds only: encode_stream
# re-calibrates both tables from its own per-batch decode and device times
# (EWMA). Only the relative costs matter.
RUNG_BYTES_PER_PX = {"yuv": 1.5, "rgb": 3.0}   # dct is measured per-slide
RUNG_HOST_MS_PER_MPX = {"dct": 48.99, "yuv": 0.43, "rgb": 34.73}
RUNG_DEV_MS_PER_MPX = {"dct": 3.76, "yuv": 3.61, "rgb": 3.46}


def select_rung(feasible, wire_mbps, region_px, dct_bytes_per_px=None,
                current=None, hysteresis=0.85,
                host_ms_mpx=None, dev_ms_mpx=None, yuv_bytes_per_px=None):
    """Pick the transfer rung with the lowest predicted per-region cost.

    The stream pipelines three serialized stages (host decode worker ->
    H2D -> device), so a rung's steady-state cost is max(wire_s, host_s,
    device_s) per region. ``current`` + ``hysteresis``: a sitting rung is
    kept unless the challenger is predicted at least (1 - hysteresis)
    cheaper. ``host_ms_mpx`` / ``dev_ms_mpx``: per-rung stage-cost tables
    (ms per megapixel), the seeds above by default; streams pass their own
    EWMA-calibrated tables. ``yuv_bytes_per_px``: 1.5 for 4:2:0, 2.0 for
    4:2:2. Returns (rung, costs_dict)."""
    host_tab = host_ms_mpx or RUNG_HOST_MS_PER_MPX
    dev_tab = dev_ms_mpx or RUNG_DEV_MS_PER_MPX
    mpx = region_px / 1e6
    costs = {}
    for r in feasible:
        bpp = (dct_bytes_per_px if r == "dct"
               else yuv_bytes_per_px or RUNG_BYTES_PER_PX[r] if r == "yuv"
               else RUNG_BYTES_PER_PX[r])
        if bpp is None:
            continue
        wire_s = (region_px * bpp / (wire_mbps * 1e6)
                  if wire_mbps and wire_mbps > 0 else float("inf"))
        host_s = mpx * host_tab[r] / 1e3
        dev_s = mpx * dev_tab[r] / 1e3
        costs[r] = max(wire_s, host_s, dev_s)
    if not costs:
        return "rgb", costs
    best = min(costs, key=costs.get)
    if (current in costs and best != current
            and costs[best] > hysteresis * costs[current]):
        return current, costs
    return best, costs


@dataclass
class Encoder:
    """A fixed-batch encoder on one device: uint8 RGB [B, S, S, 3], YCbCr
    planes or a sparse-DCT pack -> [B, feat_dim] f32, the normalize fused
    in. ``normalize``: the encoder's input transform, "hipt" (x / 127.5 -
    1; HIPT_4K, vit256) or "imagenet" (ResNet, LeViT). ``features``: the
    ``model.asset_dict`` entry to return (HIPT's mean256 / concat
    variants), or None for ``model(x)``. ``plane_rung`` and ``dct_rung``
    offer the raw-plane and sparse-DCT entries to encode_stream (the JAX
    package's ``apply_yuv`` / ``apply_dct is not None``; LeViT has
    neither). On the card the plane and DCT entries run the colour kernel
    (and the DCT entry the decode kernel before it); ``plain_unpack`` runs
    both plain versions on the card too, for a reference pass; the serving
    path leaves it off."""
    model: nn.Module
    batch_size: int
    input_size: int      # spatial size S of one region or patch
    feat_dim: int
    device: torch.device
    dct_rung: bool = True
    plane_rung: bool = True
    plain_unpack: bool = False
    features: Optional[str] = None
    normalize: str = "hipt"

    def apply(self, batch_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._forward(NORMALIZE[self.normalize](batch_u8))

    def apply_yuv(self, y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
        """Raw-plane entry: Y [B, S, S], Cb/Cr at 4:2:0 or 4:2:2."""
        with torch.inference_mode():
            return self._encode_planes(y, cb, cr)

    def apply_dct(self, *pack: torch.Tensor) -> torch.Tensor:
        """Sparse-DCT entry: the 30 DctBatch fields on the device."""
        with torch.inference_mode():
            return self._encode_planes(*dct_regions_to_planes(
                *pack, plain=self.plain_unpack))

    def _encode_planes(self, y, cb, cr) -> torch.Tensor:
        return self._forward(ycc_to_input(y, cb, cr, self.model.input_dtype,
                                          normalize=self.normalize,
                                          plain=self.plain_unpack))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.features is None:
            return self.model(x)
        return self.model.asset_dict(x)[self.features]


# HIPT feature variant -> the asset_dict entry the encoder returns
# (reference: forward_asset_dict, hipt_4k.py:79-118); cls4k is the forward
HIPT_FEATURES = {"cls4k": None, "mean256": "features_mean256",
                 "concat": "features_mean256_cls4k"}
NORMALIZE = {"hipt": hipt_eval_normalize, "imagenet": imagenet_normalize}


def build_encoder(cfg: EncoderConfig, *, device, model: nn.Module = None,
                  state_dict=None, seed: int = 0) -> Encoder:
    """The encoder ``cfg.model_type`` names, on ``device``:

    - HIPT_4K: 4096 px regions -> ``cfg.hipt_features``: cls4k (the ViT-4K
      CLS, 192), mean256 (the mean of the 256 ViT-256 CLS, 384) or concat
      (both, 576);
    - vit256: ViT-256 alone on 256 px patches -> its CLS (384);
    - resnet50 / resnet18: ResNet50-trunc (1024) / ResNet-18 (512) on 256
      px patches, ImageNet-normalized, on all three rungs;
    - levit_128s / levit_256: LeViT (384 / 512) on 224 px patches (larger
      ones centre-cropped), ImageNet-normalized, on the RGB rung only.
      Each name is the architecture it says (the reference's levit_128s
      instantiated levit_256).

    ``model``: a prebuilt model of that kind (tests pass narrow ones, and
    the per-op HIPT configuration enters here); otherwise the full-width
    model at ``cfg.dtype`` (HIPT's and vit256's blocks as the fused block
    kernel, as the JAX package builds them on its accelerator) with seeded
    random weights, unless ``state_dict`` or the checkpoints in ``cfg``
    (vit256_ckpt and vit4k_ckpt: DINO; resnet_ckpt: a reference,
    torchvision or Histo ResNet .pth; levit_ckpt: an original-layout
    LeViT) are given. f32 ResNet convolutions run without TF32 on the
    card (models/resnet.py)."""
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        load_dino_, load_torch_state_dict, load_vit_)
    from hipt_abmil_atec23_tpu_torch.models.levit import (
        levit_state_dict_from_torch, levit_texture_encoder)
    from hipt_abmil_atec23_tpu_torch.models.resnet import (
        load_resnet_, resnet18, resnet50_trunc)
    from hipt_abmil_atec23_tpu_torch.models.vit import vit_small
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(seed)
    normalize, plane_rung, dct_rung = "hipt", True, True
    if cfg.model_type in ("HIPT_4K", "hipt_4k"):
        if cfg.hipt_features not in HIPT_FEATURES:
            raise ValueError(f"hipt_features={cfg.hipt_features!r}: one of "
                             f"{sorted(HIPT_FEATURES)}")
        if model is None:
            model = make_hipt_encoder(dtype, use_fused_block=True,
                                      generator=gen)
            if state_dict is None and cfg.vit256_ckpt and cfg.vit4k_ckpt:
                load_dino_(model, load_torch_state_dict(cfg.vit256_ckpt),
                           load_torch_state_dict(cfg.vit4k_ckpt))
        features = HIPT_FEATURES[cfg.hipt_features]
        input_size = 4096
        feat_dim = {"cls4k": model.feat_dim,
                    "mean256": model.vit256.feat_dim,
                    "concat": model.vit256.feat_dim + model.feat_dim
                    }[cfg.hipt_features]
    elif cfg.model_type == "vit256":
        if model is None:
            model = vit_small(dtype, use_fused_block=True, generator=gen)
            if state_dict is None and cfg.vit256_ckpt:
                load_vit_(model, load_torch_state_dict(cfg.vit256_ckpt))
        features, input_size, feat_dim = None, 256, model.feat_dim
    elif cfg.model_type in ("resnet50", "resnet18"):
        if model is None:
            make = resnet50_trunc if cfg.model_type == "resnet50" \
                else resnet18
            model = make(dtype, generator=gen)
            if state_dict is None and cfg.resnet_ckpt:
                load_resnet_(model, load_torch_state_dict(
                    cfg.resnet_ckpt, checkpoint_key=None))
        features, input_size, feat_dim = None, 256, model.feat_dim
        normalize = "imagenet"
    elif cfg.model_type in ("levit_128s", "levit_256"):
        if model is None:
            model = levit_texture_encoder(cfg.model_type, dtype,
                                          generator=gen)
            if state_dict is None and cfg.levit_ckpt:
                model.load_state_dict(levit_state_dict_from_torch(
                    load_torch_state_dict(cfg.levit_ckpt,
                                          checkpoint_key=None),
                    cfg.model_type))
        features, input_size, feat_dim = None, 224, model.feat_dim
        normalize, plane_rung, dct_rung = "imagenet", False, False
    else:
        raise ValueError(f"unknown encoder {cfg.model_type!r}")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).eval()
    return Encoder(model=model, batch_size=cfg.batch_size,
                   input_size=input_size, feat_dim=feat_dim, device=device,
                   dct_rung=dct_rung, plane_rung=plane_rung,
                   features=features, normalize=normalize)


def _pad_to(batch: np.ndarray, k: int, bs: int) -> np.ndarray:
    """Pad a decoded tail batch of k items up to the encoder's batch."""
    if k < bs:
        pad = np.zeros((bs - k,) + batch.shape[1:], batch.dtype)
        batch = np.concatenate([batch, pad])
    return batch


def _decode_batch(slide, chunk, *, patch_level, size, bs, n_io_threads,
                  use_yuv=None, dct_ctx=None,
                  transform: Optional[Callable] = None,
                  target_patch_size: int = 0):
    """Read one batch of regions, tail-padded to ``bs``. ``dct_ctx`` =
    (qt, caps) tries the sparse-coefficient pack first; any flagged region
    drops the whole chunk to the pixel reads below, never a mixed or
    truncated payload. Then the raw planes when ``use_yuv`` is the slide's
    chroma layout (sh, sv), RGB otherwise or when the plane read refuses
    these coords (odd origins). A resize to ``target_patch_size`` (cv2
    INTER_AREA, reference dataset_h5.py:147-152) and then the host
    ``transform`` apply to RGB only, so either one skips the plane and DCT
    reads (encode_stream gates those rungs off for them already)."""
    k = len(chunk)
    pixels_only = transform is not None or bool(target_patch_size)
    if dct_ctx is not None and not pixels_only:
        qt, caps = dct_ctx
        try:
            r = slide.read_regions_dct(chunk, patch_level, (size, size),
                                       cap_y_pb=caps[0], cap_c_pb=caps[1],
                                       cap_ge_y=caps[2], cap_ge_c=caps[3],
                                       cap_aesc_y=caps[4],
                                       cap_aesc_c=caps[5],
                                       cap_desc_y=caps[6],
                                       cap_desc_c=caps[7],
                                       cap_bm_y=caps[8], cap_bm_c=caps[9],
                                       n_threads=n_io_threads or k)
            if not r.status.any():
                comp = [_pad_to(a, k, bs) for a in r[:27]]
                # escape-index pads must stay -1 (dropped by the device
                # scatter); _pad_to zero-fills, and index 0 is a real slot
                if k < bs:
                    for a in (comp[5], comp[7], comp[14], comp[16],
                              comp[23], comp[25]):
                        a[k:] = -1
                return DctBatch(*comp, np.asarray(qt, np.int32),
                                _pad_to(r.valid, k, bs),
                                _pad_to(r.off, k, bs))
        except (IOError, AttributeError):
            pass  # unreadable through the coefficient path — pixels below
    if use_yuv and not pixels_only:
        try:
            if hasattr(slide, "read_regions_planes"):
                yp, cb, cr = slide.read_regions_planes(
                    chunk, patch_level, (size, size),
                    n_threads=n_io_threads or k, layout=tuple(use_yuv))
            else:
                yp, cb, cr = slide.read_regions_yuv420(
                    chunk, patch_level, (size, size),
                    n_threads=n_io_threads or k)
            return (_pad_to(yp, k, bs), _pad_to(cb, k, bs),
                    _pad_to(cr, k, bs))
        except IOError:
            pass  # odd-aligned coords etc. — the RGB read below
    batch = slide.read_regions(chunk, patch_level, (size, size),
                               n_threads=n_io_threads or k)
    if target_patch_size and target_patch_size != size:
        import cv2
        batch = np.stack([
            cv2.resize(p, (target_patch_size, target_patch_size),
                       interpolation=cv2.INTER_AREA) for p in batch])
    if transform is not None:
        batch = transform(batch)
    return _pad_to(batch, k, bs)


def _batches(coords: np.ndarray, batch: int) -> Iterable[np.ndarray]:
    for i in range(0, len(coords), batch):
        yield coords[i:i + batch]


_AESC_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144)
_DESC_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def _esc_bucket(need, buckets):
    return next((b for b in buckets if b >= need), 4 * buckets[-1])


def _dct_group_fills(bmc, bmb, esc8, bl, n, _G):
    """Per-group demand distributions recovered from a max-cap probe pack
    (nothing spilled there, so shipped == demanded): nonzero-coefficient
    count (value slots), bitmap prefix bytes, and escape bytes. `bl` is the
    pack's actual block count (off-MCU grids pad the geometry)."""
    ng = (bl + _G - 1) // _G
    pl = np.stack([bmc & 0xF, (bmc >> 4) & 0xF],
                  -1).reshape(n, -1)[:, :bl].astype(np.int64)
    pad = ng * _G - bl
    if pad:
        pl = np.pad(pl, ((0, 0), (0, pad)))
    capbm = bmb.shape[-1] // ng
    bits = np.unpackbits(bmb.reshape(n, ng, capbm), axis=-1,
                         bitorder="little")
    gv = bits.reshape(n, ng, capbm * 8).sum(-1).astype(np.int64)
    gb = pl.reshape(n, ng, _G).sum(-1)
    ge = (esc8.reshape(n, ng, -1) != 0).sum(-1).astype(np.int64)
    return gv, gb, ge


def _dct_best_caps(gv, gb, ge, aesc_true, pb_buckets, bm_buckets,
                   ge_buckets, ng, _G):
    """Exact byte-cost argmin over (value, bitmap, escape) group caps for
    one component class. The packer spills any group-budget shortfall to
    the explicit 6-B/slot aesc stream, so the cost of a cap is its fixed
    group padding plus the bucketed explicit stream absorbing the worst
    sampled region's spill (x2 headroom). Returns (pb, bm, geb,
    aesc_cap)."""
    coeff_per_bmbyte = max(1.0, float(gv.sum()) / max(1, gb.sum()))
    sv = {pb: int(np.maximum(gv - pb * _G, 0).sum(-1).max())
          for pb in pb_buckets}
    sb = {bm: int(np.maximum(gb - bm * _G, 0).sum(-1).max() *
                  coeff_per_bmbyte) for bm in bm_buckets}
    se = {geb: int(np.maximum(ge - geb, 0).sum(-1).max())
          for geb in ge_buckets}
    best = None
    for pb in pb_buckets:
        for bm in bm_buckets:
            for geb in ge_buckets:
                spill = sv[pb] + sb[bm] + se[geb]
                aesc = _esc_bucket(int(aesc_true) + spill * 2 + 64,
                                   _AESC_BUCKETS)
                cost = ng * (pb * _G / 2 + bm * _G + geb) + 6 * aesc
                if best is None or cost < best[0]:
                    best = (cost, pb, bm, geb, aesc)
    return best[1], best[2], best[3], best[4]


def probe_dct_caps(slide, coords, patch_level, size):
    """Probe a slide's sparse-DCT pack capacities for a region stream: read
    3 sample regions spread over the slide at maximal caps, recover the
    per-group demand distributions, then pick each group cap by exact
    byte-cost argmin (hot groups spill to the explicit aesc stream).
    Escape and DC capacities are bucketed so every batch in the stream
    shares one shape.

    Returns (caps, bytes_per_px) — caps = (y_pb, c_pb, ge_y, ge_c, aesc_y,
    aesc_c, desc_y, desc_c, bm_y, bm_c) as read_regions_dct takes them,
    bytes_per_px the exact aligned-grid pack size at those caps — or None
    when this slide or grid cannot ride the coefficient path."""
    sample = np.asarray(coords)[
        np.unique(np.linspace(0, len(coords) - 1, 3, dtype=int))]
    try:
        ybl = (size // 8) ** 2
        r = slide.read_regions_dct(
            sample, patch_level, (size, size), cap_y_pb=63,
            cap_c_pb=63, cap_ge_y=63 * _G, cap_ge_c=63 * _G,
            cap_aesc_y=ybl, cap_aesc_c=ybl // 4,
            cap_desc_y=ybl, cap_desc_c=ybl // 4,
            cap_bm_y=8, cap_bm_c=8,
            n_threads=len(sample))
    except (IOError, AttributeError):
        return None
    if r.status.any():
        return None
    cnts = r.cnts  # [n, comp, {nnz, aesc, desc, gvdem, gedem, gbdem}]
    n = len(sample)
    ybl = r.y_dc8.shape[1] * r.y_dc8.shape[2]
    cbl = r.cb_dc8.shape[1] * r.cb_dc8.shape[2]
    ng_y = (ybl + _G - 1) // _G
    ng_c = (cbl + _G - 1) // _G
    gv_y, gb_y, ge_y_f = _dct_group_fills(r.y_bmc, r.y_bmb, r.y_esc8,
                                          ybl, n, _G)
    cb_f = _dct_group_fills(r.cb_bmc, r.cb_bmb, r.cb_esc8, cbl, n, _G)
    cr_f = _dct_group_fills(r.cr_bmc, r.cr_bmb, r.cr_esc8, cbl, n, _G)
    gv_c, gb_c, ge_c_f = (np.concatenate([a, b])
                          for a, b in zip(cb_f, cr_f))

    y_pb, bm_y, geb_y, aesc_y = _dct_best_caps(
        gv_y, gb_y, ge_y_f, cnts[:, 0, 1].max(),
        (4, 8, 12, 16, 24, 32, 48, 63), (2, 3, 4, 5, 6, 7, 8),
        (4, 8, 16, 24, 32, 48, 64, 96, 128, 256), ng_y, _G)
    c_pb, bm_c, geb_c, aesc_c = _dct_best_caps(
        gv_c, gb_c, ge_c_f, cnts[:, 1:, 1].max(),
        (2, 4, 6, 8, 12, 16, 24, 32), (1, 2, 3, 4, 5, 6, 7, 8),
        (2, 4, 8, 16, 24, 32, 48, 64, 128), ng_c, _G)

    desc_y = _esc_bucket(int(cnts[:, 0, 2].max()) * 2 + 64, _DESC_BUCKETS)
    desc_c = _esc_bucket(int(cnts[:, 1:, 2].max()) * 2 + 64, _DESC_BUCKETS)
    caps = (y_pb, c_pb, geb_y, geb_c, aesc_y, aesc_c, desc_y, desc_c,
            bm_y, bm_c)
    # exact per-region wire bytes at these caps (aligned grid; dc8 + bmc
    # = 1.5 B/block, bitmap prefixes bm B/block, nibbles pb/2 B/block,
    # escape bytes ge/_G B/block, explicit escapes 6 B/slot) -> bytes/px
    nb = (ybl * (1.5 + bm_y + y_pb / 2 + geb_y / _G)
          + 2 * cbl * (1.5 + bm_c + c_pb / 2 + geb_c / _G)
          + 6 * (aesc_y + 2 * aesc_c) + 6 * (desc_y + 2 * desc_c))
    return caps, nb / float(size * size)


def _drain_in_order(jobs, feats, remaining, next_yield, feat_dim):
    """Collect (slide_id, feats) for every job complete at the head of the
    job order (empty jobs complete with a zero-row bag); returns (ready,
    advanced cursor)."""
    ready = []
    while next_yield < len(jobs):
        sid, _, coords = jobs[next_yield]
        if len(coords) == 0:
            ready.append((sid, np.zeros((0, feat_dim), np.float32)))
        elif remaining[next_yield] == 0:
            ready.append((sid, feats[next_yield]))
        else:
            break
        next_yield += 1
    return ready, next_yield


def _plane_layout(slide, patch_level: int):
    """(sh, sv) when the slide has a raw-plane read at this level."""
    probe = getattr(slide, "yuv_layout", None)
    if probe is not None:
        return probe(patch_level)
    if getattr(slide, "supports_yuv420", lambda lvl: False)(patch_level):
        return (2, 2)  # duck-typed 4:2:0-only slide classes
    return None


def _kind(buf) -> str:
    return ("dct" if isinstance(buf, DctBatch)
            else "yuv" if isinstance(buf, tuple) else "rgb")


def encode_stream(jobs, encoder: Encoder, *, patch_level: int = 0,
                  region_size: Optional[int] = None,
                  transform: Optional[Callable] = None,
                  target_patch_size: int = 0, n_io_threads: int = 0,
                  prefetch: int = 3, stage: bool = False,
                  stage_budget_bytes: int = 6 << 30,
                  stats: Optional[dict] = None, adaptive_rungs: bool = True,
                  wire_mbps_hint: Optional[float] = None,
                  pace_put_mbps: Optional[float] = None):
    """Encode a sequence of slides through one continuous pipeline.

    ``jobs``: (slide_id, slide, coords) triples. Yields (slide_id,
    feats [N, D] f32) in job order as each slide's last batch completes.
    The decode window and the H2D stream run across slide boundaries, so the
    device does not drain between slides.

    On a CUDA encoder the decode worker pins each batch; the main loop
    issues its H2D on a dedicated copy stream, makes the current stream
    wait on that copy's event, dispatches the encoder and the D2H of its
    features there, and only then collects the previous batch, so batch
    i+1's transfer overlaps batch i's compute. On a CPU encoder the same
    loop runs without pinning or streams.

    ``stage``: every batch is decoded and copied to the device first, up to
    ``stage_budget_bytes`` of batch bytes per flush (at least one batch);
    each flush then dispatches its computes back to back, makes one D2H of
    their concatenated features and yields what it completed. The staged
    device buffers are released as the flush queues their computes.

    ``transform`` (uint8 batch -> uint8 batch, ops/augment.py) and
    ``target_patch_size`` (a resize before the encoder; equal to the
    region size it is no resize) run on the decode worker on RGB, so
    either one keeps every batch on the RGB rung.

    ``adaptive_rungs``: pick each batch's rung with ``select_rung`` at the
    measured wire rate and the stream's EWMA-calibrated host and device
    tables. The wire rate starts at ``wire_mbps_hint`` and then follows an
    EWMA of the H2D copies timed with CUDA events; until an estimate
    exists, and on an unpaced CPU encoder (no copy to time), the
    byte-lightest feasible rung is used.

    ``pace_put_mbps``: a measurement shim that throttles the H2D to this
    rate (MB/s), to reproduce a slow link on a fast one. A batch is handed
    to compute only once its byte budget at that rate has elapsed since its
    copy was issued (the host waits for the copy, then sleeps the rest),
    and that paced time, not the copy's, is the wire sample, so the EWMA
    and the selector see the throttled rate as they would a slow wire; on
    a CPU encoder the paced sample is taken too. None (the default) leaves
    the stream unthrottled; never set in production.

    ``stats`` (a dict) receives ``rung_decisions`` ([batch, rung, MB/s] on
    each change), ``regions_{dct,yuv,rgb}``, ``h2d_bytes``, ``dct_caps``,
    the live ``rung_calibration`` tables, every ``wire_mbps_samples``,
    ``wire_mbps_final`` and, staged, ``stage_flushes``.
    """
    size = region_size or encoder.input_size
    if target_patch_size == size:
        target_patch_size = 0  # no resize, so the plane rungs stay open
    pixels_only = transform is not None or bool(target_patch_size)
    bs = encoder.batch_size
    dev = encoder.device
    cuda = dev.type == "cuda"
    jobs = list(jobs)

    dct_caps = None
    dct_bpp = None  # measured wire bytes/px of the dct rung at these caps

    def _probe_caps(slide, coords):
        nonlocal dct_caps, dct_bpp
        if dct_caps is None:
            probed = probe_dct_caps(slide, coords, patch_level, size)
            if probed is None:
                dct_caps = False
            else:
                dct_caps, dct_bpp = probed

    items = []
    for ji, (sid, slide, coords) in enumerate(jobs):
        use_yuv = (_plane_layout(slide, patch_level)
                   if encoder.plane_rung and size % 2 == 0
                   and not pixels_only else None)
        dct_ctx = None
        if (encoder.dct_rung and not pixels_only and size % 16 == 0
                and len(coords) > 0):
            ds = slide.level_downsamples[patch_level]
            lvl = np.stack([(np.asarray(coords)[:, 0] / ds[0]),
                            (np.asarray(coords)[:, 1] / ds[1])],
                           axis=1).astype(np.int64)
            if not (lvl % 2).any():  # even grid: the reader aligns to the
                # 16 px MCU lattice and the device crops
                qt = getattr(slide, "dct_probe",
                             lambda lvl: None)(patch_level)
                if qt is not None:
                    _probe_caps(slide, coords)
                    if dct_caps:
                        dct_ctx = (qt, dct_caps)
        for chunk in _batches(coords, bs):
            items.append((ji, slide, chunk, use_yuv, dct_ctx))
    feats = [np.empty((len(c), encoder.feat_dim), np.float32)
             for _, _, c in jobs]
    remaining = [max(1, -(-len(c) // bs)) for _, _, c in jobs]
    offs = [0] * len(jobs)
    if not items:
        for sid, _, c in jobs:
            yield sid, np.zeros((0, encoder.feat_dim), np.float32)
        return

    # live wire-rate estimate (MB/s), seeded by the caller's hint, and the
    # selector's stage-cost tables, EWMA-calibrated in place from this
    # stream's own measurements
    link = {"mbps": wire_mbps_hint, "rung": None, "batch": 0,
            "host_ms_mpx": dict(RUNG_HOST_MS_PER_MPX),
            "dev_ms_mpx": dict(RUNG_DEV_MS_PER_MPX)}
    if stats is not None:
        stats["rung_calibration"] = {"host_ms_mpx": link["host_ms_mpx"],
                                     "dev_ms_mpx": link["dev_ms_mpx"]}

    def _ewma(table, rung, sample_ms_mpx, w=0.3):
        table[rung] = (1.0 - w) * table[rung] + w * sample_ms_mpx

    def read_batch(item):
        _, slide, chunk, use_yuv, dct_ctx = item
        if adaptive_rungs and link["mbps"] and (use_yuv or dct_ctx):
            feasible = ["rgb"] + (["yuv"] if use_yuv else []) \
                + (["dct"] if dct_ctx is not None else [])
            yuv_bpp = (1.0 + 2.0 / (use_yuv[0] * use_yuv[1])
                       if isinstance(use_yuv, tuple) else None)
            rung, _ = select_rung(feasible, link["mbps"], size * size,
                                  dct_bytes_per_px=dct_bpp,
                                  current=link["rung"],
                                  host_ms_mpx=link["host_ms_mpx"],
                                  dev_ms_mpx=link["dev_ms_mpx"],
                                  yuv_bytes_per_px=yuv_bpp)
            if rung != "dct":
                dct_ctx = None
            if rung == "rgb":
                use_yuv = None
            if stats is not None and rung != link["rung"]:
                stats.setdefault("rung_decisions", []).append(
                    [link["batch"], rung, round(link["mbps"], 1)])
            link["rung"] = rung
        link["batch"] += 1
        td0 = time.perf_counter()
        buf = _decode_batch(slide, chunk, patch_level=patch_level, size=size,
                            bs=bs, n_io_threads=n_io_threads, use_yuv=use_yuv,
                            dct_ctx=dct_ctx, transform=transform,
                            target_patch_size=target_patch_size)
        # host-decode calibration, billed to the rung the batch actually
        # rode (a cap-overflow fallback bills the pixels it shipped)
        kind = _kind(buf)
        _ewma(link["host_ms_mpx"], kind,
              (time.perf_counter() - td0) * 1e3
              / (len(chunk) * size * size / 1e6))
        leaves = buf if isinstance(buf, tuple) else (buf,)
        if stats is not None:
            stats["h2d_bytes"] = (stats.get("h2d_bytes", 0)
                                  + sum(a.nbytes for a in leaves))
            stats[f"regions_{kind}"] = (stats.get(f"regions_{kind}", 0)
                                        + len(chunk))
            if dct_caps:
                stats["dct_caps"] = dct_caps
        host = tuple(torch.from_numpy(a) for a in leaves)
        if cuda:
            host = tuple(t.pin_memory() for t in host)
        return kind, host

    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def timer():
        return torch.cuda.Event(enable_timing=True)

    def to_device(host):
        """(device tensors, wire sample): (start, end, bytes) CUDA events
        around the copy, (seconds, bytes) of a paced copy, or None on an
        unpaced CPU encoder."""
        nbytes = sum(t.nbytes for t in host)
        issued = time.perf_counter()
        on_dev, wire = host, None
        if cuda:
            compute = torch.cuda.current_stream(dev)
            t0, t1 = timer(), timer()
            with torch.cuda.stream(copy_stream):
                t0.record(copy_stream)
                on_dev = tuple(t.to(dev, non_blocking=True) for t in host)
                t1.record(copy_stream)
            compute.wait_event(t1)
            for t in on_dev:  # allocated on the copy stream, read on compute
                t.record_stream(compute)
            wire = (t0, t1, nbytes)
        if pace_put_mbps:
            if cuda:
                t1.synchronize()
            deficit = nbytes / 1e6 / pace_put_mbps - (time.perf_counter()
                                                      - issued)
            if deficit > 0:
                time.sleep(deficit)
            wire = (time.perf_counter() - issued, nbytes)
        return on_dev, wire

    def run(kind, bufs):
        """Dispatch the encoder; returns (out, device-time handle)."""
        fn = (encoder.apply_dct if kind == "dct"
              else encoder.apply_yuv if kind == "yuv" else encoder.apply)
        if not cuda:
            t = time.perf_counter()
            return fn(*bufs), time.perf_counter() - t
        compute = torch.cuda.current_stream(dev)
        t0, t1 = timer(), timer()
        t0.record(compute)
        out = fn(*bufs)
        t1.record(compute)
        return out, (t0, t1)

    def to_host(out):
        # D2H queued right behind the compute, into pinned memory, so
        # collecting it later never waits on the batch queued after it
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return host, done

    def calibrate(kind, dev_t, wire):
        """Feed a completed batch's device time and wire sample to the
        EWMAs (its events have fired, so this never syncs)."""
        dev_s = dev_t if not cuda else dev_t[0].elapsed_time(dev_t[1]) / 1e3
        _ewma(link["dev_ms_mpx"], kind,
              dev_s * 1e3 / (bs * size * size / 1e6))
        if wire is not None:
            secs = (wire[0] if len(wire) == 2
                    else wire[0].elapsed_time(wire[1]) / 1e3)
            inst = wire[-1] / 1e6 / max(secs, 1e-9)
            link["mbps"] = (inst if link["mbps"] is None
                            else 0.7 * link["mbps"] + 0.3 * inst)
            if stats is not None:
                stats.setdefault("wire_mbps_samples", []).append(inst)

    def store(ji, k, rows):
        feats[ji][offs[ji]:offs[ji] + k] = rows[:k]
        offs[ji] += k
        remaining[ji] -= 1

    def collect(pend):
        ji, k, kind, host, done, dev_t, wire = pend
        if done is not None:
            done.synchronize()
        store(ji, k, host.float().numpy())
        calibrate(kind, dev_t, wire)

    def flush(staged):
        """Dispatch every staged batch's compute back to back, then one
        D2H of their concatenated features; each staged device batch is
        dropped as its compute is queued (record_stream keeps its memory
        until that compute has run)."""
        outs = []
        for rec in staged:
            outs.append(run(rec[2], rec[3]))
            rec[3] = None
        host, done = to_host(torch.cat([o for o, _ in outs]))
        if done is not None:
            done.synchronize()
        flat = host.float().numpy()
        for i, ((ji, k, kind, _, wire), (_, dev_t)) in enumerate(
                zip(staged, outs)):
            store(ji, k, flat[i * bs:(i + 1) * bs])
            calibrate(kind, dev_t, wire)
        staged.clear()
        if stats is not None:
            stats["stage_flushes"] = stats.get("stage_flushes", 0) + 1

    window = max(1, prefetch)
    next_yield = 0

    def drain():
        nonlocal next_yield
        ready, next_yield = _drain_in_order(jobs, feats, remaining,
                                            next_yield, encoder.feat_dim)
        return ready

    # ONE decode worker: read_regions parallelises internally; the window
    # is prefetch depth, not decode concurrency
    ex = ThreadPoolExecutor(max_workers=1)
    futures = [ex.submit(read_batch, it) for it in items[:window]]

    def next_batch(ci):
        kind, host = futures[ci].result()
        futures[ci] = None  # the pinned batch is freed with its last user
        if ci + window < len(items):
            futures.append(ex.submit(read_batch, items[ci + window]))
        return kind, host

    try:
        if stage:
            staged, held = [], 0
            for ci, (ji, _, chunk, _, _) in enumerate(items):
                kind, host = next_batch(ci)
                bufs, wire = to_device(host)
                held += sum(t.nbytes for t in host)
                staged.append([ji, len(chunk), kind, bufs, wire])
                del host, bufs
                if held >= stage_budget_bytes:
                    flush(staged)
                    held = 0
                    yield from drain()
            if staged:
                flush(staged)
            yield from drain()
        else:
            pending = None
            for ci, (ji, _, chunk, _, _) in enumerate(items):
                kind, host = next_batch(ci)
                bufs, wire = to_device(host)
                del host
                out, dev_t = run(kind, bufs)
                del bufs
                if pending is not None:
                    collect(pending)
                    yield from drain()
                pending = (ji, len(chunk), kind, *to_host(out), dev_t, wire)
            collect(pending)
            yield from drain()
        if stats is not None:
            stats["wire_mbps_final"] = link["mbps"]
    finally:
        # runs on completion and on abandonment (GeneratorExit / consumer
        # exception). wait=True: an in-flight native read still holds the
        # slide handles the caller closes the moment this returns;
        # cancel_futures drops the batches not yet started.
        ex.shutdown(wait=True, cancel_futures=True)


def encode_slide(slide, coords: np.ndarray, encoder: Encoder, *,
                 patch_level: int = 0, region_size: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 target_patch_size: int = 0, n_io_threads: int = 0,
                 prefetch: int = 3) -> np.ndarray:
    """Encode all coords of one slide -> [N, D] features (a one-slide
    encode_stream)."""
    out = dict(encode_stream([("_solo", slide, coords)], encoder,
                             patch_level=patch_level,
                             region_size=region_size, transform=transform,
                             target_patch_size=target_patch_size,
                             n_io_threads=n_io_threads, prefetch=prefetch))
    return out["_solo"]


def encode_and_store(slide_path: str, coords_h5: str, encoder: Encoder,
                     store, slide_id: str, *, formats=("h5", "pt"),
                     skip_existing: bool = True,
                     transform: Optional[Callable] = None,
                     target_patch_size: int = 0) -> Optional[str]:
    """One slide's encode stage with idempotent resume (the reference skips
    slides whose pt exists, extract_features_fp.py:231-238): coords and
    geometry from the coords h5 (slideio/patching.py), features into
    ``store`` (data/bags.FeatureBagStore). Returns the written path, or
    None when the slide was already stored."""
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide

    if skip_existing and store.exists(slide_id):
        return None
    coords, attrs = load_coords_h5(coords_h5)
    slide = open_slide(slide_path)
    try:
        feats = encode_slide(slide, coords, encoder,
                             patch_level=int(attrs.get("patch_level", 0)),
                             region_size=int(attrs.get("patch_size",
                                                       encoder.input_size)),
                             transform=transform,
                             target_patch_size=target_patch_size)
    finally:
        slide.close()
    store.save(slide_id, feats, coords=coords, formats=formats)
    return (store.pt_path(slide_id) if "pt" in formats
            else store.h5_path(slide_id))


ENCODE_GROUP = 8  # slides per stream, and so the open slide handles bound


def encode_many(jobs, encoder: Encoder, store, *, formats=("h5", "pt"),
                skip_existing: bool = True,
                transform: Optional[Callable] = None,
                target_patch_size: int = 0, verbose: bool = True,
                stage: bool = False):
    """The slide-level pipelined encode stage. ``jobs``: (slide_path,
    coords_h5, slide_id) triples.

    Slides stream in groups of ``ENCODE_GROUP`` through encode_stream
    (consecutive slides of one patch level and size share a stream), so
    the device drains once per group, not per slide. While a group streams,
    a thread opens the next group's slides and coords, and a writer thread
    persists each finished slide's bag (h5 + pt). Returns ``(done,
    failed)``: the slide ids encoded, and (slide_id, exception) for each
    slide whose open or coords load failed; such a slide never stops the
    stage. On any exception every open handle is closed (the prefetched
    group's too) and every queued write is flushed, so each slide reported
    done is on disk; the first write error is raised after the loop."""
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide

    todo = []
    for path, h5, sid in jobs:
        if skip_existing and store.exists(sid):
            if verbose:
                print(f"[encode] {sid}: skipped (exists)")
            continue
        todo.append((path, h5, sid))
    if not todo:
        return [], []

    def _open_group(chunk):
        # per-slide isolation: one unreadable slide or h5 neither leaks the
        # group's open handles nor aborts the stage
        out = []
        for path, h5, sid in chunk:
            try:
                coords, attrs = load_coords_h5(h5)
                out.append((sid, open_slide(path), coords, attrs))
            except Exception as e:
                out.append((sid, None, None, e))
        return out

    write_q: "queue.Queue" = queue.Queue(maxsize=4)
    write_err = []

    def _writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            sid, feats, coords = item
            try:
                store.save(sid, feats, coords=coords, formats=formats)
            except Exception as e:  # raised after the loop
                write_err.append((sid, e))

    wt = threading.Thread(target=_writer, daemon=True)
    wt.start()
    done, failed = [], []
    groups = [todo[i:i + ENCODE_GROUP]
              for i in range(0, len(todo), ENCODE_GROUP)]
    open_handles = []   # every open slide not yet closed

    def _close(slide):
        try:
            slide.close()
        except Exception:
            pass
        if slide in open_handles:
            open_handles.remove(slide)

    openex = ThreadPoolExecutor(max_workers=1)
    nxt = openex.submit(_open_group, groups[0])
    try:
        for gi in range(len(groups)):
            opened = nxt.result()
            open_handles.extend(s for _, s, _, _ in opened if s is not None)
            nxt = (openex.submit(_open_group, groups[gi + 1])
                   if gi + 1 < len(groups) else None)
            # consecutive same-geometry slides share one stream (patch
            # level and size are per-slide h5 attrs)
            runs = []
            for sid, slide, coords, attrs in opened:
                if slide is None:
                    failed.append((sid, attrs))
                    if verbose:
                        print(f"[encode] {sid}: FAILED to open ({attrs!r})")
                    continue
                geo = (int(attrs.get("patch_level", 0)),
                       int(attrs.get("patch_size", encoder.input_size)))
                if runs and runs[-1][0] == geo:
                    runs[-1][1].append((sid, slide, coords))
                else:
                    runs.append((geo, [(sid, slide, coords)]))
            for (lvl, size), sjobs in runs:
                coords_by_sid = {sid: c for sid, _, c in sjobs}
                try:
                    for sid, feats in encode_stream(
                            sjobs, encoder, patch_level=lvl,
                            region_size=size, transform=transform,
                            target_patch_size=target_patch_size,
                            stage=stage):
                        write_q.put((sid, feats, coords_by_sid[sid]))
                        done.append(sid)
                        if verbose:
                            print(f"[encode] {sid}: done "
                                  f"({len(coords_by_sid[sid])} patches)")
                finally:
                    for _, slide, _ in sjobs:
                        _close(slide)
    finally:
        if nxt is not None:
            try:
                open_handles.extend(
                    s for _, s, _, _ in nxt.result() if s is not None)
            except Exception:
                pass
        openex.shutdown(wait=True)
        for slide in list(open_handles):
            _close(slide)
        write_q.put(None)
        wt.join()
    if write_err:
        sid, e = write_err[0]
        raise IOError(f"failed writing features for {sid}: {e}")
    return done, failed
