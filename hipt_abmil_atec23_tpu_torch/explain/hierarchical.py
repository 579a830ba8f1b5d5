"""Hierarchical and patch-level ViT attention galleries (blended PNGs).

Counterpart of hipt_abmil_atec23_tpu/explain/hierarchical.py, with the
reference's gallery code behind it:
- patch galleries: create_patch_heatmaps_indiv / _concat
  (reference: HIPT_4K/hipt_heatmap_utils.py:158-294)
- hierarchical galleries: create_hierarchical_heatmaps_indiv / _concat /
  _concat_select (reference: hipt_heatmap_utils.py:347-664)
- region heatmap lists: HIPT_4K.get_region_attention_heatmaps
  (reference: HIPT_4K/hipt_4k.py:167-305)

All shifted variants of a region go through one ``HIPT4K.region_attention``
call on the model's device; only the CLS rows of the probabilities
(``attn[:, :, 0, 1:]``, [T, heads, 16, 16] per variant) come back to the
host, as f32. The rank, colormap and blend work is the JAX package's
numpy and OpenCV code, with the port's colour tables
(explain/colormaps.py), so equal CLS maps give equal uint8 galleries.

As in the JAX package (its divergence #7, docs/COMPONENT_MAP.md), the
shifted variants are true shifted re-encodes, each padded by exactly k *
offset, where the reference re-encodes the unshifted region
(hipt_4k.py:196-199) and pads its third shift by 4 * offset
(hipt_heatmap_utils.py:515-516).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.explain.colormaps import (
    get_cmap, light_jet_cmap)
from hipt_abmil_atec23_tpu_torch.explain.heatmaps import model_device
from hipt_abmil_atec23_tpu_torch.models.hipt import hipt_eval_normalize


# --------------------------------------------------------------------------
# Small image helpers (reference: hipt_heatmap_utils.py:105-155)
# --------------------------------------------------------------------------

def shift_pad(img: np.ndarray, off: int, fill: int = 255) -> np.ndarray:
    """Crop `off` px from top-left, pad bottom-right back to size with white
    (reference: add_margin(region.crop(...)), hipt_heatmap_utils.py:511-516)."""
    h, w = img.shape[:2]
    out = np.full_like(img, fill)
    out[: h - off, : w - off] = img[off:, off:]
    return out


def concat_images(imgs: Sequence[np.ndarray], how: str = "horizontal",
                  gap: int = 0, fill: int = 255) -> np.ndarray:
    """Concatenate uint8 RGB images (reference: getConcatImage,
    hipt_heatmap_utils.py:107-142)."""
    if how == "horizontal":
        h = max(im.shape[0] for im in imgs)
        w = sum(im.shape[1] for im in imgs) + gap * (len(imgs) - 1)
        out = np.full((h, w, 3), fill, np.uint8)
        x = 0
        for im in imgs:
            out[: im.shape[0], x: x + im.shape[1]] = im
            x += im.shape[1] + gap
        return out
    h = sum(im.shape[0] for im in imgs) + gap * (len(imgs) - 1)
    w = max(im.shape[1] for im in imgs)
    out = np.full((h, w, 3), fill, np.uint8)
    y = 0
    for im in imgs:
        out[y: y + im.shape[0], : im.shape[1]] = im
        y += im.shape[0] + gap
    return out


def _label(img: np.ndarray, text: str) -> np.ndarray:
    """Caption strip above an image (stands in for the reference's
    FreeMono-font canvas text, hipt_heatmap_utils.py:570-576)."""
    import cv2
    strip = np.full((40, img.shape[1], 3), 255, np.uint8)
    cv2.putText(strip, text, (8, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 0, 0), 2, cv2.LINE_AA)
    return np.concatenate([strip, img], axis=0)


# --------------------------------------------------------------------------
# Score math (reference: concat_scores256/4k, get_scores256,
# attention_visualization_utils.py / hipt_heatmap_utils.py:39-66)
# --------------------------------------------------------------------------

def _rank100(v: np.ndarray) -> np.ndarray:
    from scipy.stats import rankdata
    return rankdata(v.ravel()) * 100.0 / v.size


def concat_scores256(tile_maps: np.ndarray, gh: int, gw: int,
                     tile_px: int) -> np.ndarray:
    """Per-tile rank-percentile maps assembled into the region grid.
    tile_maps: [T, 16, 16] one head's CLS->patch maps. Returns
    [gh*tile_px, gw*tile_px] in 0..100."""
    f = tile_px // 16
    blocks = []
    for t in range(tile_maps.shape[0]):
        m = np.repeat(np.repeat(tile_maps[t], f, axis=0), f, axis=1)
        blocks.append(_rank100(m).reshape(tile_px, tile_px))
    rows = [np.concatenate(blocks[r * gw:(r + 1) * gw], axis=1)
            for r in range(gh)]
    return np.concatenate(rows, axis=0)


def concat_scores4k(grid_map: np.ndarray, out_hw: Tuple[int, int]
                    ) -> np.ndarray:
    """Region-level rank-percentile map. grid_map: [gh, gw] one head's
    CLS->tile attention. Returns [H, W] in 0..100."""
    h, w = out_hw
    fy, fx = h // grid_map.shape[0], w // grid_map.shape[1]
    up = np.repeat(np.repeat(grid_map, fy, axis=0), fx, axis=1)
    return _rank100(up).reshape(h, w)


def shift_average(scores: List[np.ndarray], offsets: List[int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Average shifted score maps over their overlap counters
    (reference: hipt_heatmap_utils.py:420-437). scores[k] is the map of the
    variant shifted by offsets[k] (offsets[0] == 0); each contributes weight
    100 where it has coverage. Returns (score in 0..1, overlay weights)."""
    h, w = scores[0].shape
    total = scores[0].copy()
    overlay = np.full((h, w), 100.0)
    for sc, off in zip(scores[1:], offsets[1:]):
        shifted = np.zeros_like(sc)
        shifted[off:, off:] = sc[: h - off, : w - off]
        total += shifted
        overlay[off:, off:] += 100.0
    return total / overlay, overlay


def blend(score01: np.ndarray, base: np.ndarray, alpha: float,
          cmap) -> np.ndarray:
    """cmap + cv2.addWeighted blend (reference: hipt_heatmap_utils.py:440)."""
    import cv2
    color = (cmap(np.clip(score01, 0.0, 1.0))[:, :, :3] * 255).astype(np.uint8)
    return cv2.addWeighted(color, alpha, base, 1 - alpha, 0)


def threshold_blend(score01: np.ndarray, base: np.ndarray, threshold: float,
                    alpha: float, cmap) -> np.ndarray:
    """Thresholded map: scores above `threshold` blend at a fixed 0.95 cmap
    level, the rest shows raw H&E (reference: hipt_heatmap_utils.py:396-407)."""
    mask = np.where(score01 < threshold, 0.0, 0.95)
    hm = blend(mask, base, alpha, cmap)
    hm[mask == 0] = 0
    inverse = base.copy()
    inverse[mask == 0.95] = 0
    return hm + inverse


# --------------------------------------------------------------------------
# Attention extraction: one device call for all shifted variants
# --------------------------------------------------------------------------

def _on_device(model, images_u8: np.ndarray) -> torch.Tensor:
    """uint8 images to the model's device, normalised there."""
    return hipt_eval_normalize(torch.from_numpy(
        np.ascontiguousarray(images_u8)).to(model_device(model)))


def region_attention_cls_maps(model, regions_u8: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """regions_u8 [R, H, W, 3] uint8 (H, W multiples of 256) -> (cls256
    [R, T, h256, 16, 16], cls4k [R, h4k, gh, gw]) f32 CLS-attention maps of
    a models.hipt.HIPT4K, from one region_attention call on the model's
    device (the reference does one region at a time with a host bounce,
    hipt_4k.py:121-164). Only the CLS rows leave the device."""
    r, h, w, _ = regions_u8.shape
    gh, gw = h // 256, w // 256
    with torch.inference_mode():
        attn256, attn4k = model.region_attention(_on_device(model,
                                                            regions_u8))
        c256 = attn256[:, :, 0, 1:]                      # [R*T, h256, 256]
        c256 = c256.reshape(r, gh * gw, c256.shape[1], 16, 16)
        c4k = attn4k[:, :, 0, 1:1 + gh * gw].reshape(r, -1, gh, gw)
        return (c256.float().cpu().numpy(), c4k.float().cpu().numpy())


def _resize(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    import cv2
    return cv2.resize(img, wh, interpolation=cv2.INTER_AREA)


# --------------------------------------------------------------------------
# Region (4096^2) hierarchical heatmaps
# --------------------------------------------------------------------------

def region_attention_heatmaps(
    region_u8: np.ndarray,
    model,
    *,
    offset: int = 128,
    scale: int = 4,
    alpha: float = 0.5,
    cmap=None,
    threshold: Optional[float] = None,
    weight256: float = 1.0,
) -> Dict[str, List[np.ndarray]]:
    """Shift-averaged hierarchical heatmaps for one region of a
    models.hipt.HIPT4K (reference intent: HIPT_4K.get_region_attention_
    heatmaps, hipt_4k.py:167-305, with true shifted re-encodes).

    Returns dict with lists of uint8 RGB images:
      'hm4k'      one per ViT-4K head (4-variant shift-averaged)
      'hm256'     one per ViT-256 head (2-variant shift-averaged)
      'hm4k_256'  factorized blend per (4k-head, 256-head) pair
      'th256'     thresholded 256 maps (only when threshold is not None)

    weight256: relative overlay weight of the 256 level in the factorized
    combine (1.0 = hipt_4k.py:289 semantics; 2.0 = the gallery variant,
    hipt_heatmap_utils.py:556-558).
    """
    if cmap is None:
        cmap = light_jet_cmap()
    h, w = region_u8.shape[:2]
    gh, gw = h // 256, w // 256
    hs, ws = h // scale, w // scale
    tile_px = 256 // scale

    variants = np.stack([shift_pad(region_u8, k * offset) for k in range(4)])
    c256, c4k = region_attention_cls_maps(model, variants)
    n_h256, n_h4k = c256.shape[2], c4k.shape[1]
    base = _resize(region_u8, (ws, hs))
    offs = [k * offset // scale for k in range(4)]

    out: Dict[str, List[np.ndarray]] = {"hm4k": [], "hm256": [],
                                        "hm4k_256": [], "th256": []}
    score4k_avg, overlay4k = [], None
    for j in range(n_h4k):
        maps = [concat_scores4k(c4k[k, j], (hs, ws)) for k in range(4)]
        s, overlay4k = shift_average(maps, offs)
        score4k_avg.append(s)
        out["hm4k"].append(blend(s, base, alpha, cmap))

    score256_avg, overlay256 = [], None
    for i in range(n_h256):
        maps = [concat_scores256(c256[k, :, i], gh, gw, tile_px)
                for k in range(2)]  # 256 level averages 2 variants (ref :389)
        s, overlay256 = shift_average(maps, offs[:2])
        score256_avg.append(s)
        out["hm256"].append(blend(s, base, alpha, cmap))
        if threshold is not None:
            out["th256"].append(
                threshold_blend(s, base, threshold, alpha, cmap))

    o4k = overlay4k
    o256 = overlay256 * weight256
    for j in range(n_h4k):
        for i in range(n_h256):
            score = ((score4k_avg[j] * o4k + score256_avg[i] * o256)
                     / (o4k + o256))
            out["hm4k_256"].append(blend(score, base, alpha, cmap))
    return out


def _save_png(output_dir: str, img: np.ndarray, name: str) -> str:
    import cv2
    path = os.path.join(output_dir, name)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return path


def hierarchical_gallery(
    region_u8: np.ndarray,
    model,
    output_dir: str,
    fname: str,
    *,
    mode: str = "indiv",
    offset: int = 128,
    scale: int = 4,
    alpha: float = 0.5,
    cmap=None,
    threshold: Optional[float] = None,
    select_4k: Sequence[int] = (0, 5),
    select_256: Sequence[int] = (2,),
) -> List[str]:
    """Save a hierarchical heatmap gallery for one region. Modes mirror the
    reference's three functions (hipt_heatmap_utils.py:347/:488/:584):

      'indiv'         — every map as its own PNG
      'concat'        — one labeled 2x2 canvas (H&E | 4k / 256 | factorized)
                        per (4k-head, 256-head) pair
      'concat_select' — one canvas over select_4k x select_256 heads

    Returns the list of written paths."""
    if cmap is None:
        cmap = light_jet_cmap()
    os.makedirs(output_dir, exist_ok=True)
    # all three gallery modes weight the 256 level 2x in the factorized
    # combine (reference: hipt_heatmap_utils.py:475-477 indiv, :556-558
    # concat), unlike hipt_4k.py:289's 1x
    maps = region_attention_heatmaps(
        region_u8, model, offset=offset, scale=scale, alpha=alpha,
        cmap=cmap, threshold=threshold, weight256=2.0)
    hs, ws = maps["hm4k"][0].shape[:2]
    base = _resize(region_u8, (ws, hs))
    n4k, n256 = len(maps["hm4k"]), len(maps["hm256"])

    def _save(img, name):
        return _save_png(output_dir, img, name)

    written = []
    if mode == "indiv":
        for j, img in enumerate(maps["hm4k"]):
            written.append(_save(img, f"{fname}_4k[{j}].png"))
        for i, img in enumerate(maps["hm256"]):
            written.append(_save(img, f"{fname}_256[{i}].png"))
        for i, img in enumerate(maps["th256"]):
            written.append(_save(img, f"{fname}_256th[{i}].png"))
        for j in range(n4k):
            for i in range(n256):
                written.append(_save(maps["hm4k_256"][j * n256 + i],
                                     f"{fname}_factorized_4k[{j}]_256[{i}].png"))
        return written

    if mode == "concat":
        pairs = [(j, i) for j in range(n4k) for i in range(n256)]
    elif mode == "concat_select":
        pairs = [(j, i) for j in select_4k for i in select_256]
    else:
        raise ValueError(f"unknown gallery mode {mode!r}")

    if mode == "concat_select":
        # one canvas: row 0 = H&E + selected 4k heads; following rows =
        # selected 256 head + factorized cells (reference :584-664)
        top = [_label(base, "H&E")] + \
            [_label(maps["hm4k"][j], f"ViT-4K head {j}") for j in select_4k]
        rows = [concat_images(top)]
        for i in select_256:
            row = [_label(maps["hm256"][i], f"ViT-256 head {i}")] + \
                [_label(maps["hm4k_256"][j * n256 + i], f"4k[{j}]x256[{i}]")
                 for j in select_4k]
            rows.append(concat_images(row))
        written.append(_save(concat_images(rows, how="vertical"),
                             f"{fname}_heatmap.png"))
        return written

    for j, i in pairs:
        canvas = concat_images([
            concat_images([_label(base, "H&E"),
                           _label(maps["hm4k"][j], f"ViT-4K head {j}")]),
            concat_images([_label(maps["hm256"][i], f"ViT-256 head {i}"),
                           _label(maps["hm4k_256"][j * n256 + i],
                                  "factorized")]),
        ], how="vertical")
        written.append(_save(canvas, f"{fname}_4k[{j}]_256[{i}].png"))
    return written


# --------------------------------------------------------------------------
# Patch (256^2) galleries
# --------------------------------------------------------------------------

def patch_attention_cls_maps(vit256, patches_u8: np.ndarray) -> np.ndarray:
    """[P, 256, 256, 3] uint8 -> [P, heads, 16, 16] f32 CLS-attention maps
    of a models.vit.VisionTransformer, one get_last_selfattention call on
    the model's device (reference: get_patch_attention_scores,
    attention_visualization_utils.py)."""
    with torch.inference_mode():
        attn = vit256.get_last_selfattention(_on_device(vit256, patches_u8))
        cls = attn[:, :, 0, 1:].reshape(len(patches_u8), -1, 16, 16)
        return cls.float().cpu().numpy()


def patch_gallery(
    patch_u8: np.ndarray,
    vit256,
    output_dir: str,
    fname: str,
    *,
    mode: str = "indiv",
    threshold: Optional[float] = 0.5,
    offset: int = 16,
    alpha: float = 0.5,
    cmap=None,
) -> List[str]:
    """Patch-level attention heatmap gallery for one 256^2 patch
    (reference: create_patch_heatmaps_indiv/_concat,
    hipt_heatmap_utils.py:158-294): per-head rank-percentile CLS maps,
    2-variant shift-averaged (original + offset-shifted white-padded copy),
    blended over the H&E; optional thresholded maps. mode 'concat' packs the
    heads into one 2x3 canvas per map family."""
    if cmap is None:
        cmap = get_cmap("coolwarm")
    os.makedirs(output_dir, exist_ok=True)
    s = patch_u8.shape[0]
    variants = np.stack([patch_u8, shift_pad(patch_u8, offset)])
    cls = patch_attention_cls_maps(vit256, variants)  # [2, h, 16, 16]
    n_heads = cls.shape[1]

    def head_score(i):
        maps = [_rank100(np.repeat(np.repeat(cls[k, i], s // 16, 0),
                                   s // 16, 1)).reshape(s, s)
                for k in range(2)]
        score, _ = shift_average(maps, [0, offset])
        return score

    def _save(img, name):
        return _save_png(output_dir, img, name)

    hms = [blend(head_score(i), patch_u8, alpha, cmap) for i in range(n_heads)]
    ths = [] if threshold is None else \
        [threshold_blend(head_score(i), patch_u8, threshold, alpha, cmap)
         for i in range(n_heads)]

    written = []
    if mode == "indiv":
        for i, img in enumerate(hms):
            written.append(_save(img, f"{fname}_256[{i}].png"))
        for i, img in enumerate(ths):
            written.append(_save(img, f"{fname}_256th[{i}].png"))
        return written
    # concat: two rows of heads (reference packs 6 heads as 3+3, :275-294)
    half = (n_heads + 1) // 2
    grid = concat_images([concat_images(hms[:half]),
                          concat_images(hms[half:])], how="vertical")
    written.append(_save(grid, f"{fname}_256hm.png"))
    if ths:
        grid_th = concat_images([concat_images(ths[:half]),
                                 concat_images(ths[half:])], how="vertical")
        written.append(_save(grid_th, f"{fname}_256th.png"))
    return written
