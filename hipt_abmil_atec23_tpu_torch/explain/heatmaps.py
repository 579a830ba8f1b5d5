"""Attention heatmaps over whole slides: the MIL head's per-region scores
on the card, then host rasterizers, and the per-slide blockmap h5 of
coordinates and scores (reference: create_heatmaps.py:320-325,
vis_utils/heatmap_utils.py, WholeSlideImage.visHeatmap :508-696).

Counterpart of hipt_abmil_atec23_tpu/explain/heatmaps.py. ``infer_attention``
pools the bag through ops/gated_attention_pool.apply_pooled (the pool
kernel on the card, its plain version on the CPU); the rasterizers are the
JAX package's numpy and OpenCV code, coloured by the port's own tables
(explain/colormaps.py), so equal scores give equal uint8 images.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.explain.colormaps import get_cmap
from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import SegmentationResult


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Rank-transform scores to [0, 1] percentiles (reference:
    wsi_utils.py:124-127 via scipy rankdata; midrank ties)."""
    from scipy.stats import rankdata
    return rankdata(scores, method="average") / len(scores)


def model_device(model: torch.nn.Module) -> torch.device:
    """The device a model's parameters live on."""
    return next(model.parameters()).device


def infer_attention(model, features) -> np.ndarray:
    """One slide's un-normalised attention scores, first branch, [N] f32
    (reference: infer_single_slide create_heatmaps.py:34-57). The bag
    (an array, or a tensor on any device) goes to the model's device and
    through ``apply_pooled``: a gated single-branch head pools it with one
    pool launch on the card."""
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled)
    bag = torch.as_tensor(features, dtype=torch.float32)
    with torch.inference_mode():
        out = apply_pooled(model, bag.to(model_device(model)))
    return out.a_raw[0].float().cpu().numpy()


def save_blockmap(path: str, coords: np.ndarray, scores: np.ndarray) -> None:
    import h5py
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("coords", data=coords)
        f.create_dataset("attention_scores", data=scores)


def load_blockmap(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f["coords"]), np.asarray(f["attention_scores"])


def draw_heatmap(
    slide: BaseSlide,
    coords: np.ndarray,
    scores: np.ndarray,
    patch_size: int,
    *,
    patch_level: int = 0,
    vis_level: Optional[int] = None,
    seg: Optional[SegmentationResult] = None,
    use_percentiles: bool = True,
    alpha: float = 0.4,
    blank_canvas: bool = False,
    cmap: str = "coolwarm",
    binarize: bool = False,
    thresh: float = 0.5,
) -> np.ndarray:
    """Rasterize per-patch attention into a blended slide overlay
    (reference: visHeatmap, WholeSlideImage.py:508-696)."""
    import cv2

    if vis_level is None:
        vis_level = slide.get_best_level_for_downsample(32)
    dx, dy = slide.level_downsamples[vis_level]
    pdx, _ = slide.level_downsamples[patch_level]
    w, h = slide.level_dimensions[vis_level]
    ps = max(1, int(np.ceil(patch_size * pdx / dx)))  # patch footprint @ vis

    scores = np.asarray(scores, np.float64).ravel()
    if use_percentiles:
        scores = to_percentiles(scores)
    if binarize:
        scores = (scores >= thresh).astype(np.float64)

    overlay = np.zeros((h, w), np.float64)
    counter = np.zeros((h, w), np.int32)
    cx = np.clip((coords[:, 0] / dx).astype(int), 0, w - 1)
    cy = np.clip((coords[:, 1] / dy).astype(int), 0, h - 1)
    for x0, y0, s in zip(cx, cy, scores):
        x1, y1 = min(x0 + ps, w), min(y0 + ps, h)
        overlay[y0:y1, x0:x1] += s
        counter[y0:y1, x0:x1] += 1
    covered = counter > 0
    overlay[covered] /= counter[covered]

    colored = (get_cmap(cmap)(overlay)[:, :, :3] * 255).astype(np.uint8)

    if blank_canvas:
        img = np.full((h, w, 3), 255, np.uint8)
    else:
        img = slide.read_level(vis_level).copy()

    if seg is not None:
        tissue = get_seg_mask(seg, (w, h), (dx, dy))
        covered = covered & tissue

    # alpha is the HEATMAP weight (reference: WholeSlideImage.py:738)
    blend = cv2.addWeighted(colored, alpha, img, 1 - alpha, 0)
    out = img.copy()
    out[covered] = blend[covered]
    return out


def get_seg_mask(seg: SegmentationResult, wh: Tuple[int, int],
                 downsample: Tuple[float, float]) -> np.ndarray:
    """Tissue mask at vis resolution (reference: get_seg_mask,
    WholeSlideImage.py:741-753)."""
    import cv2
    w, h = wh
    dx, dy = downsample
    mask = np.zeros((h, w), np.uint8)
    scale = np.array([1.0 / dx, 1.0 / dy])
    cts = [(c * scale).astype(np.int32) for c in seg.contours]
    cv2.drawContours(mask, cts, -1, 1, thickness=-1)
    for hs in seg.holes:
        hts = [(hc * scale).astype(np.int32) for hc in hs]
        cv2.drawContours(mask, hts, -1, 0, thickness=-1)
    return mask.astype(bool)


def sample_rois(coords: np.ndarray, scores: np.ndarray, k: int = 5,
                mode: str = "topk",
                score_range: Tuple[float, float] = (0.45, 0.55),
                seed: int = 1) -> Dict[str, np.ndarray]:
    """Top-k / score-range ROI sampling for patch export (reference:
    sample_rois, wsi_utils.py:137-186); ``range_sample`` draws with numpy's
    default_rng(seed), as the JAX package does."""
    scores = to_percentiles(np.asarray(scores, np.float64).ravel())
    if mode == "topk":
        idx = np.argsort(-scores)[:k]
    elif mode == "range_sample":
        lo, hi = score_range
        pool = np.flatnonzero((scores >= lo) & (scores <= hi))
        rng = np.random.default_rng(seed)
        idx = rng.choice(pool, min(k, len(pool)), replace=False)
    elif mode == "reverse_topk":
        idx = np.argsort(scores)[:k]
    else:
        raise ValueError(f"unknown sample mode {mode!r}")
    return {"sampled_coords": coords[idx], "sampled_scores": scores[idx],
            "sampled_ids": idx}


def _unit(m: np.ndarray) -> np.ndarray:
    return (m - m.min()) / max(m.max() - m.min(), 1e-8)


def vit_attention_heatmaps(attn: np.ndarray, grid_hw: Tuple[int, int],
                           patch_px: int = 16) -> np.ndarray:
    """CLS-token self-attention maps -> per-head spatial heatmaps
    (reference: HIPT_4K/hipt_heatmap_utils.py create_patch_heatmaps path).
    attn: [B, heads, N, N] from get_last_selfattention; returns
    [B, heads, gh*patch_px, gw*patch_px] upsampled CLS->patch attention."""
    import cv2
    gh, gw = grid_hw
    b, nh = attn.shape[:2]
    maps = attn[:, :, 0, 1:].reshape(b, nh, gh, gw)
    out = np.empty((b, nh, gh * patch_px, gw * patch_px), np.float32)
    for i in range(b):
        for j in range(nh):
            out[i, j] = cv2.resize(_unit(maps[i, j]).astype(np.float32),
                                   (gw * patch_px, gh * patch_px),
                                   interpolation=cv2.INTER_NEAREST)
    return out


def hierarchical_region_heatmaps(
    attn256: np.ndarray,      # [R*gh*gw, h256, 257, 257] ViT-256 last-block
    attn4k: np.ndarray,       # [R, h4k, N4k, N4k] ViT-4K last-block
    grid_hw: Tuple[int, int],
    patch_px: int = 16,
) -> Dict[str, np.ndarray]:
    """Factorized hierarchical attention maps for a region (reference:
    HIPT_4K/hipt_heatmap_utils.py create_hierarchical_heatmaps /
    hipt_4k.get_region_attention_heatmaps :167-305): the ViT-4K CLS
    attention over its gh x gw token grid, upsampled to tile resolution,
    times each tile's ViT-256 CLS attention map.

    Returns:
      'map256'   [R, h256, gh*256, gw*256]  tile-level detail
      'map4k'    [R, h4k, gh*256, gw*256]   region-level context
      'combined' [R, h4k, h256, gh*256, gw*256]  factorized product
    """
    import cv2
    gh, gw = grid_hw
    tiles_per = gh * gw
    r, h4k = attn4k.shape[:2]
    h256 = attn256.shape[1]
    side = 256  # pixels per 256-tile

    t256 = attn256[:, :, 0, 1:].reshape(r, tiles_per, h256, patch_px,
                                        patch_px)
    map256 = np.zeros((r, h256, gh * side, gw * side), np.float32)
    for ri in range(r):
        for ti in range(tiles_per):
            ty, tx = divmod(ti, gw)
            for hi in range(h256):
                map256[ri, hi, ty * side:(ty + 1) * side,
                       tx * side:(tx + 1) * side] = cv2.resize(
                    _unit(t256[ri, ti, hi]), (side, side),
                    interpolation=cv2.INTER_NEAREST)

    t4k = attn4k[:, :, 0, 1:1 + tiles_per].reshape(r, h4k, gh, gw)
    map4k = np.zeros((r, h4k, gh * side, gw * side), np.float32)
    for ri in range(r):
        for hi in range(h4k):
            map4k[ri, hi] = cv2.resize(_unit(t4k[ri, hi]),
                                       (gw * side, gh * side),
                                       interpolation=cv2.INTER_NEAREST)

    combined = map4k[:, :, None] * map256[:, None]     # [R, h4k, h256, H, W]
    return {"map256": map256, "map4k": map4k, "combined": combined}
