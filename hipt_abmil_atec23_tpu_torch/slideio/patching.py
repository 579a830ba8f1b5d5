"""Patch-coordinate enumeration — vectorized.

The port's own copy of hipt_abmil_atec23_tpu/slideio/patching.py: the
enumeration and the coords-h5 writer and reader, in the same h5 layout, so
a coords file written by either package loads in the other.

The reference tests every grid candidate against the tissue contour with
cv2.pointPolygonTest across a 4-worker fork pool (reference:
wsi_core/WholeSlideImage.py:415-499 + util_classes.py:53-111): O(contour_len)
per point. Here the contour (minus its holes) is rasterized ONCE into a
binary mask at seg resolution and all candidates' check-points are evaluated
as a single numpy gather — O(area) once + O(1) per point, no processes.

Contour-check functors match the reference's registry: four_pt (any of 4
center-shifted points inside), four_pt_hard (all 4), center, basic.
Divergence note: mask rasterization quantizes the inside test to one
mask-resolution pixel vs pointPolygonTest's exact polygon arithmetic;
boundary-straddling candidates within ~1 seg-level pixel may differ.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu_torch.slideio.seg import SegmentationResult
from hipt_abmil_atec23_tpu_torch.utils.config import TileConfig

CONTOUR_FNS = ("four_pt", "four_pt_hard", "center", "basic")


def _rasterize(contour: np.ndarray, holes: Sequence[np.ndarray],
               mask_downsample: float) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Filled contour-minus-holes mask at 1/mask_downsample resolution,
    cropped to the contour bbox (origin returned)."""
    import cv2
    pts = contour.reshape(-1, 2)
    x0, y0 = pts.min(0)
    x1, y1 = pts.max(0)
    pad = int(mask_downsample)
    ox, oy = int(x0) - pad, int(y0) - pad
    w = int(np.ceil((x1 - ox) / mask_downsample)) + 2
    h = int(np.ceil((y1 - oy) / mask_downsample)) + 2
    mask = np.zeros((h, w), np.uint8)
    scaled = ((pts - [ox, oy]) / mask_downsample).astype(np.int32)
    cv2.drawContours(mask, [scaled.reshape(-1, 1, 2)], -1, 1, thickness=-1)
    for hole in holes:
        hp = ((hole.reshape(-1, 2) - [ox, oy]) / mask_downsample).astype(np.int32)
        cv2.drawContours(mask, [hp.reshape(-1, 1, 2)], -1, 0, thickness=-1)
    return mask, (ox, oy)


def _sample_mask(mask: np.ndarray, origin: Tuple[int, int],
                 pts: np.ndarray, mask_downsample: float) -> np.ndarray:
    """Vectorized inside-test for level-0 points [N, 2] -> bool [N]."""
    ix = ((pts[:, 0] - origin[0]) / mask_downsample).astype(np.int64)
    iy = ((pts[:, 1] - origin[1]) / mask_downsample).astype(np.int64)
    inb = (ix >= 0) & (ix < mask.shape[1]) & (iy >= 0) & (iy < mask.shape[0])
    out = np.zeros(len(pts), bool)
    out[inb] = mask[iy[inb], ix[inb]] > 0
    return out


def enumerate_contour_coords(
    slide: BaseSlide, contour: np.ndarray, holes: Sequence[np.ndarray],
    cfg: TileConfig,
    top_left: Optional[Tuple[int, int]] = None,
    bot_right: Optional[Tuple[int, int]] = None,
    mask_downsample: Optional[float] = None,
) -> np.ndarray:
    """Grid-enumerate level-0 (x, y) coords inside one tissue contour
    (reference: process_contour, WholeSlideImage.py:415-499)."""
    import cv2
    dx, dy = slide.level_downsamples[cfg.patch_level]
    pdx, pdy = int(dx), int(dy)
    ref_w, ref_h = cfg.patch_size * pdx, cfg.patch_size * pdy
    img_w, img_h = slide.dimensions

    x0, y0, w, h = cv2.boundingRect(contour)
    if cfg.use_padding:
        stop_x, stop_y = x0 + w, y0 + h
    else:
        stop_x = min(x0 + w, img_w - ref_w + 1)
        stop_y = min(y0 + h, img_h - ref_h + 1)
    if bot_right is not None:
        stop_x, stop_y = min(bot_right[0], stop_x), min(bot_right[1], stop_y)
    if top_left is not None:
        x0, y0 = max(top_left[0], x0), max(top_left[1], y0)
    if stop_x <= x0 or stop_y <= y0:
        return np.zeros((0, 2), np.int64)

    xs = np.arange(x0, stop_x, cfg.step_size * pdx, dtype=np.int64)
    ys = np.arange(y0, stop_y, cfg.step_size * pdy, dtype=np.int64)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    cand = np.stack([gx.ravel(), gy.ravel()], axis=1)  # x-major like reference

    if mask_downsample is None:
        # native resolution capped so huge contours stay cheap
        mask_downsample = max(1.0, np.sqrt(w * h / 4e7))
    mask, origin = _rasterize(contour, holes, mask_downsample)

    half = ref_w // 2
    shift = int(half * 0.5)
    center = cand + half
    if cfg.contour_fn == "basic":
        keep = _sample_mask(mask, origin, cand, mask_downsample)
    elif cfg.contour_fn == "center":
        keep = _sample_mask(mask, origin, center, mask_downsample)
    elif cfg.contour_fn in ("four_pt", "four_pt_hard"):
        if shift > 0:
            offsets = np.array([[-shift, -shift], [shift, shift],
                                [shift, -shift], [-shift, shift]])
            tests = np.stack([_sample_mask(mask, origin, center + o,
                                           mask_downsample)
                              for o in offsets])
            keep = tests.any(0) if cfg.contour_fn == "four_pt" else tests.all(0)
        else:
            keep = _sample_mask(mask, origin, center, mask_downsample)
    else:
        raise ValueError(f"unknown contour_fn {cfg.contour_fn!r}")

    # hole exclusion is already part of the rasterized mask (the reference
    # tests isInHoles separately on the patch center,
    # WholeSlideImage.py:357-372 — same effect for center-based functors).
    return cand[keep]


def enumerate_coords(slide: BaseSlide, seg: SegmentationResult,
                     cfg: TileConfig) -> np.ndarray:
    """All tissue patch coords for a slide (reference: process_contours,
    WholeSlideImage.py:392-412)."""
    parts = [enumerate_contour_coords(slide, c, h, cfg)
             for c, h in zip(seg.contours, seg.holes)]
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(parts, axis=0)


def coords_attrs(slide: BaseSlide, cfg: TileConfig, name: str,
                 save_path: str) -> Dict:
    """Attribute dict matching the reference's coords-h5 schema
    (WholeSlideImage.py:485-496)."""
    lvl_dim = slide.level_dimensions[cfg.patch_level]
    return {
        "patch_size": cfg.patch_size,
        "patch_level": cfg.patch_level,
        "downsample": np.asarray(slide.level_downsamples[cfg.patch_level]),
        "downsampled_level_dim": np.asarray(lvl_dim),
        "level_dim": np.asarray(lvl_dim),
        "name": name,
        "save_path": save_path,
    }


def save_coords_h5(path: str, coords: np.ndarray, attrs: Dict) -> None:
    """coords-h5 artifact (dataset 'coords' + attrs — reference:
    wsi_utils.py:54-73 save_hdf5 schema)."""
    import h5py
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("coords", data=np.asarray(coords, np.int64),
                             maxshape=(None, 2), chunks=True)
        for k, v in attrs.items():
            d.attrs[k] = v


def load_coords_h5(path: str) -> Tuple[np.ndarray, Dict]:
    import h5py
    with h5py.File(path, "r") as f:
        d = f["coords"]
        return np.asarray(d), dict(d.attrs)
