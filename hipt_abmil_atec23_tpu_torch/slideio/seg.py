"""Tissue segmentation: HSV -> median blur -> threshold -> close -> contours.

The port's own copy of hipt_abmil_atec23_tpu/slideio/seg.py, including the
segmentation pickle (``SegmentationResult.save`` / ``load``, readable by
either package), the contour overlay and the external-contour loader.

Behavior parity with the reference (reference:
wsi_core/WholeSlideImage.py:111-203 segmentTissue/_filter_contours):
saturation-channel Otsu/binary thresholding, morphological closing,
RETR_CCOMP contour extraction, foreground filtering by net area (contour
minus holes) against a_t scaled by (512^2 / seg-level downsample^2), and
per-contour hole selection (top max_n_holes by area, each > a_h scaled).

Contour *extraction* stays on the CPU via OpenCV — a one-shot, per-slide,
small-image operation (SURVEY.md §2.9 plan). The per-candidate geometry that
the reference parallelizes with mp.Pool happens vectorized in patching.py.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu_torch.utils.config import SegConfig


@dataclass
class SegmentationResult:
    contours: List[np.ndarray]        # level-0 coords, [K_i, 1, 2] int32
    holes: List[List[np.ndarray]]     # per-contour holes, level-0 coords
    seg_level: int
    mask: Optional[np.ndarray] = None  # binary tissue mask at seg_level

    def save(self, path: str) -> None:
        """Segmentation pickle (reference: saveSegmentation,
        WholeSlideImage.py:92-102 — {'tissue': ..., 'holes': ...})."""
        with open(path, "wb") as f:
            pickle.dump({"tissue": self.contours, "holes": self.holes,
                         "seg_level": self.seg_level}, f)

    @classmethod
    def load(cls, path: str) -> "SegmentationResult":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(contours=d["tissue"], holes=d["holes"],
                   seg_level=d.get("seg_level", 0))


def segment_tissue(slide: BaseSlide, cfg: SegConfig,
                   ref_patch_size: int = 512) -> SegmentationResult:
    import cv2

    seg_level = cfg.seg_level
    if seg_level < 0:
        # auto-pick level closest to 64x downsample
        # (reference: create_patches_fp.py:153-163)
        seg_level = slide.get_best_level_for_downsample(64)

    img = slide.read_level(seg_level)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    med = cv2.medianBlur(hsv[:, :, 1], cfg.mthresh)
    if cfg.use_otsu:
        _, binary = cv2.threshold(med, cfg.sthresh, cfg.sthresh_up,
                                  cv2.THRESH_OTSU + cv2.THRESH_BINARY)
    else:
        _, binary = cv2.threshold(med, cfg.sthresh, cfg.sthresh_up,
                                  cv2.THRESH_BINARY)
    if cfg.close > 0:
        kernel = np.ones((cfg.close, cfg.close), np.uint8)
        binary = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, kernel)

    dx, dy = slide.level_downsamples[seg_level]
    scaled_ref_area = int(ref_patch_size ** 2 / (dx * dy))
    a_t = cfg.a_t * scaled_ref_area
    a_h = cfg.a_h * scaled_ref_area

    contours, hierarchy = cv2.findContours(binary, cv2.RETR_CCOMP,
                                           cv2.CHAIN_APPROX_NONE)
    fg, holes = _filter_contours(contours, hierarchy, a_t, a_h,
                                 cfg.max_n_holes)

    scale = np.array([dx, dy], np.float64)
    fg = [(c * scale).astype(np.int32) for c in fg]
    holes = [[(h * scale).astype(np.int32) for h in hs] for hs in holes]

    # keep/exclude id selection (reference: WholeSlideImage.py:197-203)
    if cfg.keep_ids:
        ids = set(int(i) for i in cfg.keep_ids) - set(
            int(i) for i in cfg.exclude_ids)
    else:
        ids = set(range(len(fg))) - set(int(i) for i in cfg.exclude_ids)
    fg = [fg[i] for i in sorted(ids) if i < len(fg)]
    holes = [holes[i] for i in sorted(ids) if i < len(holes)]
    return SegmentationResult(contours=fg, holes=holes, seg_level=seg_level,
                              mask=binary)


def _filter_contours(contours, hierarchy, a_t: float, a_h: float,
                     max_n_holes: int):
    import cv2
    if hierarchy is None or len(contours) == 0:
        return [], []
    hierarchy = np.squeeze(hierarchy, axis=(0,))[:, 2:]  # [N, (child, parent)]
    fg_idx = np.flatnonzero(hierarchy[:, 1] == -1)
    fg, all_holes = [], []
    for ci in fg_idx:
        hole_ids = np.flatnonzero(hierarchy[:, 1] == ci)
        area = cv2.contourArea(contours[ci]) - sum(
            cv2.contourArea(contours[hi]) for hi in hole_ids)
        if area <= 0 or area <= a_t:
            continue
        fg.append(contours[ci])
        kept = sorted(hole_ids, key=lambda hi: cv2.contourArea(contours[hi]),
                      reverse=True)[:max_n_holes]
        all_holes.append([contours[hi] for hi in kept
                          if cv2.contourArea(contours[hi]) > a_h])
    return fg, all_holes


def draw_segmentation(slide: BaseSlide, seg: SegmentationResult,
                      vis_level: Optional[int] = None,
                      color=(0, 255, 0), hole_color=(0, 0, 255),
                      line_thickness: int = 250) -> np.ndarray:
    """Contour overlay image (reference: visWSI, WholeSlideImage.py:205-260)."""
    import cv2
    if vis_level is None:
        vis_level = slide.get_best_level_for_downsample(64)
    img = slide.read_level(vis_level).copy()
    dx, dy = slide.level_downsamples[vis_level]
    scale = np.array([1.0 / dx, 1.0 / dy])
    thick = max(1, int(line_thickness / dx))
    cts = [(c * scale).astype(np.int32) for c in seg.contours]
    cv2.drawContours(img, cts, -1, color, thick, lineType=cv2.LINE_8)
    for hs in seg.holes:
        hts = [(h * scale).astype(np.int32) for h in hs]
        cv2.drawContours(img, hts, -1, hole_color, thick, lineType=cv2.LINE_8)
    return img


def load_external_contours(path: str) -> SegmentationResult:
    """Load externally-produced tissue contours from a .npy pickle (the
    reference's DMMN-mask path, loadSegmentation WholeSlideImage.py:104-109):
    an object array of contours in level-0 coordinates, no holes."""
    contours = np.load(path, allow_pickle=True)
    contours = [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in contours]
    return SegmentationResult(contours=contours,
                              holes=[[] for _ in contours], seg_level=0)
