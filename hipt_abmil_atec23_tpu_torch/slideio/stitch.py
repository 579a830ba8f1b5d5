"""Stitch tiled coordinates back into a downscaled thumbnail — the tiling
sanity check (reference: StitchCoords/DrawMapFromCoords,
wsi_core/wsi_utils.py:188-281). Uses ONE batched native read for all patches
instead of a per-coord read_region loop.

The port's own copy of hipt_abmil_atec23_tpu/slideio/stitch.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide


def stitch_coords(slide: BaseSlide, coords: np.ndarray, patch_size: int,
                  patch_level: int = 0, downscale: int = 16,
                  bg_color: Tuple[int, int, int] = (0, 0, 0),
                  draw_grid: bool = True) -> np.ndarray:
    import cv2
    w0, h0 = slide.dimensions
    vis_level = slide.get_best_level_for_downsample(downscale)
    dx, dy = slide.level_downsamples[vis_level]
    cw, ch = int(w0 / dx), int(h0 / dy)
    canvas = np.full((ch, cw, 3), bg_color, np.uint8)
    if len(coords) == 0:
        return canvas

    pdx, _ = slide.level_downsamples[patch_level]
    ref = int(patch_size * pdx)             # level-0 patch footprint
    ps = max(1, int(np.ceil(ref / dx)))     # patch size on the canvas
    patches = slide.read_regions(coords, patch_level, (patch_size, patch_size))
    for (x, y), patch in zip(np.asarray(coords), patches):
        small = cv2.resize(patch, (ps, ps), interpolation=cv2.INTER_AREA)
        cx, cy = int(x / dx), int(y / dy)
        x1, y1 = min(cx + ps, cw), min(cy + ps, ch)
        if cx >= cw or cy >= ch:
            continue
        canvas[cy:y1, cx:x1] = small[:y1 - cy, :x1 - cx]
        if draw_grid:
            cv2.rectangle(canvas, (cx, cy), (x1, y1), (0, 0, 0), 1)
    return canvas
