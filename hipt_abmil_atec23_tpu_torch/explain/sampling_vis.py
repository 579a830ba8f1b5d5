"""DRAS sampling visualizations (reference: utils/sampling_utils.py:190-335):
sampled coords marked on a slide thumbnail, sampling-weight maps, and
iteration GIFs.

Counterpart of hipt_abmil_atec23_tpu/explain/sampling_vis.py, which draws
with matplotlib's figure API. The port's explain path runs without
matplotlib, so these rasters are drawn with numpy and cv2 instead: marks
are alpha-blended squares or discs on the thumbnail itself (no figure
margins, so a mark sits at its coordinate's share of the image), weights
are coloured through ``explain/colormaps.py``'s tables (matplotlib's
``jet`` by default) after the min-max scaling matplotlib's ``scatter``
applies, and a weight map carries its colour bar as a strip on the right.
``sampling_gif`` needs the ``imageio`` package and imports it only when
called. Host file output only; nothing here runs on the device.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide

# matplotlib's named colours as uint8 RGB
GREEN = (0, 128, 0)
RED = (255, 0, 0)
GRAY = (128, 128, 128)


def _thumbnail(slide: BaseSlide, thumbnail_size: int):
    """(thumb, dx, dy): best-level read + host downscale to the requested
    size. get_best_level_for_downsample only PICKS a level - on a
    shallow-pyramid slide the best level can still be tens of thousands
    of pixels wide, so the read must be followed by a resize cap. dx/dy
    are the EFFECTIVE level-0 -> thumb downsamples after the resize."""
    w0, h0 = slide.dimensions
    scale = thumbnail_size / max(w0, h0)
    lvl = slide.get_best_level_for_downsample(1.0 / scale)
    thumb = slide.read_level(lvl)
    dx, dy = slide.level_downsamples[lvl]
    h, w = thumb.shape[:2]
    if max(w, h) > thumbnail_size:
        import cv2
        s = thumbnail_size / max(w, h)
        tw, th = max(1, int(w * s)), max(1, int(h * s))
        thumb = cv2.resize(thumb, (tw, th), interpolation=cv2.INTER_AREA)
        dx, dy = dx * (w / tw), dy * (h / th)
    return np.ascontiguousarray(thumb[..., :3]), dx, dy


def _paint(img: np.ndarray, xs, ys, colors, half: int, alpha: float,
           disc: bool = False) -> np.ndarray:
    """Blend filled squares (or discs) of half-width ``half`` centred at
    (xs, ys) in ``colors`` ([n, 3] or one RGB) into ``img`` at ``alpha``;
    a later mark covers an earlier one."""
    h, w = img.shape[:2]
    xs = np.rint(np.asarray(xs, np.float64)).astype(np.int64)
    ys = np.rint(np.asarray(ys, np.float64)).astype(np.int64)
    colors = np.broadcast_to(np.asarray(colors, np.float64),
                             (len(xs), 3))
    # the last mark over a pixel owns it
    owner = np.full((h, w), -1, np.int64)
    oy, ox = np.mgrid[-half:half + 1, -half:half + 1]
    shape = (ox * ox + oy * oy <= half * half) if disc else \
        np.ones_like(ox, bool)
    for i, (x, y) in enumerate(zip(xs, ys)):
        x0, y0 = max(x - half, 0), max(y - half, 0)
        x1, y1 = min(x + half + 1, w), min(y + half + 1, h)
        if x0 < x1 and y0 < y1:
            cut = shape[y0 - y + half:y1 - y + half,
                        x0 - x + half:x1 - x + half]
            owner[y0:y1, x0:x1][cut] = i
    hit = owner >= 0
    out = img.astype(np.float64)
    out[hit] = (1.0 - alpha) * out[hit] + alpha * colors[owner[hit]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _scaled(weights: np.ndarray) -> np.ndarray:
    """matplotlib's autoscaled Normalize: (w - min) / (max - min), 0 when
    every weight is equal."""
    w = np.asarray(weights, np.float64)
    lo, hi = w.min(), w.max()
    return np.zeros_like(w) if hi == lo else (w - lo) / (hi - lo)


def _with_colorbar(img: np.ndarray, cmap) -> np.ndarray:
    """``img`` with a vertical colour bar (max at the top) on its right,
    past a white gap."""
    h = img.shape[0]
    bar_w, gap = max(12, img.shape[1] // 30), max(8, img.shape[1] // 60)
    ramp = (cmap(np.linspace(1.0, 0.0, h))[:, :3] * 255).round()
    bar = np.repeat(ramp[:, None, :], bar_w, axis=1).astype(np.uint8)
    white = np.full((h, gap, 3), 255, np.uint8)
    return np.concatenate([img, white, bar], axis=1)


def _save(path: str, rgb: np.ndarray) -> None:
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)):
        raise OSError(f"could not write {path}")


def plot_sampling(slide: BaseSlide, sample_coords: np.ndarray, out_path: str,
                  thumbnail_size: int = 1000, correct: bool = True) -> None:
    """Sampled coords marked on a thumbnail; green if the prediction was
    correct, red otherwise (reference: plot_sampling)."""
    thumb, dx, dy = _thumbnail(slide, thumbnail_size)
    c = np.asarray(sample_coords, np.float64).reshape(-1, 2)
    radius = max(2, max(thumb.shape[:2]) // 250)
    img = _paint(thumb, c[:, 0] / dx, c[:, 1] / dy,
                 GREEN if correct else RED, radius, 0.7, disc=True)
    _save(out_path, img)


def plot_weight_map(coords: np.ndarray, weights: np.ndarray, out_path: str,
                    point_size: int = 8,
                    slide: Optional[BaseSlide] = None,
                    sample_coords: Optional[np.ndarray] = None,
                    patch_size: int = 256,
                    thumbnail_size: int = 1000,
                    cmap: str = "jet") -> None:
    """Sampling-weight map (reference: plot_weighting /
    plot_weighting_gif frames, sampling_utils.py:244-335): colour-mapped
    squares at the patch centres, over the slide thumbnail with the
    current iteration's samples in gray; without a slide, the bare weight
    scatter on white in image orientation (y down). A colour bar on the
    right. ``point_size`` is the bare scatter's marker area in pixels; on
    a thumbnail each square spans its patch."""
    from hipt_abmil_atec23_tpu_torch.explain.colormaps import get_cmap
    cm = get_cmap(cmap)
    coords = np.asarray(coords, np.float64).reshape(-1, 2)
    colors = cm(_scaled(weights))[:, :3] * 255
    if slide is not None:
        img, dx, dy = _thumbnail(slide, thumbnail_size)
        half = patch_size / 2  # reference plots patch centers (+128)
        side = max(1, int(round(0.5 * patch_size / max(dx, dy))))
        img = _paint(img, (coords[:, 0] + half) / dx,
                     (coords[:, 1] + half) / dy, colors, side, 0.6)
        if sample_coords is not None and len(sample_coords):
            sc = np.asarray(sample_coords, np.float64).reshape(-1, 2)
            img = _paint(img, (sc[:, 0] + half) / dx, (sc[:, 1] + half) / dy,
                         GRAY, side, 0.8)
    else:
        lo, span = coords.min(0), np.ptp(coords, 0)
        scale = (thumbnail_size - 1) / max(float(span.max()), 1.0)
        w, h = (np.floor(span * scale).astype(int) + 1)
        side = max(1, int(round(np.sqrt(point_size) / 2)))
        pad = side + 1
        img = np.full((h + 2 * pad, w + 2 * pad, 3), 255, np.uint8)
        xy = (coords - lo) * scale + pad
        img = _paint(img, xy[:, 0], xy[:, 1], colors, side, 1.0, disc=True)
    _save(out_path, _with_colorbar(img, cm))


def sampling_gif(frame_paths: Sequence[str], out_path: str,
                 fps: int = 2) -> None:
    """Stitch per-iteration frames into a GIF (reference: plot_sampling_gif).
    Frames are resized to the first frame's shape."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError("sampling_gif writes GIFs with the 'imageio' "
                          "package, which is not installed") from e
    import cv2
    frames = []
    for p in frame_paths:
        bgr = cv2.imread(p, cv2.IMREAD_COLOR)
        if bgr is None:
            raise OSError(f"could not read frame {p}")
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    h, w = frames[0].shape[:2]
    frames = [f if f.shape[:2] == (h, w) else cv2.resize(f, (w, h))
              for f in frames]
    imageio.mimsave(out_path, frames, duration=1000.0 / fps)  # ms
