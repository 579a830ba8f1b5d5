"""Legacy/auxiliary WSI utilities.

The port's own copy of hipt_abmil_atec23_tpu/slideio/legacy.py.

Capability parity with the reference's image-bag path and helpers:
- white/black patch filters (reference: wsi_core/wsi_utils.py:10-23)
- legacy image patching: store the patch PIXELS in the h5 bag instead of
  coords (reference: createPatches_bag_hdf5 + _getPatchGenerator,
  WholeSlideImage.py:263-355; schema 'imgs' + 'coords')
- Mosaic_Canvas: paste sampled patches into a grid sheet
  (reference: wsi_core/util_classes.py:6-46)
- annotation loaders: tumor contours from XML / txt-dict files
  (reference: initXML/initTxt, WholeSlideImage.py:56-90)
- generic extendable-h5 writer (reference: save_hdf5, wsi_utils.py:54-73)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide


def is_white_patch(patch: np.ndarray, sat_thresh: int = 5) -> bool:
    """Mean saturation below threshold => background white patch."""
    import cv2
    sat = cv2.cvtColor(patch, cv2.COLOR_RGB2HSV)[:, :, 1]
    return bool(sat.mean() < sat_thresh)


def is_black_patch(patch: np.ndarray, rgb_thresh: int = 40) -> bool:
    return bool(patch.mean() < rgb_thresh)


def save_hdf5(path: str, asset_dict: Dict[str, np.ndarray],
              attr_dict: Optional[Dict[str, Dict]] = None,
              mode: str = "a") -> str:
    """Append-mode chunked extendable datasets (reference schema:
    wsi_utils.py:54-73 / utils/file_utils.py:16-35)."""
    import h5py
    with h5py.File(path, mode) as f:
        for key, val in asset_dict.items():
            val = np.asarray(val)
            if key not in f:
                maxshape = (None,) + val.shape[1:]
                d = f.create_dataset(key, data=val, maxshape=maxshape,
                                     chunks=True)
                if attr_dict and key in attr_dict:
                    for ak, av in attr_dict[key].items():
                        d.attrs[ak] = av
            else:
                d = f[key]
                n = d.shape[0]
                d.resize(n + val.shape[0], axis=0)
                d[n:] = val
    return path


def create_patch_bag_hdf5(slide: BaseSlide, coords: np.ndarray, path: str,
                          patch_size: int = 256, patch_level: int = 0,
                          drop_white: bool = True, drop_black: bool = True,
                          white_thresh: int = 5, black_thresh: int = 40,
                          batch: int = 64) -> int:
    """Read each patch and store pixels in the bag, skipping white/black
    patches (reference: createPatches_bag_hdf5). Uses batched native reads.
    Returns the number of kept patches."""
    kept = 0
    if os.path.exists(path):
        os.remove(path)
    for i in range(0, len(coords), batch):
        chunk = coords[i:i + batch]
        patches = slide.read_regions(chunk, patch_level,
                                     (patch_size, patch_size))
        keep = np.ones(len(chunk), bool)
        for j, p in enumerate(patches):
            if drop_white and is_white_patch(p, white_thresh):
                keep[j] = False
            elif drop_black and is_black_patch(p, black_thresh):
                keep[j] = False
        if keep.any():
            save_hdf5(path, {"imgs": patches[keep], "coords": chunk[keep]})
            kept += int(keep.sum())
    return kept


def load_patch_bag_hdf5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a legacy image bag (reference: Whole_Slide_Bag,
    datasets/dataset_h5.py:39-94)."""
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f["imgs"]), np.asarray(f["coords"])


class MosaicCanvas:
    """Paste patches into a grid sheet (reference: Mosaic_Canvas)."""

    def __init__(self, patch_size: int = 256, n: int = 100, downscale: int = 4,
                 n_per_row: int = 10,
                 bg_color: Tuple[int, int, int] = (0, 0, 0)):
        import math
        self.ps = int(np.ceil(patch_size / downscale))
        n_rows = int(np.ceil(n / n_per_row))
        self.n_per_row = n_per_row
        self.canvas = np.full((n_rows * self.ps, n_per_row * self.ps, 3),
                              bg_color, np.uint8)
        self._i = 0

    def paste(self, patch: np.ndarray) -> None:
        import cv2
        small = cv2.resize(patch, (self.ps, self.ps),
                           interpolation=cv2.INTER_AREA)
        r, c = divmod(self._i, self.n_per_row)
        self.canvas[r * self.ps:(r + 1) * self.ps,
                    c * self.ps:(c + 1) * self.ps] = small
        self._i += 1

    def save(self, path: str) -> None:
        import cv2
        cv2.imwrite(path, cv2.cvtColor(self.canvas, cv2.COLOR_RGB2BGR))


def load_annotations_xml(path: str) -> List[np.ndarray]:
    """Tumor annotation contours from an XML of <Coordinate X= Y=> groups
    (reference: initXML, WholeSlideImage.py:56-64)."""
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()
    contours = []
    for ann in root.iter("Annotation"):
        pts = [(float(c.attrib["X"]), float(c.attrib["Y"]))
               for c in ann.iter("Coordinate")]
        if pts:
            contours.append(np.asarray(pts, np.int32).reshape(-1, 1, 2))
    # largest-first like the reference's sorted annotations
    contours.sort(key=lambda c: -_poly_area(c))
    return contours


def load_annotations_txt(path: str) -> List[np.ndarray]:
    """Annotation dict literal file: {'group': [[(x,y), ...], ...]}
    (reference: initTxt, WholeSlideImage.py:66-90)."""
    import ast
    with open(path) as f:
        annot = ast.literal_eval(f.read())
    contours = []
    for _, groups in annot.items():
        for pts in groups:
            contours.append(np.asarray(pts, np.int32).reshape(-1, 1, 2))
    contours.sort(key=lambda c: -_poly_area(c))
    return contours


def _poly_area(c: np.ndarray) -> float:
    import cv2
    return float(cv2.contourArea(c.astype(np.int32)))
