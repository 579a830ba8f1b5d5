"""Online feature extraction during MIL training.

Counterpart of hipt_abmil_atec23_tpu/data/online.py (the reference's
``--extract_features`` path: utils/core_utils.py:106-119 builds a frozen
encoder inside train(); datasets/dataset_generic.py:457-494 reads raw
patches per slide and the train loop encodes them per step): the MIL head
trains directly from slide pixels with a frozen encoder in the loop, no
precomputed feature bags.

Per slide, the sampled coords are read as one batched decode and encoded by
the fixed-batch encoder through ``encode_slide`` (engine/encode.py), so on
the card they ride the same transfer rungs and kernels as the encode stage.
The coords draws are the JAX package's, so one numpy Generator gives both
packages the same patches.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
from hipt_abmil_atec23_tpu_torch.engine.encode import Encoder, encode_slide
from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide, open_slide
from hipt_abmil_atec23_tpu_torch.utils.config import BagConfig


class OnlineEncodingBagDataset(BagDataset):
    """Bags computed on demand: sampled coords -> batched decode ->
    encoder.

    slide_paths: slide_id -> slide file path
    coords_dir:  directory of {slide_id}.h5 coords (the tile stage's output)

    ``_load_coords`` and ``_open_slide`` are the two file reads; a caller
    with coords and slides in memory overrides them."""

    def __init__(self, slide_ids: Sequence[str], labels: np.ndarray,
                 encoder: Encoder, slide_paths: Dict[str, str],
                 coords_dir: str, cfg: BagConfig, transform=None):
        # no FeatureBagStore: bags come from pixels
        super().__init__(slide_ids, labels, store=None, cfg=cfg)
        self.encoder = encoder
        self.slide_paths = slide_paths
        self.coords_dir = coords_dir
        self.transform = transform
        self._coords_cache: Dict[str, np.ndarray] = {}
        self._attrs_cache: Dict[str, Dict] = {}
        self._slides: Dict[str, BaseSlide] = {}
        self._feat_dim = encoder.feat_dim

    def _load_coords(self, slide_id: str):
        from hipt_abmil_atec23_tpu_torch.slideio.patching import (
            load_coords_h5)
        return load_coords_h5(os.path.join(self.coords_dir,
                                           f"{slide_id}.h5"))

    def _open_slide(self, slide_id: str) -> BaseSlide:
        return open_slide(self.slide_paths[slide_id])

    def _coords(self, slide_id: str) -> np.ndarray:
        if slide_id not in self._coords_cache:
            coords, attrs = self._load_coords(slide_id)
            self._coords_cache[slide_id] = coords
            self._attrs_cache[slide_id] = attrs
        return self._coords_cache[slide_id]

    def _slide(self, slide_id: str) -> BaseSlide:
        if slide_id not in self._slides:
            self._slides[slide_id] = self._open_slide(slide_id)
        return self._slides[slide_id]

    def _full_bag(self, slide_id: str) -> np.ndarray:
        # Deliberately unsupported: callers that want whole-slide features
        # (DRAS sampling, evaluate_fold's feat_dim probe) must not silently
        # receive zeros. train_fold works: pad_size() is overridden and its
        # callers pass feat_dim.
        raise NotImplementedError(
            "OnlineEncodingBagDataset computes bags on demand; full-bag "
            "access is not available. Precompute features (cli encode) for "
            "workflows that need whole-slide bags.")

    def get_bag(self, idx: int, rng: np.random.Generator,
                *, train: bool = True) -> np.ndarray:
        slide_id = self.slide_ids[idx]
        coords = self._coords(slide_id)
        cfg = self.cfg
        n = len(coords)
        if cfg.max_patches_per_slide and cfg.max_patches_per_slide < n:
            # with-replacement sampling like the reference's np.random.choice
            # (dataset_generic.py:465)
            sel = rng.choice(n, cfg.max_patches_per_slide,
                             replace=cfg.sampling_with_replacement)
            coords = coords[sel]
        attrs = self._attrs_cache[slide_id]
        feats = encode_slide(
            self._slide(slide_id), coords, self.encoder,
            patch_level=int(attrs.get("patch_level", 0)),
            region_size=int(attrs.get("patch_size", self.encoder.input_size)),
            transform=self.transform if train else None)
        if train and cfg.perturb_variance > 0:
            feats = feats + rng.standard_normal(feats.shape).astype(
                np.float32) * np.float32(cfg.perturb_variance)
        return feats

    def pad_size(self) -> int:
        cap = self.cfg.max_patches_per_slide or 0
        longest = max(len(self._coords(s)) for s in self.slide_ids)
        if cap:
            longest = min(longest, cap)
        return ((longest + 7) // 8) * 8

    def close(self):
        for s in self._slides.values():
            s.close()
        self._slides.clear()


class OnlineFeatureGather:
    """Lazy per-slide feature source for inference-time DRAS sampling with
    on-the-fly extraction (reference: --eval_features, eval_utils.py
    :231-260): only the patches that are asked for are decoded and encoded,
    each once.

    Duck-types the ndarray surface DRAS needs: ``len()``, ``.shape`` and
    ``.take(idxs, axis=0)``."""

    def __init__(self, slide: BaseSlide, coords: np.ndarray,
                 encoder: Encoder, *, patch_level: int = 0,
                 region_size: Optional[int] = None, transform=None):
        self.slide = slide
        self.coords = np.asarray(coords)
        self.encoder = encoder
        self.patch_level = patch_level
        self.region_size = region_size or encoder.input_size
        self.transform = transform
        # patch index -> feature: DRAS's final bag re-reads every patch it
        # sampled before (the reference keeps all_previous_features for the
        # same reason, eval_utils.py:426-429)
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.coords)

    @property
    def shape(self):
        return (len(self.coords), self.encoder.feat_dim)

    def take(self, idxs, axis: int = 0) -> np.ndarray:
        if axis != 0:
            raise ValueError(f"take along axis {axis}: only axis 0")
        idxs = np.asarray(idxs, int)
        missing = sorted({int(i) for i in idxs} - self._cache.keys())
        if missing:
            feats = encode_slide(self.slide, self.coords[missing],
                                 self.encoder, patch_level=self.patch_level,
                                 region_size=self.region_size,
                                 transform=self.transform)
            self._cache.update(zip(missing, feats))
        return np.stack([self._cache[int(i)] for i in idxs])


def build_feature_gathers(slide_paths: Dict[str, str], coords_dir: str,
                          encoder: Encoder, slide_ids: Sequence[str],
                          transform=None) -> Dict[str, OnlineFeatureGather]:
    """slide_id -> OnlineFeatureGather over its coords h5 and slide (each
    gather's ``.coords`` is the matching coords lookup)."""
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    out = {}
    for sid in slide_ids:
        coords, attrs = load_coords_h5(os.path.join(coords_dir, f"{sid}.h5"))
        out[sid] = OnlineFeatureGather(
            open_slide(slide_paths[sid]), coords, encoder,
            patch_level=int(attrs.get("patch_level", 0)),
            region_size=int(attrs.get("patch_size", encoder.input_size)),
            transform=transform)
    return out
