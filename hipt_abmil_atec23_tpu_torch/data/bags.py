"""Per-slide feature-bag storage and full-bag datasets.

The port's own copy of ``FeatureBagStore``, ``BagDataset`` (full bags and
their pad size; the subsampling batch assembly is not ported yet),
``balanced_sample_weights`` and ``epoch_order`` from
hipt_abmil_atec23_tpu/data/bags.py, with the reference's on-disk contracts
so artifacts interoperate: ``feat_dir/h5_files/{slide}.h5`` with ``features`` [N,D] +
``coords`` [N,2] datasets and ``feat_dir/pt_files/{slide}.pt`` tensors
(reference: extract_features_fp.py:240-255), plus ``npy_files/{slide}.npy``.
Either package's store reads what the other writes.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.utils.config import BagConfig


def _load_pt(path: str) -> np.ndarray:
    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.detach().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


class FeatureBagStore:
    """Per-slide feature bags under a feature directory."""

    def __init__(self, feat_dir: str):
        self.feat_dir = feat_dir

    def pt_path(self, slide_id: str) -> str:
        return os.path.join(self.feat_dir, "pt_files", f"{slide_id}.pt")

    def h5_path(self, slide_id: str) -> str:
        return os.path.join(self.feat_dir, "h5_files", f"{slide_id}.h5")

    def npy_path(self, slide_id: str) -> str:
        return os.path.join(self.feat_dir, "npy_files", f"{slide_id}.npy")

    def exists(self, slide_id: str) -> bool:
        return any(os.path.exists(p) for p in
                   (self.pt_path(slide_id), self.h5_path(slide_id),
                    self.npy_path(slide_id)))

    def load_features(self, slide_id: str) -> np.ndarray:
        """Read order: pt_files -> h5_files -> npy_files."""
        pt = self.pt_path(slide_id)
        if os.path.exists(pt):
            return _load_pt(pt)
        h5 = self.h5_path(slide_id)
        if os.path.exists(h5):
            import h5py
            with h5py.File(h5, "r") as f:
                return np.asarray(f["features"], dtype=np.float32)
        npy = self.npy_path(slide_id)
        if os.path.exists(npy):
            return np.load(npy).astype(np.float32)
        raise FileNotFoundError(f"no feature bag for slide {slide_id!r} "
                                f"under {self.feat_dir}")

    def save(self, slide_id: str, features: np.ndarray,
             coords: Optional[np.ndarray] = None,
             formats: Sequence[str] = ("h5", "pt")) -> None:
        if "h5" in formats:
            import h5py
            os.makedirs(os.path.join(self.feat_dir, "h5_files"), exist_ok=True)
            with h5py.File(self.h5_path(slide_id), "w") as f:
                f.create_dataset("features", data=features)
                if coords is not None:
                    f.create_dataset("coords", data=coords)
        if "pt" in formats:
            os.makedirs(os.path.join(self.feat_dir, "pt_files"), exist_ok=True)
            torch.save(torch.tensor(features), self.pt_path(slide_id))
        if "npy" in formats:
            os.makedirs(os.path.join(self.feat_dir, "npy_files"), exist_ok=True)
            np.save(self.npy_path(slide_id), features)


class BagDataset:
    """The bags of a manifest split. ``store`` is anything with
    ``load_features(slide_id) -> [N, D]``; full bags are cached."""

    def __init__(self, slide_ids: Sequence[str], labels: np.ndarray,
                 store, cfg: BagConfig):
        self.slide_ids = list(slide_ids)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.store = store
        self.cfg = cfg
        self._cache: Dict[str, np.ndarray] = {}
        self.cache_bags = True

    def __len__(self) -> int:
        return len(self.slide_ids)

    def _full_bag(self, slide_id: str) -> np.ndarray:
        if self.cache_bags and slide_id in self._cache:
            return self._cache[slide_id]
        feats = self.store.load_features(slide_id)
        if feats.ndim != 2:
            feats = feats.reshape(feats.shape[0], -1)
        if self.cache_bags:
            self._cache[slide_id] = feats
        return feats

    def pad_size(self) -> int:
        """Single static pad size: min(max bag length, max_patches_per_slide),
        augmentation variants ``{slide}augN`` included."""
        cap = self.cfg.max_patches_per_slide or 0
        ids = list(self.slide_ids)
        if self.cfg.number_of_augs > 0:
            ids += [f"{s}aug{a}" for s in self.slide_ids
                    for a in range(1, self.cfg.number_of_augs + 1)]
        longest = max(len(self._full_bag(s)) for s in ids)
        if cap:
            longest = min(longest, cap)
        return _round_up(longest, 8)


def balanced_sample_weights(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-slide sampling weights N/count(class) (reference:
    make_weights_for_balanced_classes_split, utils/utils.py:207-215)."""
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    n = float(len(labels))
    w = n / np.maximum(counts, 1.0)
    return w[labels]


def epoch_order(labels: np.ndarray, n_classes: int, rng: np.random.Generator,
                weighted: bool) -> np.ndarray:
    """One epoch's slide visit order. Weighted mode samples len(labels)
    indices with replacement, probability proportional to inverse class
    frequency (reference: WeightedRandomSampler at utils/utils.py:91);
    unweighted mode is a plain shuffle (RandomSampler, :93)."""
    n = len(labels)
    if weighted:
        w = balanced_sample_weights(labels, n_classes)
        return rng.choice(n, size=n, replace=True, p=w / w.sum())
    return rng.permutation(n)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
