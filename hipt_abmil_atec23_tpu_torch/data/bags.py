"""Per-slide feature-bag storage and bag datasets.

The port's own copy of ``FeatureBagStore``, ``BagDataset`` (full bags,
their pad size and the subsampled, padded batches of
``Generic_MIL_Dataset.__getitem__``, reference: datasets/
dataset_generic.py:448-578), ``balanced_sample_weights`` and
``epoch_order`` from hipt_abmil_atec23_tpu/data/bags.py. Every host draw
takes the numpy Generator in the JAX package's order, so one ``rng`` gives
both packages the same batches. The reference's on-disk contracts hold
so artifacts interoperate: ``feat_dir/h5_files/{slide}.h5`` with ``features`` [N,D] +
``coords`` [N,2] datasets and ``feat_dir/pt_files/{slide}.pt`` tensors
(reference: extract_features_fp.py:240-255), plus ``npy_files/{slide}.npy``.
Either package's store reads what the other writes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
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


@dataclass
class BagBatch:
    """A static-shape batch of bags on the host."""
    features: np.ndarray       # [B, N_pad, D] float32
    mask: np.ndarray           # [B, N_pad] bool
    labels: np.ndarray         # [B] int32
    slide_indices: np.ndarray  # [B] int32 rows into the split


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

    def get_bag(self, idx: int, rng: np.random.Generator,
                *, train: bool = True) -> np.ndarray:
        """One bag as the reference's dataset item: a training draw may
        swap in an augmentation variant ``{slide}aug{k}`` (reference:
        random.randint(0, number_of_augs), 0 the original, :497-503); a bag
        past ``max_patches_per_slide`` is subsampled, with replacement by
        default (np.random.choice, :517-519); a training bag may get
        Gaussian noise of ``perturb_variance`` (:521-525)."""
        slide_id = self.slide_ids[idx]
        cfg = self.cfg
        if train and cfg.number_of_augs > 0:
            aug = int(rng.integers(0, cfg.number_of_augs + 1))
            if aug > 0:
                slide_id = f"{slide_id}aug{aug}"
        feats = self._full_bag(slide_id)
        n = len(feats)
        if cfg.max_patches_per_slide and cfg.max_patches_per_slide < n:
            idxs = rng.choice(n, cfg.max_patches_per_slide,
                              replace=cfg.sampling_with_replacement)
            feats = feats[idxs]
        if train and cfg.perturb_variance > 0:
            feats = feats + rng.standard_normal(feats.shape).astype(
                np.float32) * np.float32(cfg.perturb_variance)
        return feats.astype(np.float32, copy=False)

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

    def make_batch(self, indices: Sequence[int], rng: np.random.Generator,
                   n_pad: Optional[int] = None, *, train: bool = True
                   ) -> BagBatch:
        """The bags of ``indices`` (drawn in order) padded to ``n_pad``
        (default: the longest, rounded up to 8) with their validity mask."""
        bags = [self.get_bag(i, rng, train=train) for i in indices]
        if n_pad is None:
            n_pad = _round_up(max(len(b) for b in bags), 8)
        d = bags[0].shape[1]
        feats = np.zeros((len(bags), n_pad, d), np.float32)
        mask = np.zeros((len(bags), n_pad), bool)
        for j, b in enumerate(bags):
            b = b[:n_pad]
            feats[j, :len(b)] = b
            mask[j, :len(b)] = True
        return BagBatch(features=feats, mask=mask,
                        labels=self.labels[list(indices)],
                        slide_indices=np.asarray(indices, np.int32))


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
