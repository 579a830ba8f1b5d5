"""Per-slide feature-bag storage.

The port's own copy of the writing half of ``FeatureBagStore`` from
hipt_abmil_atec23_tpu/data/bags.py (serving saves bags; nothing in the port
reads them yet), with the reference's on-disk contracts so artifacts
interoperate: ``feat_dir/h5_files/{slide}.h5`` with ``features`` [N,D] +
``coords`` [N,2] datasets and ``feat_dir/pt_files/{slide}.pt`` tensors
(reference: extract_features_fp.py:240-255), plus ``npy_files/{slide}.npy``.
The JAX package's store reads them.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


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
