"""Attention blockmaps: the per-slide h5 of coordinates and attention
scores that serving writes (reference: create_heatmaps.py:320-325).

The port's own copy of the blockmap reader and writer of
hipt_abmil_atec23_tpu/explain/heatmaps.py; the rasterizers stay there.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


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
