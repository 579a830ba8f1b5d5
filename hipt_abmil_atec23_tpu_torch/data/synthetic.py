"""Synthetic dataset generators for tests and benchmarks.

The port's own copy of hipt_abmil_atec23_tpu/data/synthetic.py: the same
seed writes the same bags.

The reference prototypes on a 20-WSI `custom_20` mini-dataset
(reference: create_splits_seq.py:133-141); we generate synthetic analogs:
feature bags with a planted class signal (for engine tests/benches) and
pyramidal slides (slideio tests) elsewhere.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import pandas as pd

from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest


def make_synthetic_bags(
    out_dir: str,
    n_slides: int = 40,
    feat_dim: int = 192,
    n_classes: int = 2,
    bag_range: Tuple[int, int] = (40, 300),
    signal: float = 0.6,
    signal_fraction: float = 0.2,
    seed: int = 0,
    fmt: str = "npy",
) -> Tuple[SlideManifest, FeatureBagStore]:
    """Bags of N(0,1) features; in class-c slides, a `signal_fraction` of
    instances get +signal along a class-specific direction — MIL-learnable
    but not trivially separable per instance."""
    rng = np.random.default_rng(seed)
    store = FeatureBagStore(out_dir)
    directions = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)

    rows = []
    for i in range(n_slides):
        label = i % n_classes
        n = int(rng.integers(*bag_range))
        feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
        k = max(1, int(signal_fraction * n))
        idx = rng.choice(n, k, replace=False)
        feats[idx] += signal * directions[label]
        slide_id = f"synth_{i:04d}"
        store.save(slide_id, feats, formats=(fmt,))
        rows.append({"case_id": f"case_{i:04d}", "slide_id": slide_id,
                     "label": label})

    df = pd.DataFrame(rows)
    label_dict = {str(c): c for c in range(n_classes)}
    manifest = SlideManifest.from_frame(df, label_dict)
    csv_path = os.path.join(out_dir, "labels.csv")
    df.to_csv(csv_path, index=False)
    return manifest, store
