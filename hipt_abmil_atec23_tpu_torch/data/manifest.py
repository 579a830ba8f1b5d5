"""Slide/label manifest: the host-side truth table for an experiment.

The port's own copy of hipt_abmil_atec23_tpu/data/manifest.py.

Re-designs the reference's ``Generic_WSI_Classification_Dataset``
(reference: datasets/dataset_generic.py:42-353) as a plain immutable table +
pure functions: label-dict mapping, optional patient-level aggregation
(max / majority voting, reference: :122-138), per-class index lists
(reference: cls_ids_prep :111), and class counts for balanced CE
(reference: count_by_class :347).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


@dataclass
class SlideManifest:
    """Immutable view over the label CSV (case_id, slide_id, label)."""

    df: pd.DataFrame                  # columns: case_id, slide_id, label (int)
    label_dict: Dict[str, int]
    n_classes: int
    patient_df: Optional[pd.DataFrame] = None  # case_id, label — when patient_strat

    @classmethod
    def from_csv(
        cls,
        csv_path: str,
        label_dict: Dict[str, int],
        *,
        ignore: Sequence[str] = (),
        label_col: str = "label",
        filter_dict: Optional[Dict[str, Sequence]] = None,
        shuffle: bool = False,
        seed: int = 7,
        patient_strat: bool = False,
        patient_voting: str = "max",
    ) -> "SlideManifest":
        df = pd.read_csv(csv_path)
        return cls.from_frame(
            df, label_dict, ignore=ignore, label_col=label_col,
            filter_dict=filter_dict, shuffle=shuffle, seed=seed,
            patient_strat=patient_strat, patient_voting=patient_voting)

    @classmethod
    def from_frame(
        cls,
        df: pd.DataFrame,
        label_dict: Dict[str, int],
        *,
        ignore: Sequence[str] = (),
        label_col: str = "label",
        filter_dict: Optional[Dict[str, Sequence]] = None,
        shuffle: bool = False,
        seed: int = 7,
        patient_strat: bool = False,
        patient_voting: str = "max",
    ) -> "SlideManifest":
        df = df.copy()
        if label_col != "label":
            df["label"] = df[label_col]
        if filter_dict:
            keep = np.full(len(df), True)
            for col, vals in filter_dict.items():
                keep &= df[col].isin(vals).values
            df = df[keep]
        # Map string labels through label_dict; pass through already-int labels
        # (reference: df_prep, dataset_generic.py:85-99).
        df = df[~df["label"].isin(ignore)].reset_index(drop=True)
        def _map(v):
            if v in label_dict:
                return label_dict[v]
            return int(v)
        df["label"] = df["label"].map(_map).astype(int)
        if "case_id" not in df.columns:
            df["case_id"] = df["slide_id"]
        if shuffle:
            rng = np.random.default_rng(seed)
            df = df.iloc[rng.permutation(len(df))].reset_index(drop=True)

        n_classes = len(set(label_dict.values()))
        patient_df = None
        if patient_strat:
            patient_df = _aggregate_patients(df, patient_voting)
        return cls(df=df.reset_index(drop=True), label_dict=label_dict,
                   n_classes=n_classes, patient_df=patient_df)

    def __len__(self) -> int:
        return len(self.df)

    @property
    def slide_ids(self) -> np.ndarray:
        return self.df["slide_id"].values

    @property
    def labels(self) -> np.ndarray:
        return self.df["label"].values.astype(np.int32)

    def cls_ids(self, patient_level: bool = False) -> List[np.ndarray]:
        """Per-class row-index lists (reference: cls_ids_prep :111-120)."""
        table = self.patient_df if patient_level else self.df
        if table is None:
            raise ValueError("patient_strat was not enabled")
        return [np.where(table["label"].values == c)[0]
                for c in range(self.n_classes)]

    def class_counts(self) -> np.ndarray:
        """Slide counts per class, for balanced CE weights
        (reference: count_by_class :347-352, core_utils.py:147-151)."""
        return np.bincount(self.labels, minlength=self.n_classes)

    def subset_by_slide_ids(self, slide_ids: Sequence[str]) -> "SlideManifest":
        order = {s: i for i, s in enumerate(slide_ids)}
        sub = self.df[self.df["slide_id"].isin(set(slide_ids))].copy()
        sub["__order"] = sub["slide_id"].map(order)
        sub = sub.sort_values("__order").drop(columns="__order").reset_index(drop=True)
        return SlideManifest(df=sub, label_dict=self.label_dict,
                             n_classes=self.n_classes)


def _aggregate_patients(df: pd.DataFrame, voting: str) -> pd.DataFrame:
    """Patient-level label aggregation (reference: patient_data_prep
    dataset_generic.py:122-138): 'max' takes the maximum slide label,
    'maj' the majority vote."""
    patients = np.unique(df["case_id"].values)
    labels = []
    for p in patients:
        locs = df[df["case_id"] == p]["label"].values
        if voting == "max":
            labels.append(int(locs.max()))
        elif voting == "maj":
            from scipy import stats
            labels.append(int(stats.mode(locs, keepdims=False)[0]))
        else:
            raise ValueError(f"unknown patient_voting {voting!r}")
    return pd.DataFrame({"case_id": patients, "label": labels})
