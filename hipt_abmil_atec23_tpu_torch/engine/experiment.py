"""K-fold cross-validation experiments.

Counterpart of hipt_abmil_atec23_tpu/engine/experiment.py (reference:
main.py:231-293): per-fold training, then ``summary.csv`` with the test /
val AUC and accuracy of every fold, per-slide ``fold_k.csv`` files
(reference: eval.py:238-246) and the settings dump (main.py:504-506). The
per-slide CSVs are written with the stdlib ``csv`` module, so training on
a host without pandas still writes them; the slide manifest and the
summary need pandas.
"""
from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np

from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
from hipt_abmil_atec23_tpu_torch.data.splits import (
    check_split_disjoint, generate_kfold_splits, load_split_csv)
from hipt_abmil_atec23_tpu_torch.engine.train import FoldResult, train_fold


def resolve_fold_manifests(manifest, cfg, fold: int):
    """(train, val, test) sub-manifests from ``split_dir/splits_{fold}.csv``
    when it exists (reference: return_splits(from_id=False), main.py:
    233-239), else drawn in memory; either way the splits must be
    disjoint."""
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    split_csv = os.path.join(cfg.split_dir, f"splits_{fold}.csv") \
        if cfg.split_dir else None
    if split_csv and os.path.exists(split_csv):
        tr_ids, va_ids, te_ids = load_split_csv(split_csv)
        if set(tr_ids) & set(te_ids) or set(tr_ids) & set(va_ids):
            raise ValueError(f"{split_csv}: train overlaps val or test")
        return tuple(manifest.subset_by_slide_ids(ids)
                     for ids in (tr_ids, va_ids, te_ids))
    splits = generate_kfold_splits(manifest.labels, cfg.train.k,
                                   seed=cfg.train.seed)
    split = splits[fold]
    check_split_disjoint(split)
    return tuple(SlideManifest(manifest.df.iloc[ids].reset_index(drop=True),
                               manifest.label_dict, manifest.n_classes)
                 for ids in split)


def make_fold_datasets(manifest, store, cfg, fold: int, factory=None
                       ) -> Tuple[BagDataset, BagDataset, BagDataset]:
    """The fold's datasets. ``factory(sub_manifest, is_train)`` overrides
    the default store-backed BagDataset."""
    subs = resolve_fold_manifests(manifest, cfg, fold)
    if factory is None:
        factory = lambda s, is_train: BagDataset(s.slide_ids, s.labels,
                                                 store, cfg.bags)
    return tuple(factory(s, i == 0)
                 for i, s in enumerate(subs))  # type: ignore[return-value]


def fold_range(cfg) -> range:
    """The folds that k_start / k_end select (-1: the first / last)."""
    k_start = cfg.train.k_start if cfg.train.k_start != -1 else 0
    k_end = cfg.train.k_end if cfg.train.k_end != -1 else cfg.train.k
    return range(k_start, k_end)


def summary_csv_name(cfg) -> str:
    """summary.csv, or summary_partial_{s}_{e}.csv for a partial fold range
    (reference: main.py:285-293), so a partial run never overwrites a full
    one."""
    folds = fold_range(cfg)
    if len(folds) == cfg.train.k:
        return "summary.csv"
    return f"summary_partial_{folds.start}_{folds.stop}.csv"


def run_cv(cfg, manifest, store, *, verbose: bool = True, device="cuda"):
    """Sequential k-fold CV on ``device`` (reference: main.py:231-293).
    Returns (summary DataFrame, fold results)."""
    import pandas as pd
    os.makedirs(cfg.results_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.results_dir,
                          f"experiment_{cfg.exp_code}.json"))
    class_counts = manifest.class_counts()
    results: List[FoldResult] = []
    for fold in fold_range(cfg):
        train_ds, val_ds, test_ds = make_fold_datasets(manifest, store, cfg,
                                                       fold)
        res = train_fold(cfg, fold, train_ds, val_ds, test_ds, class_counts,
                         verbose=verbose, device=device)
        results.append(res)
        _write_fold_csv(cfg.results_dir, res)
    summary = pd.DataFrame({
        "folds": [r.fold for r in results],
        "test_auc": [r.test_auc for r in results],
        "val_auc": [r.val_auc for r in results],
        "test_acc": [r.test_acc for r in results],
        "val_acc": [r.val_acc for r in results],
    })
    summary.to_csv(os.path.join(cfg.results_dir, summary_csv_name(cfg)),
                   index=False)
    return summary, results


def _write_fold_csv(results_dir: str, res: FoldResult) -> None:
    """Per-slide fold results (reference: eval.py fold_k.csv: slide_id, Y,
    Y_hat, p_0..p_{C-1}), in the layout pandas writes: probabilities as
    their float32 repr."""
    probs = np.asarray(res.test_probs, np.float32)
    with open(os.path.join(results_dir, f"fold_{res.fold}.csv"), "w",
              newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["slide_id", "Y", "Y_hat"]
                   + [f"p_{c}" for c in range(probs.shape[1])])
        for sid, y, p in zip(res.test_slide_ids, res.test_labels, probs):
            w.writerow([sid, int(y), int(p.argmax())] + [str(v) for v in p])
