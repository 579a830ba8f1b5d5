"""K-fold cross-validation splits with the reference's semantics.

The port's own copy of hipt_abmil_atec23_tpu/data/splits.py (reference:
utils/utils.py:125-152 ``generate_split``): stratified k-fold over the
class labels; fold i's test set is split i, its val set is fold (i+1)'s
test set, and train is the rest. The JAX package draws the folds with
scikit-learn's ``StratifiedKFold(shuffle=True, random_state=seed)``; here
the same draw is made with numpy alone (scikit-learn 1.x
``_make_test_folds``), so one seed gives both packages the same folds. The
CSVs (ragged train/val/test slide-id columns, the boolean layout and the
per-class descriptor; reference: splits/*/splits_0.csv,
dataset_generic.py save_splits :16-28) are written with the stdlib ``csv``
module in pandas' layout.
"""
from __future__ import annotations

import csv
from typing import List, Sequence, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]  # train, val, test indices
_NAMES = ("train", "val", "test")


def stratified_test_folds(labels: np.ndarray, n_splits: int, seed: int,
                          shuffle: bool = True) -> np.ndarray:
    """Each sample's test fold, as scikit-learn's StratifiedKFold assigns
    it: classes encoded in order of first appearance, per-class fold sizes
    by round robin over the sorted labels, and each class's block of fold
    ids shuffled by one ``RandomState(seed)`` in class order."""
    y = np.asarray(labels)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_enc = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_enc)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    y_order = np.sort(y_enc)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    rng = np.random.RandomState(seed if shuffle else None)
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_enc == k] = folds_for_class
    return test_folds


def generate_kfold_splits(labels: np.ndarray, n_splits: int = 5,
                          seed: int = 7, shuffle: bool = True
                          ) -> List[Split]:
    """Stratified k-fold with val = the next fold's test (reference:
    utils/utils.py:142-152), always seeded."""
    indices = np.arange(len(labels))
    folds = stratified_test_folds(labels, n_splits, seed, shuffle)
    test_sets = [indices[folds == i] for i in range(n_splits)]
    splits: List[Split] = []
    for i in range(n_splits):
        test_ids = test_sets[i]
        val_ids = test_sets[(i + 1) % n_splits]
        excluded = set(test_ids) | set(val_ids)
        # int64 even when empty (k=2 leaves no train)
        train_ids = np.array([x for x in indices if x not in excluded],
                             dtype=np.int64)
        splits.append((train_ids, val_ids, test_ids))
    return splits


def save_split_csv(path: str, slide_ids: Sequence[str], split: Split) -> None:
    """The reference's splits_k.csv: ragged columns of slide ids under an
    unnamed row index, empty cells past a column's end."""
    cols = [[slide_ids[i] for i in ids] for ids in split]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", *_NAMES])
        for r in range(max(len(c) for c in cols)):
            w.writerow([r] + [c[r] if r < len(c) else "" for c in cols])


def save_split_bool_csv(path: str, slide_ids: Sequence[str],
                        split: Split) -> None:
    """Boolean-style split file (reference: save_splits(boolean_style=True),
    create_splits_seq.py:188)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", *_NAMES])
        for name, ids in zip(_NAMES, split):
            for i in ids:
                w.writerow([slide_ids[i]] + [name == n for n in _NAMES])


def save_split_descriptor(path: str, labels: np.ndarray, split: Split,
                          n_classes: int) -> None:
    """Per-class slide counts per split (reference: test_split_gen
    descriptor, create_splits_seq.py:190-194)."""
    counts = [np.bincount(labels[np.asarray(ids, dtype=np.int64)],
                          minlength=n_classes) for ids in split]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", *_NAMES])
        for c in range(n_classes):
            w.writerow([f"class_{c}"] + [int(n[c]) for n in counts])


def load_split_csv(path: str) -> Tuple[List[str], List[str], List[str]]:
    """A reference-format splits_k.csv back into slide-id lists."""
    out: Tuple[List[str], ...] = ([], [], [])
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            for name, ids in zip(_NAMES, out):
                if row.get(name):
                    ids.append(row[name])
    return out  # type: ignore[return-value]


def check_split_disjoint(split: Split) -> None:
    """Split-disjointness checks (reference: test_split_gen
    dataset_generic.py:294-331)."""
    train, val, test = (set(np.asarray(s).tolist()) for s in split)
    for a, b, what in ((train, val, "train/val"), (train, test, "train/test"),
                       (val, test, "val/test")):
        if a & b:
            raise ValueError(f"{what} overlap")
