"""Task registry: classification tasks with their label dictionaries.

The port's own copy of hipt_abmil_atec23_tpu/data/tasks.py. It mirrors the capability surface of the reference's hard-coded registries
(reference: main.py:443-462, eval.py:122-139, and the 12-task superset in
create_splits_seq.py:16-168). ``treatment_switched`` flips the binary mapping
(reference: eval.py --treatment_switched flag).
"""
from __future__ import annotations

from typing import Dict

from hipt_abmil_atec23_tpu_torch.utils.config import TaskConfig

_OVARIAN_5 = {"high_grade": 0, "low_grade": 1, "clear_cell": 2,
              "endometrioid": 3, "mucinous": 4}

TASKS: Dict[str, TaskConfig] = {
    "treatment": TaskConfig(
        name="treatment", n_classes=2,
        label_dict={"invalid": 0, "effective": 1}),
    "treatment_switched": TaskConfig(
        name="treatment_switched", n_classes=2,
        label_dict={"invalid": 1, "effective": 0}),
    "ovarian_5class": TaskConfig(
        name="ovarian_5class", n_classes=5,
        label_dict={"high_grade": 0, "low_grade": 1, "clear_cell": 2,
                    "endometrioid": 3, "mucinous": 4}),
    "ovarian_1vsall": TaskConfig(
        name="ovarian_1vsall", n_classes=2,
        label_dict={"high_grade": 0, "low_grade": 1, "clear_cell": 1,
                    "endometrioid": 1, "mucinous": 1}),
    "nsclc": TaskConfig(
        name="nsclc", n_classes=2,
        label_dict={"luad": 0, "lusc": 1}),
    # split-generation superset (reference: create_splits_seq.py:24-168)
    "task_1_tumor_vs_normal": TaskConfig(
        name="task_1_tumor_vs_normal", n_classes=2,
        label_dict={"normal_tissue": 0, "tumor_tissue": 1}),
    "task_2_tumor_subtyping": TaskConfig(
        name="task_2_tumor_subtyping", n_classes=3,
        label_dict={"subtype_1": 0, "subtype_2": 1, "subtype_3": 2}),
    "esgo_staging": TaskConfig(
        name="esgo_staging", n_classes=5, label_dict=_OVARIAN_5,
        patient_strat=True),
    "esgo_all": TaskConfig(
        name="esgo_all", n_classes=5, label_dict=_OVARIAN_5),
}

# Dataset-size variants the reference registers as separate tasks over the
# same ovarian 5-class labels (custom/custom_20/custom_556/custom_714/
# custom_912_aug/custom_998/canadian — create_splits_seq.py:34-143). They
# differ only by CSV; register them programmatically.
for _name in ("custom", "custom_20", "custom_556", "custom_714",
              "custom_912_aug", "custom_998", "canadian"):
    TASKS[_name] = TaskConfig(name=_name, n_classes=5,
                              label_dict=dict(_OVARIAN_5))


def get_task(name: str) -> TaskConfig:
    if name not in TASKS:
        raise KeyError(
            f"unknown task {name!r}; registered: {sorted(TASKS)}")
    return TASKS[name]


def register_task(cfg: TaskConfig) -> None:
    TASKS[cfg.name] = cfg
