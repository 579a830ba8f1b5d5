"""The configuration dataclasses the port reads.

The port's own copy of hipt_abmil_atec23_tpu/utils/config.py, cut to the
classes tiling, encoding, serving, bag storage and full-bag training need,
and the segmentation presets.
Field names and defaults are the JAX package's, so one config dictionary
drives both packages.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def load_config_dict(path: str) -> Dict[str, Any]:
    """Read a JSON or YAML config file as a dict."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        d = yaml.safe_load(text)
    else:
        try:
            d = json.loads(text)
        except json.JSONDecodeError:
            import yaml
            d = yaml.safe_load(text)
    if not isinstance(d, dict):
        raise ValueError(f"config {path!r} did not parse to a mapping")
    return d


def _from_dict(cls, d: Dict[str, Any]):
    # `from __future__ import annotations` stringifies field types; resolve
    # them so nested dataclasses rebuild from nested dicts
    hints = typing.get_type_hints(cls)
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = hints.get(k, names[k].type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif isinstance(v, list) and typing.get_origin(ftype) is tuple:
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


@dataclass
class SegConfig:
    """Tissue segmentation parameters (reference: create_patches_fp.py:231-266
    and presets/*.csv)."""
    seg_level: int = -1          # -1: auto-pick level closest to 64x downsample
    sthresh: int = 8             # saturation threshold
    sthresh_up: int = 255
    mthresh: int = 7             # median blur kernel
    use_otsu: bool = False
    close: int = 4               # morphological closing kernel (0 = off)
    a_t: int = 100               # min foreground contour area (rel. to 512px ref)
    a_h: int = 16                # min hole area
    max_n_holes: int = 8
    exclude_ids: Tuple[str, ...] = ()
    keep_ids: Tuple[str, ...] = ()


@dataclass
class TileConfig:
    """Patch-coordinate enumeration (reference: create_patches_fp.py flags)."""
    patch_size: int = 256
    step_size: int = 256
    patch_level: int = 0
    contour_fn: str = "four_pt"  # four_pt | four_pt_hard | center | basic
    pad_slide: bool = False
    use_padding: bool = True     # pad contour bbox to full grid
    white_thresh: int = 5
    black_thresh: int = 50
    seg: SegConfig = field(default_factory=SegConfig)


@dataclass
class EncoderConfig:
    """Frozen feature extractor (reference: extract_features_fp.py:176-214)."""
    model_type: str = "HIPT_4K"  # resnet18 | resnet50 | levit_128s | HIPT_4K | vit256
    pretraining_dataset: str = "ImageNet"  # ImageNet | Histo
    transforms: str = "HIPT"     # one of the 10 named presets
    batch_size: int = 32         # regions (HIPT) or patches (resnet) per device step
    target_patch_size: int = -1
    vit256_ckpt: Optional[str] = None
    vit4k_ckpt: Optional[str] = None
    resnet_ckpt: Optional[str] = None
    levit_ckpt: Optional[str] = None  # original-layout LeViT torch ckpt
    dtype: str = "bfloat16"
    hipt_features: str = "cls4k"  # cls4k | mean256 | concat (576-d)


@dataclass
class ModelConfig:
    """Trainable MIL head (reference: utils/core_utils.py:156-189)."""
    model_type: str = "clam_sb"       # clam_sb | clam_mb | mil
    model_size: str = "hipt_smaller"  # key into MIL_SIZE_DICT
    drop_out: float = 0.0
    gate: bool = True
    subtyping: bool = False
    k_sample: int = 8                 # reference flag --B
    no_inst_cluster: bool = False     # True => pure ABMIL


@dataclass
class BagConfig:
    """Feature-bag assembly (reference: datasets/dataset_generic.py:448-578)."""
    feat_dir: str = ""
    max_patches_per_slide: int = 75
    sampling_with_replacement: bool = True  # matches np.random.choice default
    perturb_variance: float = 0.0
    number_of_augs: int = 0
    use_h5: bool = False
    batch_size: int = 1        # bags per optimizer step (1 == reference-faithful)
    bucket_sizes: Tuple[int, ...] = ()  # pad-to sizes; empty => single max bucket


@dataclass
class TrainConfig:
    """Optimization loop (reference: main.py flags + utils/core_utils.py:102-297)."""
    lr: float = 1e-3
    reg: float = 0.5            # Adam weight_decay in reference get_optim
    opt: str = "adam"           # adam | sgd
    max_epochs: int = 100
    min_epochs: int = 50
    early_stopping: bool = True
    patience: int = 50
    stop_epoch: int = 50
    bag_loss: str = "ce"        # ce | balanced_ce | svm(topk)
    bag_weight: float = 0.7
    inst_loss: str = "ce"
    weighted_sample: bool = True
    seed: int = 1
    k: int = 5
    k_start: int = -1
    k_end: int = -1
    continue_training: bool = False
    fold_parallel: bool = False  # shard folds across the device mesh
    epoch_chunk: int = 1         # epochs fused per device dispatch


@dataclass
class TaskConfig:
    """Task registry entry (reference: main.py:443-462, create_splits_seq.py:24-168)."""
    name: str = "treatment"
    n_classes: int = 2
    label_dict: Dict[str, int] = field(default_factory=lambda: {"invalid": 0, "effective": 1})
    csv_path: str = ""
    ignore: Tuple[str, ...] = ()
    patient_strat: bool = False
    patient_voting: str = "max"


@dataclass
class ExperimentConfig:
    exp_code: str = "exp"
    results_dir: str = "./results"
    split_dir: str = ""
    data_root_dir: str = ""
    task: TaskConfig = field(default_factory=TaskConfig)
    bags: BagConfig = field(default_factory=BagConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    tile: TileConfig = field(default_factory=TileConfig)
    log_data: bool = False
    profile: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return _from_dict(cls, d)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        return cls.from_dict(load_config_dict(path))


# Named segmentation presets mirroring the reference's preset CSVs
# (reference: presets/betterseg.csv, presets/bwh_biopsy.csv, ...).
SEG_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    "betterseg": {"sthresh": 15, "mthresh": 5, "close": 100, "use_otsu": True},
    "bwh_biopsy": {"sthresh": 15, "mthresh": 11, "close": 2, "use_otsu": True},
}


def apply_seg_preset(cfg: SegConfig, preset: str) -> SegConfig:
    """Apply a named preset, or load a reference-format preset CSV when
    `preset` is a path (reference: presets/*.csv, create_patches_fp.py:303-315)."""
    if preset in SEG_PRESETS:
        return dataclasses.replace(cfg, **SEG_PRESETS[preset])
    if preset.endswith(".csv"):
        import pandas as pd
        row = pd.read_csv(preset).iloc[0]
        fields = {f.name for f in dataclasses.fields(SegConfig)}
        overrides = {}
        for k, v in row.items():
            if k in fields and not pd.isna(v):
                cur = getattr(cfg, k)
                overrides[k] = type(cur)(v) if not isinstance(cur, tuple) else cur
        return dataclasses.replace(cfg, **overrides)
    raise KeyError(f"unknown preset {preset!r}; named: {sorted(SEG_PRESETS)} "
                   f"or a preset CSV path")
