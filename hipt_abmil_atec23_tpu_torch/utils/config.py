"""The configuration dataclasses the port's serving path reads.

The port's own copy of hipt_abmil_atec23_tpu/utils/config.py, cut to the
classes tiling, encoding, serving and bag storage need. Field names and
defaults are the JAX package's, so one config dictionary drives both
packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


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
