"""The tile stage: segment + patch + stitch over a slide directory.

The port's own copy of hipt_abmil_atec23_tpu/slideio/pipeline.py: the same
resume journal (``process_list_autogen.csv``) and patches/, masks/ and
stitches/ layout, so either package resumes the other's tile stage.

Capability parity with the reference's tile-stage script (reference:
create_patches_fp.py:47-229 seg_and_patch + wsi_core/batch_process_utils.py
initialize_df): per-slide parameter resolution (defaults < preset < per-slide
process-list overrides), idempotent resume (skip slides whose coords h5
exists; persist per-slide status tbp/processed/failed_seg/already_exist),
oversize-segmentation guard, per-stage wall timings.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from hipt_abmil_atec23_tpu_torch.slideio.patching import (
    enumerate_coords, save_coords_h5, coords_attrs)
from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue, draw_segmentation
from hipt_abmil_atec23_tpu_torch.slideio.stitch import stitch_coords
from hipt_abmil_atec23_tpu_torch.utils.config import SegConfig, TileConfig, apply_seg_preset

SLIDE_EXTS = (".tif", ".tiff", ".svs", ".png", ".jpg", ".jpeg")

# per-slide overridable columns (reference: batch_process_utils.py:17-68)
_SEG_COLS = ("seg_level", "sthresh", "mthresh", "close", "use_otsu",
             "a_t", "a_h", "max_n_holes")


@dataclass
class TileStageResult:
    df: pd.DataFrame
    total_time: float


def initialize_process_df(slides: List[str], cfg: TileConfig,
                          existing: Optional[pd.DataFrame] = None
                          ) -> pd.DataFrame:
    """Per-slide bookkeeping table with default params; merges an existing
    process list's overrides (reference: initialize_df,
    batch_process_utils.py:17-82)."""
    import pandas as pd
    rows = []
    for s in slides:
        row = {"slide_id": s, "process": 1, "status": "tbp"}
        for c in _SEG_COLS:
            row[c] = getattr(cfg.seg, c)
        rows.append(row)
    df = pd.DataFrame(rows)
    if existing is not None:
        existing = existing.set_index("slide_id")
        for i, s in enumerate(df["slide_id"]):
            if s in existing.index:
                for c in list(_SEG_COLS) + ["process", "status"]:
                    if c in existing.columns and not pd.isna(existing.loc[s, c]):
                        df.loc[i, c] = existing.loc[s, c]
    return df


def seg_and_patch(
    source: str,
    save_dir: str,
    cfg: TileConfig,
    *,
    preset: Optional[str] = None,
    process_list: Optional[str] = None,
    do_seg: bool = True,
    do_patch: bool = True,
    do_stitch: bool = True,
    save_masks: bool = True,
    auto_skip: bool = True,
    max_seg_pixels: float = 1e8,
    pad_slide: bool = False,
    verbose: bool = True,
) -> TileStageResult:
    import pandas as pd
    patch_dir = os.path.join(save_dir, "patches")
    mask_dir = os.path.join(save_dir, "masks")
    stitch_dir = os.path.join(save_dir, "stitches")
    for d in (patch_dir, mask_dir, stitch_dir):
        os.makedirs(d, exist_ok=True)

    if preset:
        cfg = dataclasses.replace(cfg, seg=apply_seg_preset(cfg.seg, preset))

    slides = sorted(f for f in os.listdir(source)
                    if f.lower().endswith(SLIDE_EXTS))
    existing = pd.read_csv(process_list) if process_list else None
    df = initialize_process_df(slides, cfg, existing)
    autogen = os.path.join(save_dir, "process_list_autogen.csv")

    t_start = time.perf_counter()
    seg_times = patch_times = stitch_times = 0.0
    for i in range(len(df)):
        df.to_csv(autogen, index=False)  # resume journal (reference :90)
        row = df.iloc[i]
        if int(row["process"]) != 1:
            continue
        slide_name = row["slide_id"]
        sid = os.path.splitext(slide_name)[0]
        h5_path = os.path.join(patch_dir, f"{sid}.h5")
        if auto_skip and os.path.exists(h5_path):
            df.loc[i, "status"] = "already_exist"
            continue
        if verbose:
            print(f"[tile] {i + 1}/{len(df)} {slide_name}")

        try:
            slide = open_slide(os.path.join(source, slide_name),
                               pad_to=4096 if pad_slide else 0)
        except Exception as e:
            df.loc[i, "status"] = "failed_seg"
            print(f"  open failed: {e}")
            continue

        seg_cfg = dataclasses.replace(
            cfg.seg,
            **{c: _coerce(row[c], getattr(cfg.seg, c)) for c in _SEG_COLS})
        seg_level = seg_cfg.seg_level
        if seg_level < 0:
            seg_level = slide.get_best_level_for_downsample(64)
        w, h = slide.level_dimensions[seg_level]
        if w * h > max_seg_pixels:
            # oversize guard (reference: create_patches_fp.py:179-183)
            df.loc[i, "status"] = "failed_seg"
            slide.close()
            continue

        try:
            t0 = time.perf_counter()
            seg = segment_tissue(slide, dataclasses.replace(
                seg_cfg, seg_level=seg_level)) if do_seg else None
            seg_times += time.perf_counter() - t0
            if save_masks and seg is not None:
                import cv2
                cv2.imwrite(os.path.join(mask_dir, f"{sid}.jpg"),
                            cv2.cvtColor(draw_segmentation(slide, seg),
                                         cv2.COLOR_RGB2BGR))
            if do_patch and seg is not None:
                t0 = time.perf_counter()
                coords = enumerate_coords(slide, seg, cfg)
                patch_times += time.perf_counter() - t0
                if len(coords):
                    save_coords_h5(h5_path, coords,
                                   coords_attrs(slide, cfg, sid, patch_dir))
                if do_stitch and len(coords):
                    t0 = time.perf_counter()
                    import cv2
                    canvas = stitch_coords(slide, coords, cfg.patch_size,
                                           cfg.patch_level)
                    cv2.imwrite(os.path.join(stitch_dir, f"{sid}.jpg"),
                                cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))
                    stitch_times += time.perf_counter() - t0
            df.loc[i, "status"] = "processed"
        except Exception as e:
            df.loc[i, "status"] = "failed_seg"
            print(f"  failed: {e}")
        finally:
            slide.close()

    df.to_csv(autogen, index=False)
    total = time.perf_counter() - t_start
    if verbose:
        n = max(1, (df["status"] == "processed").sum())
        print(f"[tile] seg {seg_times / n:.3f}s/slide, "
              f"patch {patch_times / n:.3f}s/slide, "
              f"stitch {stitch_times / n:.3f}s/slide")
    return TileStageResult(df=df, total_time=total)


def _coerce(v, default):
    import pandas as pd
    if pd.isna(v):
        return default
    return type(default)(v)
