"""Config-driven batch heatmap generation.

Counterpart of hipt_abmil_atec23_tpu/explain/driver.py (reference:
create_heatmaps.py + heatmaps/configs/config_template.yaml, namespaced
exp/data/patching/model/heatmap/sample arguments over a slide process
list). Per slide it segments (or loads the cached segmentation pickle),
enumerates a coarse non-overlapping grid, encodes features once (or reads
them from ``feat_dir``), scores the bag with the MIL head through
``apply_pooled`` (the pool kernel on the card), caches the attention
blockmap, rasterizes the heatmap, exports the top-k ROIs, and optionally
runs a fine overlapped pass that encodes only the coordinates the coarse
grid did not score.

MIL checkpoints are reference-layout torch ``.pt`` files or the JAX
package's flax ``.msgpack`` heads; the encoder is engine/encode.build_encoder
on ``device``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.explain.heatmaps import (
    draw_heatmap, infer_attention, sample_rois, save_blockmap)
from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, ModelConfig, SegConfig, TileConfig, _from_dict,
    load_config_dict)

SLIDE_EXTS = (".tif", ".tiff", ".svs", ".png", ".jpg")


@dataclass
class HeatmapJobConfig:
    """Mirrors the reference YAML's namespaces (create_heatmaps.py:104-112)."""
    # exp/data arguments
    slide_dir: str = ""
    slides: Tuple[str, ...] = ()            # filenames; empty => all in dir
    save_dir: str = "heatmaps"
    ckpt_path: str = ""
    feat_dir: str = ""                      # reuse cached features when present
    # patching arguments
    patch_size: int = 4096
    step_size: int = 4096
    patch_level: int = 0
    seg: SegConfig = field(default_factory=lambda: SegConfig(use_otsu=True))
    # model arguments
    model: ModelConfig = field(default_factory=ModelConfig)
    n_classes: int = 2
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # heatmap arguments
    vis_level: int = -1
    alpha: float = 0.4
    cmap: str = "coolwarm"
    blank_canvas: bool = False
    binarize: bool = False
    binary_thresh: float = 0.5
    use_seg_mask: bool = True
    # fine pass: overlapped grid with step = patch_size * fine_step_fraction
    fine_pass: bool = False
    fine_step_fraction: float = 0.5
    # sample arguments
    sample_topk: int = 8
    sample_mode: str = "topk"

    @classmethod
    def load(cls, path: str) -> "HeatmapJobConfig":
        return _from_dict(cls, load_config_dict(path))


def load_mil_head(ckpt_path: str, model_cfg: ModelConfig, n_classes: int,
                  feat_dim: int, device) -> torch.nn.Module:
    """The MIL head of a reference-layout torch ``.pt`` checkpoint, or of a
    flax checkpoint (any other name) the JAX package wrote, on ``device``,
    in eval mode (the JAX driver's ``_load_mil``, explain/driver.py:
    82-101)."""
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        load_mil_state_dict)
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    model = build_mil_model(model_cfg.model_type,
                            size_arg=model_cfg.model_size,
                            n_classes=n_classes, gate=model_cfg.gate)
    if model.size[0] != feat_dim:
        raise ValueError(f"MIL head {model_cfg.model_size!r} takes "
                         f"{model.size[0]}-d features, the bag has {feat_dim}")
    model.load_state_dict(load_mil_state_dict(
        ckpt_path, model_cfg.model_type, n_classes))
    return model.to(device).eval()


def run_heatmap_job(cfg: HeatmapJobConfig, *, device="cuda",
                    verbose: bool = True) -> List[Dict]:
    """Every slide of the job on ``device``; writes under
    ``cfg.save_dir/{slide}/`` the seg pickle, blockmap h5, heatmap jpg (and
    the fine pass's), the ROI pngs, and ``predictions.json`` over all."""
    import cv2
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.encode import (
        build_encoder, encode_slide)
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled)
    from hipt_abmil_atec23_tpu_torch.slideio.patching import enumerate_coords
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu_torch.slideio.seg import (
        SegmentationResult, segment_tissue)

    device = resolve_device(device)
    os.makedirs(cfg.save_dir, exist_ok=True)
    with open(os.path.join(cfg.save_dir, "heatmap_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    slides = list(cfg.slides) or sorted(
        f for f in os.listdir(cfg.slide_dir) if f.lower().endswith(SLIDE_EXTS))
    encoder = build_encoder(cfg.encoder, device=device)
    tile_cfg = TileConfig(patch_size=cfg.patch_size, step_size=cfg.step_size,
                          patch_level=cfg.patch_level, seg=cfg.seg)
    results = []
    model = None

    for fname in slides:
        sid = os.path.splitext(fname)[0]
        out_dir = os.path.join(cfg.save_dir, sid)
        os.makedirs(out_dir, exist_ok=True)
        slide = open_slide(os.path.join(cfg.slide_dir, fname))

        # 1. segmentation (cached pickle like reference initialize_wsi)
        seg_pkl = os.path.join(out_dir, f"{sid}_seg.pkl")
        if os.path.exists(seg_pkl):
            seg = SegmentationResult.load(seg_pkl)
        else:
            seg = segment_tissue(slide, cfg.seg)
            seg.save(seg_pkl)

        # 2. coarse grid + features (cache-aware)
        coords = enumerate_coords(slide, seg, tile_cfg)
        if len(coords) == 0:
            # no tissue found (reference marks failed_seg and continues)
            slide.close()
            results.append({"slide_id": sid, "y_hat": None, "p": None,
                            "n_patches": 0, "status": "failed_seg"})
            if verbose:
                print(f"[heatmap] {sid}: no tissue, skipped")
            continue
        feats = _features_for(cfg, encoder, slide, sid, coords)
        if model is None:
            model = load_mil_head(cfg.ckpt_path, cfg.model, cfg.n_classes,
                                  feats.shape[1], device)

        # 3. slide-level prediction + attention blockmap, the bag pooled
        # through apply_pooled (one pool kernel launch on the card)
        with torch.inference_mode():
            out = apply_pooled(model, torch.from_numpy(feats).to(device))
        y_hat = int(out.y_hat[0])
        y_prob = out.y_prob[0].float().cpu().numpy()
        scores = out.a_raw[0].float().cpu().numpy()
        save_blockmap(os.path.join(out_dir, f"{sid}_blockmap.h5"),
                      coords, scores)

        hm = draw_heatmap(
            slide, coords, scores, cfg.patch_size,
            patch_level=cfg.patch_level,
            vis_level=None if cfg.vis_level < 0 else cfg.vis_level,
            seg=seg if cfg.use_seg_mask else None, alpha=cfg.alpha,
            cmap=cfg.cmap, blank_canvas=cfg.blank_canvas,
            binarize=cfg.binarize, thresh=cfg.binary_thresh)
        cv2.imwrite(os.path.join(out_dir, f"{sid}_heatmap.jpg"),
                    cv2.cvtColor(hm, cv2.COLOR_RGB2BGR))

        # 4. ROI export
        rois = sample_rois(coords, scores, k=cfg.sample_topk,
                           mode=cfg.sample_mode)
        patches = slide.read_regions(rois["sampled_coords"], cfg.patch_level,
                                     (cfg.patch_size, cfg.patch_size))
        for j, (p, sc) in enumerate(zip(patches, rois["sampled_scores"])):
            small = cv2.resize(p, (min(1024, p.shape[1]),) * 2,
                               interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(out_dir, f"roi_{j}_{sc:.3f}.png"),
                        cv2.cvtColor(small, cv2.COLOR_RGB2BGR))

        # 5. optional fine overlapped pass; cached coarse attention is reused
        # for coords already scored, only new shifted coords are encoded
        if cfg.fine_pass:
            fine_step = max(1, int(cfg.patch_size * cfg.fine_step_fraction))
            fine_cfg = dataclasses.replace(tile_cfg, step_size=fine_step)
            fine_coords = enumerate_coords(slide, seg, fine_cfg)
            known = {tuple(c) for c in coords.tolist()}
            new_mask = np.array([tuple(c) not in known
                                 for c in fine_coords.tolist()], bool)
            new_coords = fine_coords[new_mask]
            all_coords, all_scores = coords, scores
            if len(new_coords):
                new_feats = encode_slide(slide, new_coords, encoder,
                                         patch_level=cfg.patch_level,
                                         region_size=cfg.patch_size)
                all_coords = np.concatenate([coords, new_coords])
                all_scores = np.concatenate(
                    [scores, infer_attention(model, new_feats)])
            fine_hm = draw_heatmap(
                slide, all_coords, all_scores, cfg.patch_size,
                patch_level=cfg.patch_level,
                seg=seg if cfg.use_seg_mask else None, alpha=cfg.alpha,
                cmap=cfg.cmap)
            cv2.imwrite(os.path.join(out_dir, f"{sid}_heatmap_fine.jpg"),
                        cv2.cvtColor(fine_hm, cv2.COLOR_RGB2BGR))

        slide.close()
        rec = {"slide_id": sid, "y_hat": y_hat,
               "p": [float(v) for v in y_prob], "n_patches": len(coords)}
        results.append(rec)
        if verbose:
            print(f"[heatmap] {sid}: pred {y_hat} p={y_prob} "
                  f"({len(coords)} patches)")
    with open(os.path.join(cfg.save_dir, "predictions.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def _features_for(cfg, encoder, slide, sid, coords) -> np.ndarray:
    """The slide's bag from ``cfg.feat_dir`` when stored there, else
    encoded now."""
    from hipt_abmil_atec23_tpu_torch.engine.encode import encode_slide
    if cfg.feat_dir:
        from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
        store = FeatureBagStore(cfg.feat_dir)
        if store.exists(sid):
            return store.load_features(sid)
    return encode_slide(slide, coords, encoder, patch_level=cfg.patch_level,
                        region_size=cfg.patch_size)
