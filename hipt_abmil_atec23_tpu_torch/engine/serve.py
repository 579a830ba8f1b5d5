"""Serving: drain a watch folder of slides through tile -> HIPT_4K encode ->
CLAM_SB, on the port.

Counterpart of hipt_abmil_atec23_tpu/engine/serve.py ``serve_once`` /
``serve_forever``. The framework-neutral parts are the JAX package's own
(ServeConfig, discover, the journal helpers, the slide readers,
segmentation, coordinates and the blockmap writer), so both
packages keep one journal format and one set of output schemas: per-slide
``results/<id>.json``, ``results/<id>_blockmap.h5`` (reference
create_heatmaps.py:379-381) and an appended ``predictions.jsonl``.

Slides that arrive together ride one encode_stream pipeline; a mid-stream
failure falls back to one stream per unfinished slide, so only the slide
that fails is journaled 'error'.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from hipt_abmil_atec23_tpu.engine.serve import (  # noqa: F401 (re-exported)
    ServeConfig, _journal_append, discover, load_journal)


@dataclass
class ServeState:
    """Heavy objects shared across drains, built on first use on
    ``device``; tests inject a prebuilt encoder or model."""
    device: torch.device
    encoder: object = None
    model: object = None


def _ensure_state(cfg: ServeConfig, state: ServeState) -> None:
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        clam_state_dict_from_torch, load_torch_state_dict)
    state.device = resolve_device(state.device)
    if state.encoder is None:
        state.encoder = build_encoder(cfg.encoder, device=state.device)
    if state.model is None:
        if not cfg.ckpt_path.endswith(".pt"):
            raise NotImplementedError(
                f"{cfg.ckpt_path!r}: the port loads reference-layout torch "
                ".pt CLAM checkpoints; flax .msgpack checkpoints are not "
                "ported yet")
        model = build_mil_model(cfg.model.model_type,
                                size_arg=cfg.model.model_size,
                                n_classes=cfg.n_classes, gate=cfg.model.gate)
        if model.size[0] != state.encoder.feat_dim:
            raise ValueError(
                f"MIL head {cfg.model.model_size!r} takes {model.size[0]}-d "
                f"features, the encoder gives {state.encoder.feat_dim}")
        # reference eval loader key cleanup (utils/eval_utils.py:51-57)
        model.load_state_dict(clam_state_dict_from_torch(
            load_torch_state_dict(cfg.ckpt_path, checkpoint_key=None)))
        state.model = model.to(state.device).eval()


def _mil_bucketed(state: ServeState, feats: np.ndarray):
    """MIL forward through apply_pooled on a bag padded to a power-of-2
    bucket >= 512 (the JAX package's static-shape buckets)."""
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled)
    from hipt_abmil_atec23_tpu_torch.ops.masking import pad_bag
    n_pad = max(512, 1 << (max(len(feats), 1) - 1).bit_length())
    bag, mask = pad_bag(feats, n_pad)
    with torch.inference_mode():
        return apply_pooled(state.model,
                            torch.from_numpy(bag).to(state.device),
                            torch.from_numpy(mask).to(state.device))


def serve_once(cfg: ServeConfig, state: ServeState, *,
               verbose: bool = True) -> List[Dict]:
    """Drain every pending slide through one encode_stream pipeline.
    Returns the per-slide prediction records written this drain."""
    from hipt_abmil_atec23_tpu.explain.heatmaps import save_blockmap
    from hipt_abmil_atec23_tpu.slideio.patching import enumerate_coords
    from hipt_abmil_atec23_tpu.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu.slideio.seg import segment_tissue
    from hipt_abmil_atec23_tpu_torch.engine import encode

    os.makedirs(cfg.out_dir, exist_ok=True)
    results_dir = os.path.join(cfg.out_dir, "results")
    os.makedirs(results_dir, exist_ok=True)

    pending = discover(cfg)
    if not pending:
        return []
    _ensure_state(cfg, state)

    # host-side prep: seg + coords per slide; all slides join ONE stream
    jobs, slides, coord_map, records = [], [], {}, []
    for fname in pending:
        sid = os.path.splitext(fname)[0]
        if sid in coord_map:
            # the file stem is the journal/artifact key: a second file with
            # the same stem would pair its features with the first's coords
            if verbose:
                print(f"[serve] {fname}: SKIPPED — duplicate slide_id "
                      f"'{sid}' in this drain")
            continue
        slide = None
        try:
            slide = open_slide(os.path.join(cfg.slide_dir, fname))
            seg = segment_tissue(slide, cfg.tile.seg)
            coords = enumerate_coords(slide, seg, cfg.tile)
        except Exception as e:  # unreadable file: journal and keep serving
            if slide is not None:
                slide.close()
            _journal_append(cfg, sid, "error", repr(e))
            if verbose:
                print(f"[serve] {sid}: ERROR {e!r}")
            continue
        if len(coords) == 0:
            slide.close()
            _journal_append(cfg, sid, "failed_seg")
            records.append({"slide_id": sid, "status": "failed_seg"})
            if verbose:
                print(f"[serve] {sid}: no tissue, failed_seg")
            continue
        slides.append(slide)
        coord_map[sid] = coords
        jobs.append((sid, slide, coords))

    store = None
    if cfg.save_features:
        from hipt_abmil_atec23_tpu.data.bags import FeatureBagStore
        store = FeatureBagStore(os.path.join(cfg.out_dir, "features"))

    jsonl = open(os.path.join(cfg.out_dir, "predictions.jsonl"), "a")
    finished = set()

    def _finish(sid, feats):
        """Score + persist one encoded slide."""
        t_done = time.time()
        coords = coord_map[sid]
        out = _mil_bucketed(state, feats)
        y_prob = out.y_prob[0].float().cpu().numpy()
        scores = out.a_raw[0].float().cpu().numpy()[:len(coords)]
        order = np.argsort(scores)[::-1][:cfg.top_k]
        rec = {
            "slide_id": sid,
            "status": "done",
            "y_hat": int(out.y_hat[0]),
            "p": [float(v) for v in y_prob],
            "n_regions": int(len(coords)),
            "top_regions": [
                [int(coords[i][0]), int(coords[i][1]), float(scores[i])]
                for i in order],
            "time": t_done,
        }
        save_blockmap(os.path.join(results_dir, f"{sid}_blockmap.h5"),
                      coords, scores)
        if store is not None:
            store.save(sid, feats, coords=coords)
        with open(os.path.join(results_dir, f"{sid}.json"), "w") as f:
            json.dump(rec, f, indent=2)
        # journal 'done' before the jsonl append: a failed append must not
        # make the fallback (or the next drain) score the slide twice
        _journal_append(cfg, sid, "done")
        finished.add(sid)
        jsonl.write(json.dumps(rec) + "\n")
        jsonl.flush()
        records.append(rec)
        if verbose:
            print(f"[serve] {sid}: pred {rec['y_hat']} p={rec['p']} "
                  f"({rec['n_regions']} regions)")

    try:
        try:
            for sid, feats in encode.encode_stream(
                    jobs, state.encoder, region_size=cfg.tile.patch_size,
                    patch_level=cfg.tile.patch_level):
                _finish(sid, feats)
        except Exception as e:
            # isolate: serve each unfinished slide through its own stream,
            # so only the slide that fails collects an 'error' attempt
            if verbose:
                print(f"[serve] grouped stream failed ({e!r}); "
                      f"isolating per slide")
            for job in jobs:
                sid = job[0]
                if sid in finished:
                    continue
                try:
                    for s2, feats in encode.encode_stream(
                            [job], state.encoder,
                            region_size=cfg.tile.patch_size,
                            patch_level=cfg.tile.patch_level):
                        _finish(s2, feats)
                except Exception as e2:
                    if sid in finished:
                        continue  # failed after its own yield — it's done
                    _journal_append(cfg, sid, "error", f"stream: {e2!r}")
                    if verbose:
                        print(f"[serve] {sid}: ERROR {e2!r}")
    finally:
        jsonl.close()
        for s in slides:
            s.close()
    return records


def serve_forever(cfg: ServeConfig, *, device, stop=None,
                  verbose: bool = True,
                  max_drains: Optional[int] = None) -> int:
    """Polling daemon: drain, sleep ``poll_s``, repeat. ``stop``: optional
    threading.Event; ``max_drains`` bounds the loop. Returns the number of
    slides scored."""
    state = ServeState(device=device)
    served = 0
    drains = 0
    while True:
        try:
            recs = serve_once(cfg, state, verbose=verbose)
            served += sum(1 for r in recs if r.get("status") == "done")
        except Exception as e:
            # a daemon outlives any single drain; per-slide faults are
            # already journaled inside serve_once
            if verbose:
                print(f"[serve] drain failed: {e!r}")
        drains += 1
        if max_drains is not None and drains >= max_drains:
            return served
        if stop is not None and stop.wait(cfg.poll_s):
            return served
        if stop is None:
            time.sleep(cfg.poll_s)
