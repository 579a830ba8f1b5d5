"""Serving: drain a watch folder of slides through tile -> HIPT_4K encode ->
a MIL head (any ``build_mil_model`` head), on the port.

Counterpart of hipt_abmil_atec23_tpu/engine/serve.py ``serve_once`` /
``serve_forever``. ServeConfig, discover, write_config and the journal
helpers are the port's own copies of the JAX package's, as are the slide
readers, segmentation, coordinates and the blockmap writer it calls
(slideio/, explain/heatmaps.py), so both packages keep one journal format
and one set of output schemas: a ``serve_journal.csv``, per-slide
``results/<id>.json``, ``results/<id>_blockmap.h5`` (reference
create_heatmaps.py:379-381) and an appended ``predictions.jsonl``.

Slides that arrive together ride one encode_stream pipeline; a mid-stream
failure falls back to one stream per unfinished slide, so only the slide
that fails is journaled 'error'.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, ModelConfig, SegConfig, TileConfig)

_DONE_STATUSES = ("done", "failed_seg")
SLIDE_EXTS = (".tif", ".tiff", ".svs", ".png", ".jpg", ".jpeg")


@dataclass
class ServeConfig:
    slide_dir: str
    out_dir: str
    ckpt_path: str                      # torch .pt, else a flax head
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    tile: TileConfig = field(default_factory=lambda: TileConfig(
        patch_size=4096, step_size=4096, seg=SegConfig(use_otsu=True)))
    n_classes: int = 2
    poll_s: float = 5.0                 # daemon poll interval
    save_features: bool = False         # persist bags in FeatureBagStore
    top_k: int = 8                      # top-attention regions per slide
    max_retries: int = 3                # 'error' attempts before parking
    min_stable_s: float = 10.0          # mtime age before a file is eligible


def _journal_path(cfg: ServeConfig) -> str:
    return os.path.join(cfg.out_dir, "serve_journal.csv")


def _journal_scan(cfg: ServeConfig):
    """One pass over the journal: (slide_id -> last status, slide_id ->
    ['error' row times], slide_id -> last row time). Row times let
    discover() tell a replaced file's old rows from its own."""
    path = _journal_path(cfg)
    status: Dict[str, str] = {}
    errors: Dict[str, list] = {}
    last_time: Dict[str, float] = {}
    if os.path.exists(path):
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                sid = row["slide_id"]
                try:
                    t = float(row.get("time") or 0.0)
                except ValueError:
                    t = 0.0
                status[sid] = row["status"]
                last_time[sid] = t
                if row["status"] == "error":
                    errors.setdefault(sid, []).append(t)
    return status, errors, last_time


def load_journal(cfg: ServeConfig) -> Dict[str, str]:
    """slide_id -> last status."""
    return _journal_scan(cfg)[0]


def _journal_append(cfg: ServeConfig, slide_id: str, status: str,
                    detail: str = "") -> None:
    path = _journal_path(cfg)
    os.makedirs(cfg.out_dir, exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["slide_id", "status", "time", "detail"])
        # microsecond precision: discover() compares row times to file
        # mtimes, and a coarser time can round below a fresh mtime
        w.writerow([slide_id, status, f"{time.time():.6f}", detail])


def discover(cfg: ServeConfig) -> List[str]:
    """Slide files in slide_dir not yet finished per the journal.

    A file younger than ``min_stable_s`` may still be uploading and waits.
    Journal rows older than the file's mtime belong to a replaced file, so
    a re-upload resets its retry budget and clears a stale 'done' or
    'failed_seg'. A slide with ``max_retries`` 'error' rows is parked."""
    journal, errors, last_time = _journal_scan(cfg)
    now = time.time()
    pending = []
    for fname in sorted(os.listdir(cfg.slide_dir)):
        if not fname.lower().endswith(SLIDE_EXTS):
            continue
        path = os.path.join(cfg.slide_dir, fname)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue  # vanished between listdir and stat
        if now - mtime < cfg.min_stable_s:
            continue  # possibly mid-upload; next poll will see it stable
        sid = os.path.splitext(fname)[0]
        replaced = mtime > last_time.get(sid, float("-inf"))
        if journal.get(sid) in _DONE_STATUSES and not replaced:
            continue
        n_err = sum(1 for t in errors.get(sid, ()) if t >= mtime)
        if n_err >= cfg.max_retries:
            continue
        pending.append(fname)
    return pending


@dataclass
class ServeState:
    """Heavy objects shared across drains, built on first use on
    ``device``; tests inject a prebuilt encoder or model."""
    device: torch.device
    encoder: object = None
    model: object = None


def _ensure_state(cfg: ServeConfig, state: ServeState) -> None:
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        load_mil_state_dict)
    from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    state.device = resolve_device(state.device)
    if state.encoder is None:
        state.encoder = build_encoder(cfg.encoder, device=state.device)
    if state.model is None:
        model = build_mil_model(cfg.model.model_type,
                                size_arg=cfg.model.model_size,
                                n_classes=cfg.n_classes, gate=cfg.model.gate)
        if model.size[0] != state.encoder.feat_dim:
            raise ValueError(
                f"MIL head {cfg.model.model_size!r} takes {model.size[0]}-d "
                f"features, the encoder gives {state.encoder.feat_dim}")
        # a .pt with the reference eval loader's key cleanup (utils/
        # eval_utils.py:51-57); any other name is a flax checkpoint, as in
        # the JAX package (engine/serve.py:179-192)
        model.load_state_dict(load_mil_state_dict(
            cfg.ckpt_path, cfg.model.model_type, cfg.n_classes))
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
    from hipt_abmil_atec23_tpu_torch.engine import encode
    from hipt_abmil_atec23_tpu_torch.explain.heatmaps import save_blockmap
    from hipt_abmil_atec23_tpu_torch.slideio.patching import enumerate_coords
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue

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
        from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
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
    slides scored. A head type ``build_mil_model`` does not know is refused
    before the first drain: a failed drain is logged and polled again, so
    it would never stop the daemon."""
    from hipt_abmil_atec23_tpu_torch.models.abmil import check_model_type
    check_model_type(cfg.model.model_type)
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


def write_config(cfg: ServeConfig) -> None:
    """Dump the effective serve config next to the journal, as the JAX
    package's write_config does (reference: the per-run config dump,
    create_heatmaps.py:95-101)."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "serve_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
