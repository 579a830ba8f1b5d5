"""Feature extraction: slides + coords -> per-slide HIPT_4K feature bags.

Counterpart of hipt_abmil_atec23_tpu/engine/encode.py for the pixel rungs:

  one decode worker (native threaded region reads, ``prefetch`` batches
  ahead) -> pinned host tensors -> H2D on a dedicated CUDA stream ->
  encoder on the current stream, collected one batch deep

Each region rides the raw YCbCr plane rung when the slide offers one (1.5
bytes/px for 4:2:0, RGB rebuilt on the device by ops/yuv.py) and the RGB
rung (3 bytes/px) otherwise. Without the sparse-DCT rung the planes always
ship fewer bytes and decode cheaper on the host, so the JAX package's
cost-model rung selector is not needed here.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from hipt_abmil_atec23_tpu.utils.config import EncoderConfig
from hipt_abmil_atec23_tpu_torch.device import resolve_device
from hipt_abmil_atec23_tpu_torch.models.hipt import (
    hipt_eval_normalize, make_hipt_encoder)
from hipt_abmil_atec23_tpu_torch.ops.yuv import yuv_planes_to_rgb


@dataclass
class Encoder:
    """A fixed-batch region encoder on one device: uint8 RGB [B, S, S, 3]
    or YCbCr planes -> [B, feat_dim] f32, the normalize fused in."""
    model: nn.Module
    batch_size: int
    input_size: int      # spatial size S of one region
    feat_dim: int
    device: torch.device

    def apply(self, batch_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(hipt_eval_normalize(batch_u8))

    def apply_yuv(self, y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
        """Raw-plane entry: Y [B, S, S], Cb/Cr at 4:2:0 or 4:2:2."""
        with torch.inference_mode():
            return self.model(yuv_planes_to_rgb(y, cb, cr) / 127.5 - 1.0)


def build_encoder(cfg: EncoderConfig, *, device, model: nn.Module = None,
                  state_dict=None, seed: int = 0) -> Encoder:
    """HIPT_4K encoder (cls4k features) on ``device``.

    ``model``: a prebuilt models.hipt.HIPT4K (tests pass narrow ones);
    otherwise the full-width vit_small + vit4k_xs at ``cfg.dtype``, with
    seeded random weights unless ``state_dict`` or the DINO checkpoints in
    ``cfg`` (vit256_ckpt, vit4k_ckpt) are given."""
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        load_dino_, load_torch_state_dict)
    device = resolve_device(device)
    if cfg.model_type not in ("HIPT_4K", "hipt_4k"):
        raise NotImplementedError(
            f"encoder {cfg.model_type!r}: only HIPT_4K is ported")
    if cfg.hipt_features != "cls4k":
        raise NotImplementedError(
            f"hipt_features={cfg.hipt_features!r}: only cls4k is ported")
    if model is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        model = make_hipt_encoder(
            dtype, generator=torch.Generator().manual_seed(seed))
        if state_dict is None and cfg.vit256_ckpt and cfg.vit4k_ckpt:
            load_dino_(model, load_torch_state_dict(cfg.vit256_ckpt),
                       load_torch_state_dict(cfg.vit4k_ckpt))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).eval()
    return Encoder(model=model, batch_size=cfg.batch_size, input_size=4096,
                   feat_dim=model.feat_dim, device=device)


def _pad_to(batch: np.ndarray, k: int, bs: int) -> np.ndarray:
    """Pad a decoded tail batch of k items up to the encoder's batch."""
    if k < bs:
        pad = np.zeros((bs - k,) + batch.shape[1:], batch.dtype)
        batch = np.concatenate([batch, pad])
    return batch


def _decode_batch(slide, chunk, *, patch_level, size, bs, n_io_threads,
                  use_yuv=None):
    """Read one batch of regions: the raw planes when ``use_yuv`` is the
    slide's chroma layout (sh, sv), RGB otherwise or when the plane read
    refuses these coords (odd origins); tail-padded to ``bs``."""
    k = len(chunk)
    if use_yuv:
        try:
            if hasattr(slide, "read_regions_planes"):
                yp, cb, cr = slide.read_regions_planes(
                    chunk, patch_level, (size, size),
                    n_threads=n_io_threads or k, layout=tuple(use_yuv))
            else:
                yp, cb, cr = slide.read_regions_yuv420(
                    chunk, patch_level, (size, size),
                    n_threads=n_io_threads or k)
            return (_pad_to(yp, k, bs), _pad_to(cb, k, bs),
                    _pad_to(cr, k, bs))
        except IOError:
            pass  # odd-aligned coords etc. — the RGB read below
    batch = slide.read_regions(chunk, patch_level, (size, size),
                               n_threads=n_io_threads or k)
    return _pad_to(batch, k, bs)


def _batches(coords: np.ndarray, batch: int) -> Iterable[np.ndarray]:
    for i in range(0, len(coords), batch):
        yield coords[i:i + batch]


def _drain_in_order(jobs, feats, remaining, next_yield, feat_dim):
    """Collect (slide_id, feats) for every job complete at the head of the
    job order (empty jobs complete with a zero-row bag); returns (ready,
    advanced cursor)."""
    ready = []
    while next_yield < len(jobs):
        sid, _, coords = jobs[next_yield]
        if len(coords) == 0:
            ready.append((sid, np.zeros((0, feat_dim), np.float32)))
        elif remaining[next_yield] == 0:
            ready.append((sid, feats[next_yield]))
        else:
            break
        next_yield += 1
    return ready, next_yield


def _plane_layout(slide, patch_level: int):
    """(sh, sv) when the slide has a raw-plane read at this level."""
    probe = getattr(slide, "yuv_layout", None)
    if probe is not None:
        return probe(patch_level)
    if getattr(slide, "supports_yuv420", lambda lvl: False)(patch_level):
        return (2, 2)  # duck-typed 4:2:0-only slide classes
    return None


def encode_stream(jobs, encoder: Encoder, *, patch_level: int = 0,
                  region_size: Optional[int] = None, n_io_threads: int = 0,
                  prefetch: int = 3):
    """Encode a sequence of slides through one continuous pipeline.

    ``jobs``: (slide_id, slide, coords) triples. Yields (slide_id,
    feats [N, D] f32) in job order as each slide's last batch completes.
    The decode window and the H2D stream run across slide boundaries, so the
    device does not drain between slides.

    On a CUDA encoder the decode worker pins each batch; the main loop
    issues its H2D on a dedicated copy stream, makes the current stream
    wait on that copy's event, dispatches the encoder and the D2H of its
    features there, and only then collects the previous batch, so batch
    i+1's transfer overlaps batch i's compute. On a CPU encoder the same
    loop runs without pinning or streams.
    """
    size = region_size or encoder.input_size
    bs = encoder.batch_size
    dev = encoder.device
    cuda = dev.type == "cuda"
    jobs = list(jobs)

    items = []
    for ji, (sid, slide, coords) in enumerate(jobs):
        use_yuv = _plane_layout(slide, patch_level) if size % 2 == 0 else None
        for chunk in _batches(coords, bs):
            items.append((ji, slide, chunk, use_yuv))
    feats = [np.empty((len(c), encoder.feat_dim), np.float32)
             for _, _, c in jobs]
    remaining = [max(1, -(-len(c) // bs)) for _, _, c in jobs]
    offs = [0] * len(jobs)
    if not items:
        for sid, _, c in jobs:
            yield sid, np.zeros((0, encoder.feat_dim), np.float32)
        return

    def read_batch(item):
        _, slide, chunk, use_yuv = item
        buf = _decode_batch(slide, chunk, patch_level=patch_level, size=size,
                            bs=bs, n_io_threads=n_io_threads, use_yuv=use_yuv)
        host = tuple(torch.from_numpy(a) for a in
                     (buf if isinstance(buf, tuple) else (buf,)))
        if cuda:
            host = tuple(t.pin_memory() for t in host)
        return isinstance(buf, tuple), host

    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def to_device(host):
        if not cuda:
            return host
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(copy_stream):
            on_dev = tuple(t.to(dev, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        compute.wait_event(ready)
        for t in on_dev:  # allocated on the copy stream, read on compute
            t.record_stream(compute)
        return on_dev

    def to_host(out):
        # D2H queued right behind this batch's compute, into pinned memory,
        # so collecting it later never waits on the batch queued after it
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return host, done

    def collect(pend):
        ji, k, host, done = pend
        if done is not None:
            done.synchronize()
        feats[ji][offs[ji]:offs[ji] + k] = host[:k].float().numpy()
        offs[ji] += k
        remaining[ji] -= 1

    window = max(1, prefetch)
    next_yield = 0
    pending = None
    # ONE decode worker: read_regions parallelises internally; the window
    # is prefetch depth, not decode concurrency
    ex = ThreadPoolExecutor(max_workers=1)
    futures = [ex.submit(read_batch, it) for it in items[:window]]
    try:
        for ci, (ji, _, chunk, _) in enumerate(items):
            planes, host = futures[ci].result()
            if ci + window < len(items):
                futures.append(ex.submit(read_batch, items[ci + window]))
            bufs = to_device(host)
            out = encoder.apply_yuv(*bufs) if planes else encoder.apply(bufs[0])
            if pending is not None:
                collect(pending)
                ready, next_yield = _drain_in_order(
                    jobs, feats, remaining, next_yield, encoder.feat_dim)
                yield from ready
            pending = (ji, len(chunk), *to_host(out))
        collect(pending)
        ready, next_yield = _drain_in_order(jobs, feats, remaining,
                                            next_yield, encoder.feat_dim)
        yield from ready
    finally:
        # runs on completion and on abandonment (GeneratorExit / consumer
        # exception). wait=True: an in-flight native read still holds the
        # slide handles the caller closes the moment this returns;
        # cancel_futures drops the batches not yet started.
        ex.shutdown(wait=True, cancel_futures=True)


def encode_slide(slide, coords: np.ndarray, encoder: Encoder, *,
                 patch_level: int = 0, region_size: Optional[int] = None,
                 n_io_threads: int = 0, prefetch: int = 3) -> np.ndarray:
    """Encode all coords of one slide -> [N, D] features (a one-slide
    encode_stream)."""
    out = dict(encode_stream([("_solo", slide, coords)], encoder,
                             patch_level=patch_level,
                             region_size=region_size,
                             n_io_threads=n_io_threads, prefetch=prefetch))
    return out["_solo"]
