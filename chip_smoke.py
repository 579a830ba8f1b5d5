"""Quickest proof that the PyTorch port (hipt_abmil_atec23_tpu_torch) runs its
serving path on an NVIDIA H100 through its hand-written CUDA kernels.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits non-zero, and no result line is printed):
  1. device: require CUDA; print the card's name and power limit.
  2. kernels: build both CUDA sources from the checkout (nvcc, sm_90a) and
     hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, with the stated tolerance; time both.
  3. slice: two in-memory 8192^2 slides (seeded H&E-like texture served as
     YCbCr 4:2:0 planes) through build_encoder (full-width HIPT_4K, bf16,
     seeded random weights, batch 2) -> encode_stream -> CLAM_SB
     hipt_smaller through apply_pooled. Launch counts are zeroed right
     before this run and must be non-zero after it. The features are held
     against a second pass of the same weights on the plain versions.
  4. serve: serve_once over two synthetic JPEG YCbCr 4:2:0 slides of 8192^2
     on disk (skipped, with a line saying what is missing, where cv2, h5py
     or the native reader's build dependencies are absent).
  5. profile (only with --profile PATH): where one warm encode_stream's
     time goes, stage by stage, and a torch.profiler kernel table, written
     to PATH.

    python3 chip_smoke.py --profile chiprun_out/profile.txt

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hipt_abmil_atec23_tpu.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu.utils.config import (
    EncoderConfig, ModelConfig, SegConfig, TileConfig)
from hipt_abmil_atec23_tpu_torch.device import require_cuda
from hipt_abmil_atec23_tpu_torch.engine.encode import (
    build_encoder, encode_stream)
from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
from hipt_abmil_atec23_tpu_torch.models.hipt import make_hipt_encoder
from hipt_abmil_atec23_tpu_torch.models.vit import Block
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)

BLOCK_TOL = (3e-2, 5e-2)   # |kernel - plain| <= atol + rtol |plain| (bf16)
POOL_TOL = 1e-4            # f32 logits and scores
REGION = 4096
SLIDE = 8192


def log(*a):
    print(*a, flush=True)


def gpu_timer(fn, iters: int = 10) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ------------------------------------------------------------------ phase 1
def phase_device() -> str:
    require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _random_block(d, heads, g, dev):
    blk = Block(d, heads, 4.0, 1e-6)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return blk.to(dev).eval()


def _random_clam(g, dev):
    model = build_mil_model("clam_sb", size_arg="hipt_smaller", n_classes=2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return model.to(dev).eval()


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the JSON records."""
    from hipt_abmil_atec23_tpu_torch.kernels import build
    t0 = time.perf_counter()
    for name in ("fused_block", "gated_pool"):
        build.load(name)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_DIR})")
    g = torch.Generator().manual_seed(0)
    records = {}

    # fused block: ViT-256 at the slice's batch (2 regions x 256 tiles),
    # the issue's 64-image shape, ViT-4K at batch 2, an odd small shape
    worst, timed = 0.0, None
    for b, n, nv, d, h in [(512, 264, 257, 384, 6), (64, 264, 257, 384, 6),
                           (2, 264, 257, 192, 6), (3, 16, 9, 96, 3)]:
        blk = _random_block(d, h, g, dev)
        x = torch.randn(b, n, d, generator=g).to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = fused_vit_block(x, blk, num_heads=h, n_valid=nv).float()
            want = fused_vit_block_reference(x, blk, num_heads=h,
                                             n_valid=nv).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= BLOCK_TOL[0] + BLOCK_TOL[1] * want.abs()).all()
                      and torch.isfinite(got).all())
            ms = gpu_timer(lambda: fused_vit_block(x, blk, num_heads=h,
                                                   n_valid=nv))
            pms = gpu_timer(lambda: fused_vit_block_reference(
                x, blk, num_heads=h, n_valid=nv), iters=3)
        log(f"fused_block [{b},{n},{d}] heads {h} n_valid {nv}: max_abs_err "
            f"{err.max().item():.6g} within bound {ok}; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
        if not ok:
            raise SystemExit(f"fused_block disagrees at [{b},{n},{d}]")
        worst = max(worst, err.max().item())
        if timed is None:
            timed = (ms, pms, f"[{b},{n},{d}] bf16")
        del blk, x, got, want, err
    records["fused_block"] = {
        "name": "fused_block", "route": "cuda",
        "source": "hipt_abmil_atec23_tpu_torch/kernels/csrc/fused_block.cu",
        "replaces": "hipt_abmil_atec23_tpu/ops/fused_block.py:60",
        "max_abs_err": worst, "ms": timed[0], "plain_ms": timed[1],
        "shape": timed[2]}

    # pool through apply_pooled: a 4096 bag, the serve path's 512 bucket
    # and a whole-slide 100k bag
    model = _random_clam(g, dev)
    p = gap.params_from_clam(model)
    worst, timed = 0.0, None
    for n in (4096, 512, 100_000):
        bag = torch.randn(n, 192, generator=g).to(dev)
        mask = torch.arange(n, device=dev) < n - max(1, n // 50)
        with torch.inference_mode():
            out = gap.apply_pooled(model, bag, mask)
            ref_logits, ref_scores = gap.gated_attention_pool_reference(
                bag, mask, p)
            torch.cuda.synchronize()
            err = max((out.logits[0] - ref_logits).abs().max().item(),
                      (out.a_raw[0] - ref_scores).abs().max().item())
            ms = gpu_timer(lambda: gap.gated_attention_pool(bag, p,
                                                            mask=mask))
            pms = gpu_timer(lambda: gap.gated_attention_pool_reference(
                bag, mask, p))
        log(f"gated_pool N={n} (tail masked): max_abs_err {err:.3g} "
            f"(bound {POOL_TOL}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
        if not err <= POOL_TOL:
            raise SystemExit(f"gated_pool disagrees at N={n}")
        worst = max(worst, err)
        if timed is None:
            timed = (ms, pms, f"[{n},192] f32")
    records["gated_pool"] = {
        "name": "gated_pool", "route": "cuda",
        "source": "hipt_abmil_atec23_tpu_torch/kernels/csrc/gated_pool.cu",
        "replaces": "hipt_abmil_atec23_tpu/ops/gated_attention_pool.py:87",
        "max_abs_err": worst, "ms": timed[0], "plain_ms": timed[1],
        "shape": timed[2]}
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------------ phase 3
def he_like_planes(seed: int, size: int):
    """Seeded H&E-like RGB texture (white background, pink stroma blobs,
    purple nuclei) and its JFIF YCbCr 4:2:0 planes, made in numpy."""
    rng = np.random.default_rng(seed)
    cell = 64
    low = rng.random((size // cell, size // cell)).astype(np.float32)
    for _ in range(3):  # smooth the tissue field a little
        low = (low + np.roll(low, 1, 0) + np.roll(low, 1, 1)
               + np.roll(low, -1, 0) + np.roll(low, -1, 1)) / 5
    tissue = np.kron(low > np.median(low), np.ones((cell, cell), bool))
    nuclei = np.kron(rng.random((size // 8, size // 8)) > 0.85,
                     np.ones((8, 8), bool)) & tissue
    rgb = np.empty((size, size, 3), np.uint8)
    rgb[:] = (236, 230, 238)
    rgb[tissue] = (199, 124, 180)
    rgb[nuclei] = (92, 58, 140)
    noise = rng.integers(-20, 21, size=(size, size, 1), dtype=np.int16)
    rgb = np.clip(rgb.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    f = rgb.astype(np.float32)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = -0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2] + 128
    cr = 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2] + 128

    def sub(c):  # 2x2 box average
        return c.reshape(size // 2, 2, size // 2, 2).mean((1, 3))

    q = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)
    return rgb, q(y), q(sub(cb)), q(sub(cr))


class PlaneSlide(BaseSlide):
    """A one-level slide over in-memory arrays that serves RGB regions and
    raw YCbCr 4:2:0 planes, as a JPEG-YCbCr TIFF does."""

    def __init__(self, rgb, y, cb, cr):
        self.rgb, self.y, self.cb, self.cr = rgb, y, cb, cr
        self.level_dimensions = [(rgb.shape[1], rgb.shape[0])]

    def read_region(self, location, level, size):
        x, y = int(location[0]), int(location[1])
        return self.rgb[y:y + size[1], x:x + size[0]].copy()

    def supports_yuv420(self, level: int = 0) -> bool:
        return level == 0

    def read_regions_yuv420(self, locations, level, size, n_threads=0):
        w, h = size
        ys, cbs, crs = [], [], []
        for x, y in np.asarray(locations, np.int64):
            if x % 2 or y % 2 or w % 2 or h % 2:
                raise IOError("4:2:0 plane reads need even coords and size")
            ys.append(self.y[y:y + h, x:x + w])
            cbs.append(self.cb[y // 2:(y + h) // 2, x // 2:(x + w) // 2])
            crs.append(self.cr[y // 2:(y + h) // 2, x // 2:(x + w) // 2])
        return np.stack(ys), np.stack(cbs), np.stack(crs)


def encode_slides(jobs, encoder, region):
    """encode_stream over the jobs; returns ({sid: feats}, wall s)."""
    def sync():
        if encoder.device.type == "cuda":
            torch.cuda.synchronize(encoder.device)

    sync()
    t0 = time.perf_counter()
    feats = dict(encode_stream(jobs, encoder, region_size=region))
    sync()
    return feats, time.perf_counter() - t0


def score(model, feats, dev):
    """CLAM_SB as serve_once scores a slide (the padded bucket through
    apply_pooled), and the plain pool on the same bag."""
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeState, _mil_bucketed)
    from hipt_abmil_atec23_tpu_torch.ops.masking import pad_bag
    out = _mil_bucketed(ServeState(device=dev, model=model), feats)
    bag, mask = pad_bag(feats, out.a_raw.shape[1])
    bag, mask = torch.from_numpy(bag).to(dev), torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        ref_logits, _ = gap.gated_attention_pool_reference(
            bag, mask, gap.params_from_clam(model))
    return out, ref_logits


def phase_slice(dev, *, slide=SLIDE, region=REGION, batch=2, vit256_cfg=None,
                vit4k_cfg=None) -> dict:
    """The port's main path on in-memory slides, then the plain pass."""
    kw = {}
    if vit256_cfg is not None:
        kw = dict(vit256_cfg=vit256_cfg, vit4k_cfg=vit4k_cfg)
    dtype = torch.bfloat16
    kernel_model = make_hipt_encoder(
        dtype, generator=torch.Generator().manual_seed(0), **kw)
    plain_model = make_hipt_encoder(dtype, **kw)
    plain_model.load_state_dict(kernel_model.state_dict())
    for m in plain_model.modules():
        if isinstance(m, Block):
            m.plain = True
    cfg = EncoderConfig(model_type="HIPT_4K", batch_size=batch,
                        dtype="bfloat16")
    enc = build_encoder(cfg, device=dev, model=kernel_model)
    plain_enc = build_encoder(cfg, device=dev, model=plain_model)
    clam = _random_clam(torch.Generator().manual_seed(1), dev)

    t0 = time.perf_counter()
    slides = {f"mem{i}": PlaneSlide(*he_like_planes(10 + i, slide))
              for i in range(2)}
    grid = np.arange(0, slide, region)
    coords = np.stack(np.meshgrid(grid, grid, indexing="ij"),
                      -1).reshape(-1, 2)[:, ::-1].copy()
    jobs = [(sid, s, coords) for sid, s in slides.items()]
    log(f"slides: {len(slides)} x {slide}^2, {len(coords)} regions each "
        f"({time.perf_counter() - t0:.1f} s to make)")

    encode_slides(jobs[:1], enc, region)  # warm-up (cuBLAS, allocator)
    fused_vit_block.launches = 0
    gap.gated_attention_pool.launches = 0
    feats, wall = encode_slides(jobs, enc, region)
    outs = {sid: score(clam, f, dev) for sid, f in feats.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {"fused_block": fused_vit_block.launches,
                "gated_pool": gap.gated_attention_pool.launches}
    n_regions = sum(len(f) for f in feats.values())
    log(f"main path launches: {launches}")

    plain_feats, plain_wall = encode_slides(jobs, plain_enc, region)
    worst_cos, worst_rel = 1.0, 0.0
    for sid, f in feats.items():
        pf = plain_feats[sid]
        if f.shape != (len(coords), enc.feat_dim) or not np.isfinite(f).all():
            raise SystemExit(f"{sid}: bad features {f.shape}")
        cos = (f * pf).sum(1) / (np.linalg.norm(f, axis=1)
                                 * np.linalg.norm(pf, axis=1))
        rel = np.linalg.norm(f - pf, axis=1) / np.linalg.norm(pf, axis=1)
        worst_cos = min(worst_cos, float(cos.min()))
        worst_rel = max(worst_rel, float(rel.max()))
        out, ref_logits = outs[sid]
        prob = out.y_prob[0].float().cpu().numpy()
        if not (np.isfinite(prob).all() and abs(prob.sum() - 1) < 1e-5):
            raise SystemExit(f"{sid}: bad probabilities {prob}")
        lerr = (out.logits[0] - ref_logits).abs().max().item()
        log(f"{sid}: p={prob.tolist()} y_hat={int(out.y_hat[0])} "
            f"pool-vs-plain logit err {lerr:.3g}")
        if lerr > POOL_TOL:
            raise SystemExit(f"{sid}: pooled logits disagree ({lerr})")
    log(f"features kernel vs plain: min cosine {worst_cos:.6f} (>= 0.999), "
        f"max rel L2 {worst_rel:.3g} (<= 2e-2)")
    if worst_cos < 0.999 or worst_rel > 2e-2:
        raise SystemExit("kernel features disagree with the plain pass")
    ms_k = wall * 1e3 / n_regions
    ms_p = plain_wall * 1e3 / n_regions
    log(f"ms per {region}^2 region (decode + H2D + encode, batch {batch}): "
        f"kernel path {ms_k:.2f}, plain path {ms_p:.2f}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"the main path never launched {name}")
    return {"launches": launches, "ms_region": ms_k,
            "plain_ms_region": ms_p, "encoder": enc, "clam": clam}


# ------------------------------------------------------------------ phase 4
def phase_serve(dev, encoder, clam, *, slide=SLIDE, region=REGION) -> None:
    try:
        import cv2  # noqa: F401
        import h5py  # noqa: F401
        from hipt_abmil_atec23_tpu.slideio import native
        native.get_lib()
    except (ImportError, OSError, subprocess.CalledProcessError) as e:
        what = getattr(e, "name", None) or \
            "the native slide reader's build (libtiff/libjpeg headers)"
        log(f"serve phase: skipped, missing {what}")
        return
    from hipt_abmil_atec23_tpu.slideio.synthetic import write_synthetic_slide
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeConfig, ServeState, serve_once)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        slide_dir = os.path.join(d, "slides")
        os.makedirs(slide_dir)
        for i in range(2):
            write_synthetic_slide(os.path.join(slide_dir, f"s{i}.tif"), slide,
                                  slide, n_levels=3, ycbcr420=True, seed=i)
        ckpt = os.path.join(d, "clam.pt")
        torch.save({k: v.cpu() for k, v in clam.state_dict().items()}, ckpt)
        cfg = ServeConfig(
            slide_dir=slide_dir, out_dir=os.path.join(d, "out"),
            ckpt_path=ckpt, encoder=EncoderConfig(batch_size=2),
            model=ModelConfig(model_type="clam_sb",
                              model_size="hipt_smaller"),
            tile=TileConfig(patch_size=region, step_size=region,
                            seg=SegConfig(use_otsu=True, a_t=1)),
            min_stable_s=0.0)
        t0 = time.perf_counter()
        recs = serve_once(cfg, ServeState(device=dev, encoder=encoder),
                          verbose=False)
        wall = time.perf_counter() - t0
        done = [r for r in recs if r["status"] == "done"]
        if len(done) != 2:
            raise SystemExit(f"serve scored {len(done)} of 2 slides: {recs}")
        for r in done:
            if not (all(math.isfinite(v) for v in r["p"])
                    and abs(sum(r["p"]) - 1) < 1e-5):
                raise SystemExit(f"serve: bad probabilities {r}")
        log(f"serve phase: {len(done)} slides, "
            f"{sum(r['n_regions'] for r in done)} regions in {wall:.2f} s")


# ------------------------------------------------------------------ phase 5
def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(dev, encoder, path, *, slide=SLIDE, region=REGION) -> None:
    """Where one slide's warm encode_stream time goes: the stream's wall,
    its stages timed apart (host plane read, H2D of the pinned planes,
    YCbCr -> RGB + normalize, the encoder on planes and on RGB already on
    the card), and the device's busy share and kernel table from
    torch.profiler over one more stream, the table written to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    from hipt_abmil_atec23_tpu_torch.ops.yuv import yuv_planes_to_rgb
    s = PlaneSlide(*he_like_planes(10, slide))
    grid = np.arange(0, slide, region)
    coords = np.stack(np.meshgrid(grid, grid, indexing="ij"),
                      -1).reshape(-1, 2)[:, ::-1].copy()
    jobs, n, bs = [("p0", s, coords)], len(coords), encoder.batch_size
    for _ in range(2):
        _, wall = encode_slides(jobs, encoder, region)
        log(f"profile: stream wall ms/region {wall * 1e3 / n:.2f}")
    t0 = time.perf_counter()
    for i in range(0, n, bs):
        planes = s.read_regions_yuv420(coords[i:i + bs], 0, (region, region))
    log(f"profile: host plane read ms/region "
        f"{(time.perf_counter() - t0) * 1e3 / n:.2f}")
    host = [torch.from_numpy(a).pin_memory() for a in planes]
    on_dev = [t.to(dev) for t in host]
    rgb = torch.from_numpy(s.read_regions(coords[:bs], 0, (region, region)))
    rgb = rgb.to(dev)
    k = len(on_dev[0])
    stages = {
        "H2D planes (pinned)": gpu_timer(
            lambda: [t.to(dev, non_blocking=True) for t in host]),
        "YCbCr->RGB + normalize": gpu_timer(
            lambda: yuv_planes_to_rgb(*on_dev) / 127.5 - 1.0),
        "encoder, planes on the card": gpu_timer(
            lambda: encoder.apply_yuv(*on_dev), iters=3),
        "encoder, RGB on the card": gpu_timer(
            lambda: encoder.apply(rgb), iters=3)}
    mb = sum(t.numel() for t in host) / k / 1e6
    for name, ms in stages.items():
        log(f"profile: {name} ms/region {ms / k:.2f}"
            + (f" ({mb:.1f} MB/region)" if name.startswith("H2D") else ""))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = encode_slides(jobs, encoder, region)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise SystemExit("torch.profiler recorded no device activity")
    busy =_busy_us((e.time_range.start, e.time_range.end)
                    for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    head = (f"profiled wall {wall * 1e3:.1f} ms ({n} regions), device busy "
            f"{busy:.1f} ms, busy share {busy / (wall * 1e3):.3f}, "
            f"device time summed over launches {total:.1f} ms")
    rows = [f"{t:9.2f} ms {100 * t / total:5.1f}%  x {c:4d}  {name}"
            for name, (t, c) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join([head, *rows]) + "\n")
    log(f"profile: {head}")
    for r in rows[:8]:
        log(f"profile: {r[:140]}")
    log(f"profile: kernel table in {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one slide's encode_stream (phase 5) "
                         "and write the kernel table to PATH")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    dev = require_cuda()
    records = phase_kernels(dev)
    res = phase_slice(dev)
    phase_serve(dev, res["encoder"], res["clam"])
    if args.profile:
        phase_profile(dev, res["encoder"], args.profile)
    for name, rec in records.items():
        rec["launches"] = res["launches"][name]
    log(f"card: {smi}")
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
