"""Quickest proof that the PyTorch port (hipt_abmil_atec23_tpu_torch) runs its
serving path on an NVIDIA H100 through its hand-written CUDA kernels.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits non-zero, and no result line is printed):
  1. device: require CUDA; print the card's name and power limit.
  2. kernels: build the seven CUDA sources from the checkout (one nvcc per
     source, side by side, sm_90a) and hold each of the nine kernels (the
     eight TPU kernels' ports and the colour kernel)
     against its plain PyTorch version on the card, at the main path's
     shapes, with the stated tolerance; time both, the bound of the same
     work, and the one PyTorch call that computes it where there is one
     (for both attention kernels scaled_dot_product_attention over the
     valid keys; fused_attention at both of its per-op shapes). The block
     kernel also at an f32 residual, with its time by stage
     (torch.profiler over its seven launches) beside the network kernel's
     (%globaltimer stamps at its grid barriers); nvcc's -Xptxas -v report
     and HGMMA count of every library. The DCT decode on an aligned and an
     offset pack of two 4096^2 regions (coefficient tap bit-equal, planes
     within 1 LSB); the colour kernel at that batch in bf16 and f32 and at
     4:2:2 and 4:2:0 edges. fused_mlp is timed at both per-op shapes
     beside the bf16 chain of torch calls of the same function and B.1's
     LN2 + FC1 + FC2 launches. The pool runs at the HIPT head (L 16) and
     at the reference CLAM 'small' head (L 512) on a [100000, 1024] slide
     bag; its partial
     mode at both widths on full slide bags; its bound is the least over
     the f32 FMA rate and three tf32 passes.
     flash_attention is driven through attention() at a long N, where the
     dispatcher takes its flash branch; fused_network through
     fused_vit_network on the 12 ViT-256 blocks of a seeded full-width
     encoder and the tokens that reach its first block from two 4096^2
     regions (each path: counts zeroed before, read after).
  3. plane slice: two in-memory 8192^2 slides (seeded H&E-like texture served
     as YCbCr 4:2:0 planes) through build_encoder (full-width HIPT_4K,
     bf16, seeded random weights, every block the fused block kernel,
     batch 2) -> encode_stream -> CLAM_SB hipt_smaller through serve's
     _mil_bucketed. Launch counts are zeroed right before this run;
     fused_block, gated_pool and ycc_input must be non-zero after it and
     dct_decode zero. The features are held against a second pass of the
     same weights on the plain versions.
  4. DCT slice: two in-memory 8192^2 slides stored as JPEG quality-80
     coefficients (slideio/synthetic.DctMemorySlide) through the same
     encoder -> encode_stream(adaptive_rungs=False) on the sparse-DCT rung
     -> CLAM_SB. Counts zeroed before, dct_decode, ycc_input, fused_block
     and gated_pool each non-zero after; features held against the plain
     pass;
     one batch's decoded planes held against the slide's own decode; the
     per-rung seed costs measured; one adaptive stream printed.
  5. per-op slice: the plane slides of phase 3 through the per-op
     configuration (make_hipt_encoder(use_flash=True, use_fused_mlp=True),
     the same weights) via build_encoder(model=...) -> encode_stream ->
     CLAM_SB. Counts zeroed before; fused_attention, fused_mlp, gated_pool
     and ycc_input non-zero and fused_block zero after. Features held against
     the plain pass of the same configuration and against phase 3's
     fused-block features; ms per region of both configurations printed.
  6. sharded: the instance-sharded full-bag path (parallel/) over a
     process group of one (NCCL): sharded_clam_forward, plain and through
     the partial kernel, on a [100000, 1024] bag with a CLAM 'small' head
     against apply_pooled; four shards (one all-masked) through the partial
     kernel merged by combine_partials against the full-bag kernel; two
     epochs of train_full_bags_sharded on six seeded slide bags of
     20k-100k x 1024 (ms per optimizer step printed). Counts zeroed
     before; gated_pool_partial non-zero after.
  7. serve: serve_once over two synthetic JPEG YCbCr 4:2:0 slides of 8192^2
     on disk (skipped, with a line saying what is missing, where cv2, h5py
     or the native reader's build dependencies are absent).
  9. encode stage (after phase 7): B.1 at the vit256 encoder's shape
     [256, 264, 384] against its plain version; then, counts zeroed,
     encode_stream(stage=True) on the plane and DCT slides at the default
     budget and a 1-byte one (a flush per batch, at least three), the
     features held against the overlapped stream's (max |d| <= 1e-6), ms
     per region of each; a stream paced at 200 MB/s with a 200 MB/s wire
     hint (wire_mbps_final in [0.8, 1.05] x 200, wall >= 0.7 x its bytes
     at the pace), its rung decisions and first wire samples beside an
     unpaced stream's; HIPT's mean256 and concat on one batch of two
     regions against the plain pass (concat = [mean256 | cls4k] bit for
     bit); the vit256 encoder (seeded full-width ViT-S, bf16) on one
     slide's 256^2 patches, 256 per batch, against its plain pass
     (patches per second printed); the RGB rung under the macenko
     transform (and a resize to 224 where cv2 imports) against
     encoder.apply(transform(batch)). fused_block, dct_decode and ycc_input
     must be non-zero after it. Then, where cv2, h5py, pandas and the
     native reader are present (else one line says what is missing):
     seg_and_patch -> encode_many on two synthetic TIFFs, the bags against
     encode_slide, and the CLI's tile and encode on the same slides.
  10. train and eval (after phase 9; the JAX package's train / evaluate
     stages, nothing skipped): (a) the settings of
     configs/train_winning_hipt_abmil.json (CLAM_SB hipt_smaller, no
     instance clustering, dropout 0.85, 75 patches drawn with replacement,
     weighted sampling, Adam lr 1e-3 wd 0.5, CE, batch 1) with max_epochs
     4 and early stopping at min_epochs 1 / patience 1, on 60 seeded
     192-d bags of 40-600 regions with a planted signal, written as .pt:
     train_fold on folds 0 and 1 of the 5-fold split, then evaluate_fold
     from the written .pt on the host stream of train_fold's test pass
     (probabilities within 1e-6), ms per optimizer step and per epoch;
     (b) fold 0 with dropout off from one initial .pt on the card and on
     the CPU for 2 epochs, per-epoch train / val losses within 1e-5; (c)
     CLAM_SB small with the instance loss (k_sample 8, bag_weight 0.7) on
     1024-d bags of 3000-8000 instances, 4096 drawn per bag, batch 4, 2
     epochs, ms per step; (d) evaluate_fold on 8 un-subsampled 1024-d bags
     of 20k-100k instances with a CLAM_SB small head: gated_pool launches
     once per slide, probabilities within 1e-4 of evaluate_split (the
     head's own forward on the card), ms per slide; (e) bootstrap_metrics
     with 100k resamples over (a)'s fold CSVs on the card, its first chunk
     of 10k resamples against a numpy computation of the four metrics
     within 1e-6, wall time. One ``train_eval {...}`` line carries the
     numbers and the card.
  11. explain (after phase 10): B.1 at [1024, 264, 384] (one region's
     four shifted variants) against its plain version; counts zeroed;
     (a) infer_attention on phase 3's bag of one plane slide (CLAM_SB
     hipt_smaller) and on a seeded [100000, 1024] bag (CLAM_SB small):
     one gated_pool launch each, scores within 1e-4 of the head's own
     forward (relative to max |a_raw| on the big bag); sample_rois top-k;
     draw_heatmap with the tissue mask on an ImageSlide of the slide's
     pixels; (b) region_attention_cls_maps on one 4096^2 region's four
     shifted variants (1024 tiles) in the JAX CLI's gallery configuration
     (f32, no kernel flags: no launch) and in bf16 use_fused_block
     (exactly 17 fused_block launches: 11 + 1 + 5), the fused maps held
     against the f32 ones (cosine >= 0.99 and the CLS rows' mass on the
     patch tokens within 1e-2, per map), then hierarchical_gallery
     (concat_select) and patch_gallery. The raster steps need cv2 (else
     one line says so and the device half runs alone). One ``explain
     {...}`` line carries the times and the card.
  12. ResNet and LeViT encoders, online encoding (after phase 11): the
     colour kernel's ImageNet mode at [256, 256, 256] 4:2:0 (bf16 and
     f32, bit-equal to its plain version), B.3 on a batch of 256 patches
     of 256^2 (aligned and off the MCU lattice) and B.2 at serve's
     [1024, 1024] bucket with a CLAM_SB small head, each timed beside its
     plain version and bound; then full-width ResNet50-trunc (bf16, seeded
     weights, batch 256) through build_encoder -> encode_stream on phase
     3's two plane slides, one phase 4 DCT slide and the RGB rung, 1024
     patches of 256^2 per slide, counts zeroed before each rung (ycc_input
     on the plane and DCT rungs, dct_decode on the DCT rung, none on RGB,
     fused_block never), features against the plain pass (cosine >= 0.999,
     rel L2 <= 2e-2), patches per second per rung; CLAM_SB small over each
     [1024, 1024] bag through serve's _mil_bucketed (gated_pool launched,
     probabilities within 1e-4 of the head's forward); 8 patches against
     the port on the CPU in f32 (TF32 off on the card) and from bf16;
     ResNet-18, LeViT-256 and LeViT-128S on the RGB rung (no ycc_input or
     dct_decode launch), patches per second, each against the CPU port;
     train_fold for 2 epochs over OnlineEncodingBagDatasets of in-memory
     slides (75 patches drawn per slide, ResNet50-trunc in the loop), ms
     per step; OnlineFeatureGather.take twice (the second encodes
     nothing). One ``resnet {...}`` line carries the numbers and the card.
  13. DRAS sampling and the kNN probe (after phase 12): B.2 at the DRAS
     subset [100, 1024] and bag [1104, 1024] shapes (CLAM_SB small)
     against its plain version; knn_indices on a 256 px grid against
     numpy's stable argsort (ties lower index first), and timed at
     [100, 100000] against its first design (a top-k); then, DRAS at the
     reference's defaults (100 x 10, 20 neighbours, 100 final, power
     0.15, max), counts zeroed before each run and read after:
     eval_sampling over 8 seeded slides of 20k-100k x 1024 with a planted
     high-attention region, host loop on the card (exactly 11 pool
     launches per slide), replayed on the CPU with the card's attention
     (the same bags; attention within 1e-4, probabilities within 1e-5;
     run free, the CPU parts from the card, ROADMAP section C); the device
     loop (11 per slide; its planted shares against the host loop's
     within 0.08 / 0.35; the loop alone under CUDA's sync debug mode
     'error'); textural sampling on the 100k slide; online eval at the
     defaults on a 32768^2 plane slide (phase 12's tiled 4 x 4, 16384
     patches), encoding only the sampled patches through ResNet50-trunc;
     train_fold_sampling on 16 slides of 2k-20k (10 launches per DRAS
     pass); knn_cv_probe (mean, max, hipt_lgp) on phase 10's 60 bags, card
     against CPU. One ``dras {...}`` line carries the numbers and the
     card; B.2's record gains the DRAS shapes and launches.
  14. tuning, trial- and fold-parallel training, flax heads (after phase
     13), on phase 10's 60 bags in the winning configuration, counts
     zeroed before each part and read after it: (a) run_tuning, 4 trials
     of the default space, max_epochs 6, grace 2, trial checkpoints kept
     (the last restores each trial's final validation loss within 1e-6);
     (b) run_trials_parallel, 8 lanes with dropout 0, held to each lane
     run alone from the same initial weights and to the 8 lanes on the
     CPU within 1e-5 per epoch; (c) run_tuning_hetero over 16 trials in
     two buckets beside sequential run_tuning on the same trials (times
     recorded, no order asserted); (d) train_folds_parallel, k = 5, the
     winning configuration (time, summary), then dropout 0 against
     sequential train_fold (per-epoch losses within 1e-5, the same stops);
     (e) tune_sampling_params, 4 trials on phase 13's 8 slides: exactly
     8 x (iterations + 1) B.2 launches per trial, the best trial's AUC
     equal to a rerun of eval_sampling; (f) a flax CLAM_SB head written by
     the port's writer (no flax) loaded by serve (_ensure_state +
     _mil_bucketed; serve_once needs files the card machine cannot read),
     evaluate_fold and the heatmap driver's loader, against the .pt that
     export writes of it (within 1e-6). One ``tune {...}`` line carries
     the numbers and the card; B.2's record gains phase 14's launches.
  8. profile (only with --profile PATH): where one warm encode_stream's
     time goes, stage by stage (the colour and DCT decode stages through
     the kernels beside their plain chains), and torch.profiler kernel
     tables of the
     fused-block and the per-op configurations, written to PATH and
     PATH.per_op.

    python3 chip_smoke.py --profile chiprun_out/profile.txt

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from hipt_abmil_atec23_tpu_torch.data.online import OnlineEncodingBagDataset
from hipt_abmil_atec23_tpu_torch.device import require_cuda
from hipt_abmil_atec23_tpu_torch.engine.encode import (
    _decode_batch, build_encoder, encode_stream, probe_dct_caps)
from hipt_abmil_atec23_tpu_torch.models.abmil import (
    build_mil_model, init_reference_weights)
from hipt_abmil_atec23_tpu_torch.models.hipt import (
    hipt_eval_normalize, make_hipt_encoder)
from hipt_abmil_atec23_tpu_torch.models.levit import levit_texture_encoder
from hipt_abmil_atec23_tpu_torch.models.resnet import resnet18, resnet50_trunc
from hipt_abmil_atec23_tpu_torch.models.vit import VIT_CONFIGS, Block
from hipt_abmil_atec23_tpu_torch.ops import flash_attention as fa
from hipt_abmil_atec23_tpu_torch.ops import fused_mlp as fm
from hipt_abmil_atec23_tpu_torch.ops import gated_attention_pool as gap
from hipt_abmil_atec23_tpu_torch.ops import jpegdct, yuv
from hipt_abmil_atec23_tpu_torch.ops.fused_block import (
    fused_vit_block, fused_vit_block_reference)
from hipt_abmil_atec23_tpu_torch.ops.fused_network import (
    fused_vit_network, fused_vit_network_reference, stack_blocks)
from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
    DctMemorySlide, he_like_planes)
from hipt_abmil_atec23_tpu_torch.utils.config import (
    EncoderConfig, ModelConfig, SegConfig, TileConfig)

BLOCK_TOL = (3e-2, 5e-2)   # |kernel - plain| <= atol + rtol |plain| (bf16)
MLP_TOL = (3e-2, 5e-2)     # bf16 out; the kernel's products round to bf16
ATTN_TOL = (5e-2, 2e-2)    # bf16 out: atol x rms(plain), rtol x |plain|
Q_SCALE = 3.0              # q scale: logits of std 3, a peaked softmax
POOL_TOL = 1e-4            # f32 logits and scores
REGION = 4096
SLIDE = 8192
SOURCES = ("fused_block", "gated_pool", "dct_decode", "ycc_input",
           "fused_mlp", "flash_attention", "fused_network")
PLANE_SHARE = 1e-3         # decoded samples allowed 1 LSB off the plain
# f32 operations per output pixel of the colour kernel: its share of the
# vertical chroma filter (3 per plane per chroma sample, 2 pixels each),
# the horizontal one (3 per plane), colour (8), clamp (6), normalize (6)
COLOUR_FLOPS_PER_PX = 29

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) for bounds
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12         # CUDA cores, no tensor cores
TF32_FLOP_S = 494.7e12
# f32-accurate products: the faster of the f32 FMA rate and three tf32
# passes (hi.hi + hi.lo + lo.hi) on the tensor cores
F32_ACCURATE_FLOP_S = max(F32_FLOP_S, TF32_FLOP_S / 3)


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


def bound(nbytes: float, flops: float, peak: float):
    """(least ms, what bounds it): each input read and each output written
    once at the card's memory rate, against the operations at ``peak``."""
    tb, to = nbytes / HBM_BYTES_S, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def record(name, source, replaces, err, ms, plain_ms, shape, nbytes, flops,
           peak, library_ms):
    b_ms, b_by = bound(nbytes, flops, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "shape": shape}


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


def _block_library_ms(b, n, nv, d, heads, dev) -> float:
    """One nn.TransformerEncoderLayer call (pre-LN, GELU, the same widths,
    key padding mask) at the block's shape: the yardstick for fused_block,
    timed here and never called by the port."""
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, 4 * d, dropout=0.0, activation="gelu",
        layer_norm_eps=1e-6, batch_first=True, norm_first=True)
    layer = layer.to(dev, torch.bfloat16).eval()
    x = torch.randn(b, n, d, device=dev, dtype=torch.bfloat16)
    pad = torch.arange(n, device=dev)[None, :].expand(b, n) >= nv
    with torch.inference_mode():
        return gpu_timer(lambda: layer(x, src_key_padding_mask=pad))


# B.1's launches by the stage each runs, as torch.profiler names their
# kernels (for bf16 x: LN1 reads bf16, LN2 the f32 x2)
BLOCK_LAUNCHES = {"layernorm_kernel<__nv_bfloat16>": "LN1",
                  "gemm_kernel<0>": "QKV", "attention_kernel<64>": "attention",
                  "attention_kernel<32>": "attention", "gemm_kernel<1>": "PROJ",
                  "layernorm_kernel<float>": "LN2", "gemm_kernel<2>": "FC1",
                  "gemm_kernel<3>": "FC2"}


def block_launch_split(kernel_ms: dict) -> dict:
    """B.1's ms per call by stage, in STAGE_KINDS' order, from device ms
    per call by profiler kernel name; other kernels are left out."""
    out = {}
    for name, ms in kernel_ms.items():
        m = re.search(r"(\w+_kernel<[^>]*>)", name)
        stage = BLOCK_LAUNCHES.get(m.group(1)) if m else None
        if stage:
            out[stage] = out.get(stage, 0.0) + ms
    return {k: out[k] for k in STAGE_KINDS if k in out}


def kernel_ms(events, calls: int) -> dict:
    """Device ms per call by name from torch.profiler's key_averages() over
    ``calls`` calls (device_time_total: us summed over them); rows without
    device time are left out."""
    return {e.key: e.device_time_total / (1e3 * calls) for e in events
            if e.device_time_total > 0}


def _launch_split(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from
    torch.profiler over ``calls`` warm calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return kernel_ms(prof.key_averages(), calls)


def _kernel_block(dev, g) -> dict:
    worst, timed = 0.0, None
    # ViT-256 at the slice's batch (2 regions x 256 tiles), a 64-image
    # shape, ViT-4K at batch 2, an odd small shape
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
            # bytes: x in and out in bf16 plus the block's weights; ops:
            # the four GEMMs and attention over the valid tokens
            wbytes = sum(p.numel() * p.element_size()
                         for p in blk.parameters())
            flops = 2 * b * nv * d * (3 * d + d + 8 * d) + 4 * b * nv * nv * d
            lib = _block_library_ms(b, n, nv, d, h, dev)
            with torch.inference_mode():
                split = block_launch_split(_launch_split(
                    lambda: fused_vit_block(x, blk, num_heads=h,
                                            n_valid=nv)))
            log(f"fused_block [{b},{n},{d}]: nn.TransformerEncoderLayer "
                f"{lib:.4f} ms; launch split, ms per call (torch.profiler, "
                "5 calls): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in split.items()))
            timed = (ms, pms, f"[{b},{n},{d}] bf16, n_valid {nv}",
                     2 * x.numel() * 2 + wbytes, flops, lib, split)
        del blk, x, got, want, err
    # an f32 residual stream: bf16 operands, f32 in and out
    gf = torch.Generator().manual_seed(5)
    blk = _random_block(384, 6, gf, dev)
    x = torch.randn(64, 264, 384, generator=gf).to(dev)
    with torch.inference_mode():
        got = fused_vit_block(x, blk, num_heads=6, n_valid=257)
        want = fused_vit_block_reference(x, blk, num_heads=6, n_valid=257,
                                         operand_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise SystemExit(f"fused_block wrote {got.dtype} for f32 x")
        worst = max(worst, _check(
            "fused_block", "[64,264,384] f32 x, bf16 operands, n_valid 257",
            got, want, BLOCK_TOL))
        f32_ms = gpu_timer(lambda: fused_vit_block(x, blk, num_heads=6,
                                                   n_valid=257))
    log(f"fused_block [64,264,384] f32: kernel {f32_ms:.4f} ms")
    ms, pms, shape, nbytes, flops, lib, split = timed
    rec = record("fused_block",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/fused_block.cu",
                 "hipt_abmil_atec23_tpu/ops/fused_block.py:60", worst, ms,
                 pms, shape, nbytes, flops, BF16_FLOP_S, lib)
    rec["f32_ms_64x264x384"] = f32_ms
    rec["stage_ms"] = split
    return rec


def _reference_clam(size_arg, seed, dev):
    """A CLAM_SB at the reference init's scale (xavier weights) with seeded
    non-zero biases: the full-width heads' weights."""
    g = torch.Generator().manual_seed(seed)
    model = init_reference_weights(
        build_mil_model("clam_sb", size_arg=size_arg, n_classes=2), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return model.to(dev).eval()


def _pool_bytes_flops(p, n):
    """Bag, mask and weights read once, scores and logits written once;
    the two projections, the gate and the pooling per instance."""
    d_in, l_dim = p.w_f.shape
    d_att, c_dim = p.w_a.shape[1], p.w_cls.shape[1]
    wbytes = sum(t.numel() * 4 for t in p)
    nbytes = n * d_in * 4 + n + wbytes + n * 4 + max(c_dim, l_dim + 2) * 4
    flops = n * (2 * d_in * l_dim + 4 * l_dim * d_att + 2 * d_att
                 + 2 * l_dim) + 2 * l_dim * c_dim
    return nbytes, flops


def _pool_row(name, p, bag, err, fn, plain, shape):
    ms, pms = gpu_timer(fn), gpu_timer(plain)
    work = _pool_bytes_flops(p, bag.shape[0])
    b_ms, b_by = bound(*work, F32_ACCURATE_FLOP_S)
    fma_ms = bound(*work, F32_FLOP_S)[0]
    log(f"{name} {shape}: max_abs_err {err:.3g} (bound {POOL_TOL}); kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; at "
        f"the f32 FMA rate {fma_ms:.4f})")
    if not err <= POOL_TOL:
        raise SystemExit(f"{name} disagrees at {shape}")
    return {"shape": shape, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_fma_ms": fma_ms, "max_abs_err": err}


def _kernel_pool(dev, g) -> dict:
    model = _random_clam(g, dev)
    p = gap.params_from_clam(model)
    rows = []
    # the serve path's 512 bucket (the record's shape), a 4096 bag, a
    # whole-slide 100k, all hipt_smaller (L 16); then the reference CLAM
    # 'small' head (L 512, D_att 256) on a full ResNet50-trunc slide bag
    cases = [(n, 192, model, p) for n in (512, 4096, 100_000)]
    small = _reference_clam("small", 3, dev)
    cases.append((100_000, 1024, small, gap.params_from_clam(small)))
    for n, d_in, clam, cp in cases:
        bag = torch.randn(n, d_in, generator=g).to(dev)
        mask = torch.arange(n, device=dev) < n - max(1, n // 50)
        with torch.inference_mode():
            out = gap.apply_pooled(clam, bag, mask)
            ref_logits, ref_scores = gap.gated_attention_pool_reference(
                bag, mask, cp)
            torch.cuda.synchronize()
            err = max((out.logits[0] - ref_logits).abs().max().item(),
                      (out.a_raw[0] - ref_scores).abs().max().item())
            rows.append(_pool_row(
                "gated_pool", cp, bag, err,
                lambda: gap.gated_attention_pool(bag, cp, mask=mask),
                lambda: gap.gated_attention_pool_reference(bag, mask, cp),
                f"[{n},{d_in}] f32, L {cp.w_f.shape[1]}, tail masked"))
        del bag, out
    first = rows[0]
    rec = record("gated_pool",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/gated_pool.cu",
                 "hipt_abmil_atec23_tpu/ops/gated_attention_pool.py:87",
                 max(r["max_abs_err"] for r in rows), first["ms"],
                 first["plain_ms"], first["shape"],
                 *_pool_bytes_flops(p, 512), F32_ACCURATE_FLOP_S, None)
    rec["bound_fma_ms"] = first["bound_fma_ms"]
    rec["other_shapes"] = rows[1:]
    return rec


def _partial_err(got, want) -> float:
    """max of |dm|, |dscores| and, relative to l (acc / l is the pooled
    vector, both sums over the bag), |dacc| / l and |dl| / l."""
    acc, m, l, s = got
    racc, rm, rl, rs = want
    scale = max(rl.item(), 1e-30)
    return max((m - rm).abs().item(), (s - rs).abs().max().item(),
               (acc - racc).abs().max().item() / scale,
               (l - rl).abs().item() / scale)


def _kernel_pool_partial(dev, g) -> dict:
    """The partial mode on a full slide bag at the 'small' (the record's
    shape) and 'hipt_smaller' widths, against its plain version."""
    rows = []
    for size_arg, d_in in (("small", 1024), ("hipt_smaller", 192)):
        p = gap.params_from_clam(_reference_clam(size_arg, 4, dev))
        n = 100_000
        bag = torch.randn(n, d_in, generator=g).to(dev)
        mask = torch.arange(n, device=dev) < n - 1234
        with torch.inference_mode():
            got = gap.gated_attention_pool_partial(bag, p, mask=mask)
            want = gap.gated_attention_pool_partial_reference(bag, mask, p)
            torch.cuda.synchronize()
            rows.append(_pool_row(
                "gated_pool_partial", p, bag, _partial_err(got, want),
                lambda: gap.gated_attention_pool_partial(bag, p, mask=mask),
                lambda: gap.gated_attention_pool_partial_reference(
                    bag, mask, p),
                f"[{n},{d_in}] f32, L {p.w_f.shape[1]}, tail masked"))
        if len(rows) == 1:
            timed = _pool_bytes_flops(p, n)
        del bag, got, want
    first = rows[0]
    rec = record("gated_pool_partial",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/gated_pool.cu",
                 "hipt_abmil_atec23_tpu/ops/gated_attention_pool.py:153",
                 max(r["max_abs_err"] for r in rows), first["ms"],
                 first["plain_ms"], first["shape"], *timed,
                 F32_ACCURATE_FLOP_S, None)
    rec["bound_fma_ms"] = first["bound_fma_ms"]
    rec["other_shapes"] = rows[1:]
    return rec


def _device_pack(slide, coords, dev, caps=None, region=REGION):
    """One batch of ``slide``'s regions as a DctBatch on the card (caps
    probed from the slide unless given)."""
    if caps is None:
        caps, _ = probe_dct_caps(slide, coords, 0, region)
    pack = _decode_batch(slide, coords, patch_level=0, size=region,
                         bs=len(coords), n_io_threads=0,
                         dct_ctx=(slide.dct_probe(0), caps))
    if not hasattr(pack, "y_dc8"):
        raise SystemExit("the fixture slide did not read as a DCT pack")
    return pack, [torch.from_numpy(a).to(dev) for a in pack]


def decode_check(what, planes, taps, want_planes, want_taps) -> int:
    """The decode kernel against its plain version: every component's
    coefficient tap bit-equal to ``_unpack_component``, every plane within
    1 LSB of the plain plane on at most PLANE_SHARE of its samples (the
    IDCT sums in another order); returns the largest |d|."""
    worst = 0
    for name, p, t, wp, wt in zip(("Y", "Cb", "Cr"), planes, taps,
                                  want_planes, want_taps):
        if t.shape != wt.shape or not torch.equal(t, wt):
            n_bad = int((t != wt).sum()) if t.shape == wt.shape else -1
            raise SystemExit(f"dct_decode {what}: the {name} coefficient "
                             f"tap differs from the plain unpack "
                             f"({n_bad} coefficients)")
        if p.shape != wp.shape or p.dtype != torch.uint8:
            raise SystemExit(f"dct_decode {what}: {name} plane "
                             f"{tuple(p.shape)} {p.dtype}, plain "
                             f"{tuple(wp.shape)}")
        d = (p.int() - wp.int()).abs()
        share = (d > 0).float().mean().item()
        log(f"dct_decode {what} {name}: tap bit-equal, plane max |d| "
            f"{int(d.max())}, share of samples differing {share:.3g} "
            f"(<= 1 LSB on <= {PLANE_SHARE:g})")
        if d.max() > 1 or share > PLANE_SHARE:
            raise SystemExit(f"dct_decode {what}: {name} plane off the "
                             "plain version")
        worst = max(worst, int(d.max()))
    return worst


def colour_check(what, got, want) -> float:
    """The colour kernel against its plain version: equal up to one bf16
    ulp of the plain value's binade (bit-equal is what it is built for;
    the share is logged); returns the max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"ycc_input {what}: {tuple(got.shape)} {got.dtype}"
                         f", plain {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    err = (g - w).abs()
    ok = bool((err <= ulp).all() and torch.isfinite(g).all())
    equal = (g == w).float().mean().item()
    log(f"ycc_input {what}: max_abs_err {err.max().item():.6g}, share "
        f"bit-equal {equal:.6f}, within 1 bf16 ulp {ok}")
    if not ok:
        raise SystemExit(f"ycc_input disagrees with its plain version at "
                         f"{what}")
    return err.max().item()


def _decode_pair(pack):
    """The kernel's planes and coefficient taps, then the plain
    version's."""
    with torch.inference_mode():
        *planes, taps = jpegdct.dct_regions_to_planes(*pack, tap=True)
        want = jpegdct.dct_regions_to_planes_reference(*pack)
        want_taps = [jpegdct._unpack_component(*pack[9 * c:9 * c + 9],
                                               pack[27][c])
                     for c in range(3)]
    torch.cuda.synchronize()
    return planes, taps, want, want_taps


def idct_flops(host) -> int:
    """f32 operations of the decode kernel's IDCT on a host DctBatch: per
    block, pass 1 transforms its nu = max(count, 1) rows that ship (32 FMA
    + 8 adds each) and pass 2 its 4 row pairs (8 nu FMA + 16 adds each):
    136 nu + 64, where count is the block's shipped bitmap byte count (the
    few rows its explicit escapes add are left out)."""
    total = 0
    for c in range(3):
        dc8, bmc = host[9 * c], host[9 * c + 1]
        bl = dc8.shape[1] * dc8.shape[2]
        cnt = np.stack([bmc & 0xF, bmc >> 4], -1).reshape(len(bmc), -1)
        nu = np.maximum(cnt[:, :bl].astype(np.int64), 1)
        total += int((136 * nu + 64).sum())
    return total


def device_ms(fn, names, calls: int = 20) -> float:
    """Device ms per call of fn's kernels whose names hold one of
    ``names``, summed (torch.profiler)."""
    return sum(ms for k, ms in _launch_split(fn, calls).items()
               if any(n in k for n in names))


def _kernel_decode(dev, slide) -> dict:
    """The decode against its plain version at the main path's batch of
    two 4096^2 regions, an aligned pack and one off the MCU lattice (luma
    4112^2 blocks cropped by 16); timed on both: device time of its two
    kernels (DC pre-pass and decode; torch.profiler) and the call's time
    (CUDA events)."""
    worst, times = 0, {}
    for what, coords in (("aligned", [[0, 0], [REGION, REGION]]),
                         ("offset", [[8, 24], [REGION - 96, 2]])):
        host, pack = _device_pack(slide, np.array(coords), dev)
        planes, taps, want, want_taps = _decode_pair(pack)
        if planes[0].shape != (2, REGION, REGION):
            raise SystemExit(f"dct_decode {what}: Y {planes[0].shape}")
        worst = max(worst, decode_check(what, planes, taps, want,
                                        want_taps))
        with torch.inference_mode():
            call = lambda: jpegdct.dct_regions_to_planes(*pack)
            ms = device_ms(call, ("dc_kernel", "decode_kernel"))
            call_ms = gpu_timer(call)
            pms = gpu_timer(lambda: jpegdct.dct_regions_to_planes_reference(
                *pack), iters=3)
        nbytes = (sum(t.numel() * t.element_size() for t in pack)
                  + sum(p.numel() for p in planes))
        flops = idct_flops(host)
        times[what] = (ms, call_ms, pms, nbytes, flops)
        log(f"dct_decode {what}, one batch (DC pre-pass + decode): kernels "
            f"{ms:.4f} ms on the device, call {call_ms:.4f} ms, plain "
            f"{pms:.4f} ms; pack {sum(a.nbytes for a in host[:27]) / 1e6:.2f}"
            f" MB, {nbytes / 1e6:.1f} MB moved, IDCT {flops / 1e9:.3f} "
            "GFLOP")
    ms, call_ms, pms, nbytes, flops = times["aligned"]
    rec = record("dct_decode",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/dct_decode.cu",
                 "hipt_abmil_atec23_tpu/ops/jpegdct.py:166", worst, ms, pms,
                 "v3 pack -> Y [2,4096,4096] + Cb, Cr [2,2048,2048] uint8 "
                 "(one batch of two 4096^2 regions; DC pre-pass + decode)",
                 nbytes, flops, F32_FLOP_S, None)
    rec["call_ms"] = call_ms
    oms, ocall, opms, obytes, oflops = times["offset"]
    rec["offset"] = {"ms": oms, "call_ms": ocall, "plain_ms": opms,
                     "bound_ms": bound(obytes, oflops, F32_FLOP_S)[0]}
    return rec


def _region_planes(planes, n=2):
    """Y, Cb, Cr of the main path's first ``n`` 4096^2 regions of a
    plane slide, on the CPU."""
    _, y, cb, cr = planes
    h = REGION // 2
    cuts = [(0, 0), (REGION, REGION)][:n]
    return (torch.from_numpy(np.stack([y[a:a + REGION, b:b + REGION]
                                       for a, b in cuts])),
            *(torch.from_numpy(np.stack([c[a // 2:a // 2 + h,
                                           b // 2:b // 2 + h]
                                         for a, b in cuts]))
              for c in (cb, cr)))


def _kernel_colour(dev, planes) -> dict:
    """The colour kernel against its plain version at the main path's
    batch (two 4096^2 regions, 4:2:0, bf16 out), in f32 out, and at 4:2:2
    and 4:2:0 edges where W is not a multiple of its 16-pixel chunk."""
    y, cb, cr = (t.to(dev) for t in _region_planes(planes))
    worst = 0.0
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            got = yuv.ycc_to_input(y, cb, cr, dt)
            want = yuv.ycc_to_input_reference(y, cb, cr, dt)
            worst = max(worst, colour_check(f"4:2:0 [2,4096,4096] {dt}",
                                            got, want))
            del got, want
        g = torch.Generator().manual_seed(5)
        for layout, shape_y, shape_c in (("4:2:2", (3, 999, 1528),
                                          (3, 999, 764)),
                                         ("4:2:0", (3, 998, 1528),
                                          (3, 499, 764))):
            py, pb, pr = (torch.randint(0, 256, s, generator=g,
                                        dtype=torch.uint8).to(dev)
                          for s in (shape_y, shape_c, shape_c))
            for dt in (torch.bfloat16, torch.float32):
                colour_check(f"{layout} {list(shape_y)} {dt}",
                             yuv.ycc_to_input(py, pb, pr, dt),
                             yuv.ycc_to_input_reference(py, pb, pr, dt))
        torch.cuda.synchronize()
        call = lambda: yuv.ycc_to_input(y, cb, cr)
        ms = device_ms(call, ("ycc_kernel",))
        call_ms = gpu_timer(call)
        pms = gpu_timer(lambda: yuv.ycc_to_input_reference(y, cb, cr),
                        iters=3)
    px = y.numel()
    nbytes = px * 1.5 + px * 3 * 2
    log(f"ycc_input [2,4096,4096] 4:2:0 -> bf16: kernel {ms:.4f} ms on the "
        f"device, call {call_ms:.4f} ms, plain {pms:.4f} ms, "
        f"{nbytes / 1e6:.1f} MB moved")
    return record("ycc_input",
                  "hipt_abmil_atec23_tpu_torch/kernels/csrc/ycc_input.cu",
                  "hipt_abmil_atec23_tpu/ops/yuv.py:48 (XLA: yuv420_to_rgb "
                  "and the normalize; no pallas_call)", worst, ms, pms,
                  "Y [2,4096,4096] + Cb, Cr [2,2048,2048] uint8 -> "
                  "[2,4096,4096,3] bf16", nbytes, COLOUR_FLOPS_PER_PX * px,
                  F32_FLOP_S, None) | {"call_ms": call_ms}


def _check(name, what, got, want, tol) -> float:
    """Hold a kernel's bf16 output against its plain version: |got - want|
    <= atol + rtol |want| and finite; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= tol[0] + tol[1] * want.abs()).all()
              and torch.isfinite(got).all())
    log(f"{name} {what}: max_abs_err {err.max().item():.6g} within "
        f"{tol[0]:.3g} + {tol[1]:.3g} |plain| {ok}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version at {what}")
    return err.max().item()


def _mlp_inputs(rows, d, h, g, dev):
    bf16 = torch.bfloat16
    x = torch.randn(rows, d, generator=g).to(dev, bf16)
    w1 = (torch.randn(d, h, generator=g) * d ** -0.5).to(dev, bf16)
    w2 = (torch.randn(h, d, generator=g) * h ** -0.5).to(dev, bf16)
    b1 = (0.1 * torch.randn(h, generator=g)).to(dev)
    b2 = (0.1 * torch.randn(d, generator=g)).to(dev)
    gamma = (1 + 0.1 * torch.randn(d, generator=g)).to(dev)
    beta = (0.1 * torch.randn(d, generator=g)).to(dev)
    return x, gamma, beta, w1, b1, w2, b2


def _mlp_chain(x, gamma, beta, w1, b1, w2, b2, eps=1e-6):
    """The same function as a chain of torch calls in x's dtype (bf16 on
    the card): F.layer_norm -> F.linear -> F.gelu -> F.linear -> + x.
    Context for fused_mlp's time, several calls and so not its library_ms;
    never called by the port."""
    dt = x.dtype
    xn = F.layer_norm(x, (x.shape[-1],), gamma.to(dt), beta.to(dt), eps)
    h = F.gelu(F.linear(xn, w1.t(), b1.to(dt)))
    return F.linear(h, w2.t(), b2.to(dt)) + x


def _mlp_bytes_flops(rows, d, h):
    """x in and out; the weights and vectors once; two products."""
    return (2 * rows * d * 2 + 2 * d * h * 2 + (h + 3 * d) * 4,
            4.0 * rows * d * h)


# fused_mlp's two per-op shapes: ViT-256's per-block call at the slice's
# batch (512 tiles x 257 tokens; 48 launches per 8 regions) and ViT-4K's
# (2 x 257 rows, D 192; 24)
MLP_TIMED = ((131584, 384, 1536), (514, 192, 768))


def _kernel_mlp(dev, g, block_split) -> dict:
    """fused_mlp in both modes against its plain version at both per-op
    shapes (timed, LN + residual, beside the bf16 chain of torch calls and
    B.1's LN2 + FC1 + FC2 launches at [512,264,384] from ``block_split``)
    and a ragged narrow shape."""
    worst, timed = 0.0, []
    for rows, d, h in [*MLP_TIMED, (131, 64, 256)]:
        args = _mlp_inputs(rows, d, h, g, dev)
        for with_ln in (True, False):
            with torch.inference_mode():
                if with_ln:
                    fn = lambda: fm.fused_ln_mlp_residual(*args)
                else:
                    fn = lambda: fm.fused_mlp(args[0], *args[3:])
                got = fn()
                want = fm.fused_mlp_reference(*args, with_ln=with_ln,
                                              residual=with_ln)
                torch.cuda.synchronize()
                what = (f"[{rows},{d}] H {h} "
                        f"{'LN+residual' if with_ln else 'plain MLP'}")
                worst = max(worst, _check("fused_mlp", what, got, want,
                                          MLP_TOL))
                if with_ln and (rows, d, h) in MLP_TIMED:
                    ms = gpu_timer(fn)
                    pms = gpu_timer(lambda: fm.fused_mlp_reference(
                        *args, with_ln=True, residual=True), iters=3)
                    chain = gpu_timer(lambda: _mlp_chain(*args))
                    b_ms, _ = bound(*_mlp_bytes_flops(rows, d, h),
                                    BF16_FLOP_S)
                    log(f"fused_mlp {what}: kernel {ms:.4f} ms, plain "
                        f"{pms:.4f} ms, bf16 torch chain {chain:.4f} ms, "
                        f"bound {b_ms:.4f} ms")
                    timed.append({"shape": f"[{rows},{d}] bf16, H {h}, LN + "
                                  "residual", "ms": ms, "plain_ms": pms,
                                  "chain_ms": chain, "bound_ms": b_ms,
                                  "work": _mlp_bytes_flops(rows, d, h)})
        del args
    b1 = {k: block_split[k] for k in ("LN2", "FC1", "FC2") if k in block_split}
    b1_ms = sum(b1.values())
    log(f"fused_mlp [131584,384] {timed[0]['ms']:.4f} ms against B.1's "
        f"LN2 + FC1 + FC2 launches at [512,264,384] (135168 rows) "
        f"{b1_ms:.4f} ms in this run ({b1})")
    first = timed[0]
    rec = record("fused_mlp",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/fused_mlp.cu",
                 "hipt_abmil_atec23_tpu/ops/fused_mlp.py:44", worst,
                 first["ms"], first["plain_ms"], first["shape"],
                 *first["work"], BF16_FLOP_S, None)
    rec.update(chain_ms=first["chain_ms"],
               fused_block_ln2_fc1_fc2_ms=b1_ms,
               also={k: v for k, v in timed[1].items() if k != "work"})
    return rec


def _qkv(bh, n, d, g, dev):
    """Unit-normal k and v and a q at Q_SCALE: with unit logits the output
    at long N is a near-uniform average of ~6e-3 RMS that hides a dropped
    key tile."""
    q, k, v = (torch.randn(bh, n, d, generator=g) for _ in range(3))
    return [t.to(dev, torch.bfloat16) for t in (q * Q_SCALE, k, v)]


def _attn_check(name, what, got, want) -> float:
    """Attention against its plain version with the atol scaled to the
    plain output: |got - want| <= 5e-2 rms(want) + 2e-2 |want|. The
    output's spread depends on N and the logits, so a fixed atol would be
    loose at long N."""
    rms = want.float().square().mean().sqrt().item()
    return _check(name, what, got, want, (ATTN_TOL[0] * rms, ATTN_TOL[1]))


def sdpa_valid_keys(q, k, v, n_valid):
    """The one PyTorch call that computes what both attention kernels do:
    scaled_dot_product_attention over the first n_valid keys (the kernels
    give keys >= n_valid a score of -1e30, whose weight is exactly 0 in
    f32). q, k, v [BH, N, d] -> [BH, N, d]. The yardstick only; the port
    never calls it."""
    return F.scaled_dot_product_attention(
        q[None], k[None, :, :n_valid], v[None, :, :n_valid])[0]


def _sdpa_ms(q, k, v, n_valid) -> float:
    """library_ms of both attention kernels: sdpa_valid_keys, timed. The
    call with a boolean key mask over all N keys, which takes SDPA off its
    flash backend, is logged beside it."""
    mask = torch.arange(q.shape[1], device=q.device)[None, :] < n_valid
    with torch.inference_mode():
        ms = gpu_timer(lambda: sdpa_valid_keys(q, k, v, n_valid))
        masked = gpu_timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
    log(f"scaled_dot_product_attention [{q.shape[0]},{q.shape[1]},"
        f"{q.shape[2]}] valid {n_valid}: over the valid keys {ms:.4f} ms, "
        f"with a boolean key mask {masked:.4f} ms")
    return ms


def _attn_bytes_flops(bh, n, n_valid, d):
    """q, k, v read and o written once in bf16; QK^T and PV over the
    valid keys."""
    return 4 * bh * n * d * 2, 4.0 * bh * n * n_valid * d


def _time_attention(name, kernel, plain, q, k, v, nv, plain_iters):
    """Kernel, plain version and SDPA over the valid keys on one input,
    with the bound of the same work."""
    bh, n, d = q.shape
    with torch.inference_mode():
        ms = gpu_timer(lambda: kernel(q, k, v, nv), iters=5 if n > 8192
                       else 10)
        pms = gpu_timer(lambda: plain(q, k, v, nv), iters=plain_iters)
    lib = _sdpa_ms(q, k, v, nv)
    nbytes, flops = _attn_bytes_flops(bh, n, nv, d)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_S)
    log(f"{name} [{bh},{n},{d}] valid {nv}: kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, scaled_dot_product_attention over the valid keys "
        f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"shape": f"[{bh},{n},{d}] bf16, valid {nv}", "ms": ms,
            "plain_ms": pms, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by, "nbytes": nbytes, "flops": flops}


# fused_attention's two shapes on the per-op path, both timed: ViT-256's
# per-block call at the slice's batch (512 tiles x 6 heads of 64) and
# ViT-4K's (2 regions x 6 heads of 32)
ATTN_TIMED = ((3072, 257, 64), (12, 257, 32))


def _kernel_attention(dev, g) -> dict:
    """fused_attention against its plain version at both per-op shapes
    (ATTN_TIMED, each timed), a masked ragged shape and, through
    attention(), a medium N the dispatcher sends to the query-tiled branch
    (the kernel's streamed mode)."""
    worst, timed = 0.0, []
    for bh, n, nv, d in [(3072, 257, 257, 64), (12, 257, 257, 32),
                         (4, 100, 37, 64), (8, 1500, 1400, 64)]:
        q, k, v = _qkv(bh, n, d, g, dev)
        with torch.inference_mode():
            got = fa.attention(q, k, v, nv)
            want = fa.attention(q, k, v, nv, plain=True)
            torch.cuda.synchronize()
        worst = max(worst, _attn_check("fused_attention", f"[{bh},{n},{d}] "
                                       f"valid {nv}", got, want))
        if (bh, n, d) in ATTN_TIMED:
            timed.append(_time_attention(
                "fused_attention", fa.fused_attention,
                fa.fused_attention_reference, q, k, v, nv, 3))
        del q, k, v, got, want
    t = timed[0]
    rec = record("fused_attention",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/flash_attention.cu",
                 "hipt_abmil_atec23_tpu/ops/flash_attention.py:50", worst,
                 t["ms"], t["plain_ms"], t["shape"], t["nbytes"], t["flops"],
                 BF16_FLOP_S, t["library_ms"])
    rec["also"] = [{k: o[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
                   for o in timed[1:]]
    return rec


def _kernel_flash(dev, g):
    """flash_attention against its plain version: direct calls at masked
    and head-size-32 shapes, then attention() at [1, 65536, 64] bf16, past
    12 MiB of K/V, where the dispatcher takes its flash branch. That call
    is the kernel's path: counts are zeroed before it and read after.
    Returns the record and that path's counts."""
    worst = 0.0
    for bh, n, nv, d in [(2, 768, 700, 64), (3, 300, 300, 32)]:
        q, k, v = _qkv(bh, n, d, g, dev)
        with torch.inference_mode():
            got = fa.flash_attention(q, k, v, nv)
            want = fa.flash_attention_reference(q, k, v, nv)
            torch.cuda.synchronize()
        worst = max(worst, _attn_check("flash_attention", f"[{bh},{n},{d}] "
                                       f"valid {nv}", got, want))
    bh, n, d = 1, 65536, 64
    if fa.attention_branch(n, d, 2) != "flash":
        raise SystemExit(f"attention() would not take its flash branch at "
                         f"[{bh},{n},{d}] bf16")
    q, k, v = _qkv(bh, n, d, g, dev)
    zero_counts()
    with torch.inference_mode():
        got = fa.attention(q, k, v)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"attention() at [{bh},{n},{d}] bf16 launches: {counts}")
    if counts["flash_attention"] == 0:
        raise SystemExit("attention() at long N never launched "
                         "flash_attention")
    with torch.inference_mode():
        want = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
    worst = max(worst, _attn_check("flash_attention", f"[{bh},{n},{d}] "
                                   "via attention()", got, want))
    t = _time_attention("flash_attention", fa.flash_attention,
                        fa.flash_attention_reference, q, k, v, n, 2)
    rec = record("flash_attention",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/flash_attention.cu",
                 "hipt_abmil_atec23_tpu/ops/flash_attention.py:128", worst,
                 t["ms"], t["plain_ms"], t["shape"], t["nbytes"], t["flops"],
                 BF16_FLOP_S, t["library_ms"])
    return rec, counts


def _row_cosine(a, b) -> float:
    """Least cosine between matching rows (tokens) of two tensors."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def _first_block_tokens(model, regions):
    """The tokens that reach ViT-256's first block on ``regions`` (padded,
    f32) and their valid count, caught by a forward pre-hook."""
    seen = {}

    def grab(_, args):
        seen["tok"], seen["n_valid"] = args[0], args[1]

    hook = model.vit256.blocks[0].register_forward_pre_hook(grab)
    try:
        with torch.inference_mode():
            model(hipt_eval_normalize(regions))
    finally:
        hook.remove()
    return seen["tok"], seen["n_valid"]


def _network_library_ms(b, n, nv, d, heads, depth, dev) -> float:
    """One nn.TransformerEncoder call (``depth`` pre-LN GELU layers, the
    same widths, key padding mask): the yardstick for fused_network, timed
    here and never called by the port."""
    layer = torch.nn.TransformerEncoderLayer(
        d, heads, 4 * d, dropout=0.0, activation="gelu",
        layer_norm_eps=1e-6, batch_first=True, norm_first=True)
    stack = torch.nn.TransformerEncoder(layer, depth,
                                        enable_nested_tensor=False)
    stack = stack.to(dev, torch.bfloat16).eval()
    x = torch.randn(b, n, d, device=dev, dtype=torch.bfloat16)
    pad = torch.arange(n, device=dev)[None, :].expand(b, n) >= nv
    with torch.inference_mode():
        return gpu_timer(lambda: stack(x, src_key_padding_mask=pad))


# B.8's stages between grid barriers, in a block's order
STAGE_KINDS = ("LN1", "QKV", "attention", "PROJ", "LN2", "FC1", "FC2")


def stage_split(clock, depth: int) -> dict:
    """B.8's ms per stage kind summed over the blocks, from one clocked
    launch's stamps (CTA 0's %globaltimer, ns: the start, then arrival and
    departure at each grid barrier). A stage runs from the last departure
    to CTA 0's arrival; "barriers" is CTA 0's wait at the barriers, which
    holds the barrier itself and any CTA that finished its share later
    (also split by the stage before it, "wait after")."""
    c = [int(v) for v in clock]
    kinds = list(STAGE_KINDS) * depth
    if len(c) != 1 + 2 * len(kinds):
        raise ValueError(f"{len(c)} stamps for {depth} blocks")
    out = dict.fromkeys([*STAGE_KINDS, "barriers"], 0.0)
    wait = dict.fromkeys(STAGE_KINDS, 0.0)
    for i, kind in enumerate(kinds):
        arrive, leave = c[1 + 2 * i], c[2 + 2 * i]
        out[kind] += (arrive - c[2 * i]) * 1e-6
        wait[kind] += (leave - arrive) * 1e-6
    out["barriers"] = sum(wait.values())
    out["total"] = (c[-1] - c[0]) * 1e-6
    out["wait after"] = wait
    return out


def _network_stage_split(x, ws, heads, nv, depth, runs: int = 3) -> dict:
    """The mean of ``runs`` clocked launches' stage splits (launches made to
    measure, not counted)."""
    from hipt_abmil_atec23_tpu_torch.ops import fused_network as fnw
    clock = torch.zeros(fnw.clock_len(depth), dtype=torch.int64,
                        device=x.device)
    splits = []
    with torch.inference_mode():
        for _ in range(runs):
            fnw._launch(x, ws, num_heads=heads, n_valid=nv, eps=1e-6,
                        clock=clock)
            torch.cuda.synchronize()
            splits.append(stage_split(clock.cpu().tolist(), depth))
    mean = {k: sum(sp[k] for sp in splits) / runs for k in splits[0]
            if k != "wait after"}
    mean["wait after"] = {k: sum(sp["wait after"][k] for sp in splits) / runs
                          for k in splits[0]["wait after"]}
    log("fused_network stage split, ms summed over the "
        f"{depth} blocks (mean of {runs} clocked launches): " +
        ", ".join(f"{k} {v:.4f}" for k, v in mean.items()
                  if k != "wait after") +
        "; barrier wait after " +
        ", ".join(f"{k} {v:.4f}" for k, v in mean["wait after"].items()))
    return mean


def _kernel_network(dev, regions, g):
    """fused_network against its plain version: the 12 ViT-256 blocks of a
    seeded full-width encoder, stacked, on the tokens that reach its first
    block from two 4096^2 regions ([512, 264, 384] bf16, n_valid 257).
    That call is the kernel's path: counts are zeroed before it and read
    after. Then three blocks at an f32 shape, and for the record the
    encoder's own chain of 12 block-kernel calls (which rounds the residual
    to bf16 between blocks) and one nn.TransformerEncoder call. Returns
    the record and the path's counts."""
    model = make_hipt_encoder(
        torch.bfloat16, use_fused_block=True,
        generator=torch.Generator().manual_seed(7)).to(dev).eval()
    vit = model.vit256
    heads, depth = vit.cfg.num_heads, vit.cfg.depth
    tok, nv = _first_block_tokens(model, regions)
    x = tok.to(torch.bfloat16)
    b, n, d = x.shape
    ws = stack_blocks(vit.blocks)
    run = lambda: fused_vit_network(x, *ws, num_heads=heads, n_valid=nv)
    zero_counts()
    with torch.inference_mode():
        got = run()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"fused_vit_network at [{b},{n},{d}] T {depth} bf16 launches: "
        f"{counts}")
    if counts["fused_network"] != 1:
        raise SystemExit("fused_vit_network did not launch its kernel once")

    def chain(y=x):
        for blk in vit.blocks:
            y = fused_vit_block(y, blk, num_heads=heads, n_valid=nv)
        return y

    what = f"[{b},{n},{d}] T {depth} bf16, n_valid {nv}"
    with torch.inference_mode():
        want = fused_vit_network_reference(x, *ws, num_heads=heads,
                                           n_valid=nv)
        chained = chain()
        torch.cuda.synchronize()
    worst = _check("fused_network", what, got, want, BLOCK_TOL)
    cos = _row_cosine(got[:, :nv], want[:, :nv])
    log(f"fused_network {what}: min cosine over valid rows {cos:.7f} "
        f"(>= 0.9999)")
    if cos < 0.9999:
        raise SystemExit("fused_network disagrees with its plain version")
    dch = (got.float() - chained.float()).abs()
    cos_ch = _row_cosine(got[:, :nv], chained[:, :nv])
    log(f"fused_network vs the chained block kernel (bf16 residual between "
        f"blocks): max |d| {dch.max().item():.6g}, mean "
        f"{dch.mean().item():.6g}, min cosine {cos_ch:.7f} (>= 0.999)")
    if cos_ch < 0.999:
        raise SystemExit("fused_network disagrees with the chained blocks")
    xs = torch.randn(4, 24, d, generator=g).to(dev)
    ws3 = [w[:3] for w in ws]
    with torch.inference_mode():
        gs = fused_vit_network(xs, *ws3, num_heads=heads, n_valid=20)
        wsf = fused_vit_network_reference(xs, *ws3, num_heads=heads,
                                          n_valid=20)
        torch.cuda.synchronize()
    if gs.dtype != torch.float32:
        raise SystemExit(f"fused_network wrote {gs.dtype} for f32 x")
    worst = max(worst, _check("fused_network", f"[4,24,{d}] T 3 f32, "
                              "n_valid 20", gs, wsf, BLOCK_TOL))
    with torch.inference_mode():
        ms = gpu_timer(run)
        pms = gpu_timer(lambda: fused_vit_network_reference(
            x, *ws, num_heads=heads, n_valid=nv), iters=3)
        chained_ms = gpu_timer(chain)
        # the same chain on an f32 residual, which B.8 keeps across blocks
        xf = x.float()
        chained_f32_ms = gpu_timer(lambda: chain(xf))
    lib = _network_library_ms(b, n, nv, d, heads, depth, dev)
    # bytes: x in and out in bf16, the stacked bf16 GEMM weights and f32
    # vectors; ops: T blocks' GEMMs and attention over the valid tokens
    nbytes = 2 * x.numel() * 2 + sum(
        w.numel() * (2 if w.dim() == 3 else 4) for w in ws)
    flops = depth * (2 * b * nv * d * 12 * d + 4 * b * nv * nv * d)
    rec = record("fused_network",
                 "hipt_abmil_atec23_tpu_torch/kernels/csrc/fused_network.cu",
                 "hipt_abmil_atec23_tpu/ops/fused_network.py:46", worst, ms,
                 pms, f"[{b},{n},{d}] bf16, T {depth}, n_valid {nv}",
                 nbytes, flops, BF16_FLOP_S, lib)
    rec.update(chained_fused_block_ms=chained_ms,
               chained_fused_block_f32_ms=chained_f32_ms,
               vs_chained_max_abs=dch.max().item(),
               vs_chained_mean_abs=dch.mean().item(),
               stage_ms=_network_stage_split(x, ws, heads, nv, depth))
    log(f"fused_network {what}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"{depth} chained fused_block {chained_ms:.4f} ms (on an f32 "
        f"residual {chained_f32_ms:.4f} ms), "
        f"nn.TransformerEncoder {lib:.4f} ms, bound {rec['bound_ms']:.4f} "
        f"ms ({rec['bound_by']})")
    return rec, {"launches": counts,
                 "owned": {"fused_network": counts["fused_network"]}}


def _kernel_label(mangled: str) -> str:
    """gemm_kernel<3>, network_kernel<bf16,64>, ... from a mangled name."""
    m = re.search(r"(layernorm_kernel|gemm_kernel|fused_attention_kernel|"
                  r"flash_attention_kernel|attention_kernel|network_kernel|"
                  r"fused_mlp_kernel|pool_pass1_tc|pool_pass1|ycc_kernel)"
                  r"I(.*?)EE", mangled)
    if not m:
        return mangled
    args = ["bf16" if a.startswith("13") else "f32" if a == "f" else a[2:]
            for a in re.findall(r"13__nv_bfloat16|L[ib]\d+|f", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def build_report(build, name: str) -> None:
    """What nvcc -Xptxas -v said of each kernel of lib<name>.so (registers,
    shared memory, spills) and, where cuobjdump is present, how many HGMMA
    (wgmma) instructions its SASS holds."""
    label = None
    with open(os.path.join(build.BUILD_DIR, f"lib{name}.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                label = _kernel_label(m.group(1))
            elif label and ("spill" in line or "Used" in line):
                log(f"ptxas {name} {label}: {line.split(':')[-1].strip()}")
            elif "warning" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    cob = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.exists(cob):
        sass = subprocess.run(
            [cob, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
            capture_output=True, text=True, timeout=120).stdout
        log(f"SASS lib{name}.so: "
            f"{sum('HGMMA' in l for l in sass.splitlines())} HGMMA "
            "instructions")
    else:
        log(f"SASS lib{name}.so: no cuobjdump at {cob}")


def phase_kernels(dev, dct_slide, planes, regions) -> dict:
    """Each kernel against its plain version: the JSON records, and the
    results of the two paths phase 2 drives (attention() at long N, which
    owns flash_attention, and fused_vit_network, which owns
    fused_network). ``planes``: a plane slide's (rgb, y, cb, cr);
    ``regions``: two 4096^2 RGB regions, uint8."""
    from hipt_abmil_atec23_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    for name in SOURCES:
        build.load(name)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_DIR})")
    for name in ("fused_block", "fused_network", "flash_attention",
                 "fused_mlp", "gated_pool", "dct_decode", "ycc_input"):
        build_report(build, name)
    g = torch.Generator().manual_seed(0)
    records = {"fused_block": _kernel_block(dev, g),
               "gated_pool": _kernel_pool(dev, g),
               "gated_pool_partial": _kernel_pool_partial(dev, g),
               "dct_decode": _kernel_decode(dev, dct_slide),
               "ycc_input": _kernel_colour(dev, planes)}
    records["fused_mlp"] = _kernel_mlp(dev, g,
                                       records["fused_block"]["stage_ms"])
    records["fused_attention"] = _kernel_attention(dev, g)
    records["flash_attention"], launches = _kernel_flash(dev, g)
    paths = {"attention_long_n": {
        "launches": launches,
        "owned": {"flash_attention": launches["flash_attention"]}}}
    torch.cuda.empty_cache()
    records["fused_network"], paths["network"] = _kernel_network(
        dev, regions, g)
    torch.cuda.empty_cache()
    return {"records": records, "paths": paths}


# ------------------------------------------------------------------ phase 3
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


def grid_coords(slide=SLIDE, region=REGION):
    grid = np.arange(0, slide, region)
    return np.stack(np.meshgrid(grid, grid, indexing="ij"),
                    -1).reshape(-1, 2)[:, ::-1].copy()


def encode_slides(jobs, encoder, region, **kw):
    """encode_stream over the jobs; returns ({sid: feats}, wall s)."""
    def sync():
        if encoder.device.type == "cuda":
            torch.cuda.synchronize(encoder.device)

    sync()
    t0 = time.perf_counter()
    feats = dict(encode_stream(jobs, encoder, region_size=region, **kw))
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


COUNTERS = {"fused_block": fused_vit_block,
            "fused_network": fused_vit_network,
            "gated_pool": gap.gated_attention_pool,
            "gated_pool_partial": gap.gated_attention_pool_partial,
            "dct_decode": jpegdct.dct_regions_to_planes,
            "ycc_input": yuv.ycc_to_input,
            "fused_mlp": fm.fused_mlp,
            "fused_attention": fa.fused_attention,
            "flash_attention": fa.flash_attention}


def zero_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def feature_agreement(feats, other):
    """(min cosine, max relative L2) per region between two feature sets
    keyed by slide."""
    worst_cos, worst_rel = 1.0, 0.0
    for sid, f in feats.items():
        pf = other[sid]
        cos = (f * pf).sum(1) / (np.linalg.norm(f, axis=1)
                                 * np.linalg.norm(pf, axis=1))
        rel = np.linalg.norm(f - pf, axis=1) / np.linalg.norm(pf, axis=1)
        worst_cos = min(worst_cos, float(cos.min()))
        worst_rel = max(worst_rel, float(rel.max()))
    return worst_cos, worst_rel


def check_features(feats, plain_feats, outs, n_regions, feat_dim):
    """Kernel-path features against the plain pass (cosine >= 0.999, rel
    L2 <= 2e-2 per region) and the pooled scores against the plain pool."""
    for sid, f in feats.items():
        if f.shape != (n_regions, feat_dim) or not np.isfinite(f).all():
            raise SystemExit(f"{sid}: bad features {f.shape}")
    worst_cos, worst_rel = feature_agreement(feats, plain_feats)
    for sid in feats:
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


def phase_slice(dev, planes, *, slide=SLIDE, region=REGION, batch=2,
                vit256_cfg=None, vit4k_cfg=None) -> dict:
    """The port's main path on in-memory plane slides, then the plain
    pass. ``planes``: (rgb, y, cb, cr) per slide."""
    kw = {}
    if vit256_cfg is not None:
        kw = dict(vit256_cfg=vit256_cfg, vit4k_cfg=vit4k_cfg)
    dtype = torch.bfloat16
    kernel_model = make_hipt_encoder(
        dtype, use_fused_block=True,
        generator=torch.Generator().manual_seed(0), **kw)
    plain_model = _plain_copy(kernel_model, kw, False, False, True)
    cfg = EncoderConfig(model_type="HIPT_4K", batch_size=batch,
                        dtype="bfloat16")
    enc = build_encoder(cfg, device=dev, model=kernel_model)
    plain_enc = build_encoder(cfg, device=dev, model=plain_model)
    plain_enc.plain_unpack = True
    clam = _random_clam(torch.Generator().manual_seed(1), dev)

    slides = {f"mem{i}": PlaneSlide(*p) for i, p in enumerate(planes)}
    coords = grid_coords(slide, region)
    jobs = [(sid, s, coords) for sid, s in slides.items()]
    log(f"plane slides: {len(slides)} x {slide}^2, {len(coords)} regions "
        f"each")

    encode_slides(jobs[:1], enc, region)  # warm-up (cuBLAS, allocator)
    zero_counts()
    feats, wall = encode_slides(jobs, enc, region)
    outs = {sid: score(clam, f, dev) for sid, f in feats.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = read_counts()
    n_regions = sum(len(f) for f in feats.values())
    log(f"plane path launches: {launches}")

    plain_feats, plain_wall = encode_slides(jobs, plain_enc, region)
    check_features(feats, plain_feats, outs, len(coords), enc.feat_dim)
    ms_k = wall * 1e3 / n_regions
    ms_p = plain_wall * 1e3 / n_regions
    log(f"plane rung, ms per {region}^2 region (decode + H2D + encode, "
        f"batch {batch}): kernel path {ms_k:.2f}, plain path {ms_p:.2f}")
    for name in ("fused_block", "gated_pool", "ycc_input"):
        if launches[name] == 0:
            raise SystemExit(f"the plane path never launched {name}")
    if launches["dct_decode"]:
        raise SystemExit("the plane path launched dct_decode")
    return {"launches": launches, "owned": {"ycc_input": launches[
                "ycc_input"]}, "ms_region": ms_k,
            "plain_ms_region": ms_p, "encoder": enc,
            "plain_encoder": plain_enc, "clam": clam, "feats": feats,
            "jobs": jobs, "widths": kw}


def _plain_copy(model, widths, *flags):
    """A model of the same configuration and weights whose blocks run every
    kernel op's plain version."""
    plain = make_hipt_encoder(torch.bfloat16, *flags, **widths)
    plain.load_state_dict(model.state_dict())
    for m in plain.modules():
        if isinstance(m, Block):
            m.plain = True
    return plain


# ------------------------------------------------------------------ phase 5
def phase_per_op_slice(dev, res, *, region=REGION, batch=2) -> dict:
    """The per-op configuration (use_flash + use_fused_mlp) on phase 3's
    plane slides and weights, through build_encoder(model=...) ->
    encode_stream -> CLAM_SB; then its plain pass."""
    jobs, clam, widths = res["jobs"], res["clam"], res["widths"]
    flags = (True, True)  # use_flash, use_fused_mlp
    model = make_hipt_encoder(torch.bfloat16, *flags, **widths)
    model.load_state_dict(res["encoder"].model.state_dict())
    cfg = EncoderConfig(model_type="HIPT_4K", batch_size=batch,
                        dtype="bfloat16")
    enc = build_encoder(cfg, device=dev, model=model)
    plain_enc = build_encoder(cfg, device=dev,
                              model=_plain_copy(model, widths, *flags))
    plain_enc.plain_unpack = True
    n_coords = len(jobs[0][2])

    encode_slides(jobs[:1], enc, region)  # warm-up (cuBLAS, allocator)
    zero_counts()
    feats, wall = encode_slides(jobs, enc, region)
    outs = {sid: score(clam, f, dev) for sid, f in feats.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = read_counts()
    n_regions = sum(len(f) for f in feats.values())
    log(f"per-op path launches: {launches}")

    plain_feats, plain_wall = encode_slides(jobs, plain_enc, region)
    check_features(feats, plain_feats, outs, n_coords, enc.feat_dim)
    cos, rel = feature_agreement(feats, res["feats"])
    log(f"features per-op vs fused-block configuration (same weights): min "
        f"cosine {cos:.6f} (>= 0.99), max rel L2 {rel:.3g}")
    if cos < 0.99:
        raise SystemExit("per-op features disagree with the fused-block "
                         "configuration")
    ms_k = wall * 1e3 / n_regions
    ms_p = plain_wall * 1e3 / n_regions
    log(f"plane rung, ms per {region}^2 region (decode + H2D + encode, "
        f"batch {batch}): per-op kernel path {ms_k:.2f}, per-op plain path "
        f"{ms_p:.2f}, fused-block kernel path {res['ms_region']:.2f}")
    for name in ("fused_attention", "fused_mlp", "gated_pool", "ycc_input"):
        if launches[name] == 0:
            raise SystemExit(f"the per-op path never launched {name}")
    if launches["fused_block"]:
        raise SystemExit("the per-op path launched fused_block")
    owned = {n: launches[n] for n in ("fused_attention", "fused_mlp")}
    return {"launches": launches, "owned": owned, "ms_region": ms_k,
            "plain_ms_region": ms_p, "encoder": enc}


# ------------------------------------------------------------------ phase 4
def _rung_seeds(slide, coords, enc, caps, region) -> None:
    """Per-rung stage costs in ms/Mpx for the rung tables of
    engine/encode.py: the host read of one batch of the fixture slide, and
    the encoder on that batch already on the card (CUDA events)."""
    dev, bs = enc.device, enc.batch_size
    chunk = coords[:bs]
    mpx = bs * region * region / 1e6
    ctx = {"dct": dict(dct_ctx=(slide.dct_probe(0), caps)),
           "yuv": dict(use_yuv=(2, 2)), "rgb": {}}
    host, dev_ms = {}, {}
    for rung, kw in ctx.items():
        t0 = time.perf_counter()
        buf = _decode_batch(slide, chunk, patch_level=0, size=region, bs=bs,
                            n_io_threads=0, **kw)
        host[rung] = (time.perf_counter() - t0) * 1e3 / mpx
        bufs = [torch.from_numpy(a).to(dev)
                for a in (buf if isinstance(buf, tuple) else (buf,))]
        fn = {"dct": enc.apply_dct, "yuv": enc.apply_yuv,
              "rgb": enc.apply}[rung]
        dev_ms[rung] = gpu_timer(lambda: fn(*bufs), iters=2) / mpx
    fmt = lambda t: "{" + ", ".join(f'"{k}": {v:.2f}'
                                    for k, v in t.items()) + "}"
    log(f"rung seeds, ms/Mpx at {region}^2 batch {bs}: "
        f"RUNG_HOST_MS_PER_MPX = {fmt(host)}  RUNG_DEV_MS_PER_MPX = "
        f"{fmt(dev_ms)}")


def phase_dct_slice(dev, res, slides, *, region=REGION) -> dict:
    """The sparse-DCT rung of the main path on in-memory JPEG-coefficient
    slides, then the plain pass, a plane check and an adaptive stream."""
    enc, plain_enc, clam = res["encoder"], res["plain_encoder"], res["clam"]
    slide_px = slides[0].level_dimensions[0][0]
    coords = grid_coords(slide_px, region)
    jobs = [(f"dct{i}", s, coords) for i, s in enumerate(slides)]
    log(f"DCT slides: {len(slides)} x {slide_px}^2, {len(coords)} regions "
        f"each")

    zero_counts()
    stats = {}
    feats, wall = encode_slides(jobs, enc, region, adaptive_rungs=False,
                                stats=stats)
    outs = {sid: score(clam, f, dev) for sid, f in feats.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = read_counts()
    n_regions = sum(len(f) for f in feats.values())
    log(f"DCT path launches: {launches}; stream stats: regions_dct "
        f"{stats.get('regions_dct', 0)}, h2d {stats['h2d_bytes'] / 1e6:.1f}"
        f" MB, caps {stats.get('dct_caps')}")
    if stats.get("regions_dct", 0) != n_regions:
        raise SystemExit(f"only {stats.get('regions_dct', 0)} of "
                         f"{n_regions} regions rode the DCT rung")

    plain_feats, plain_wall = encode_slides(jobs, plain_enc, region,
                                            adaptive_rungs=False)
    check_features(feats, plain_feats, outs, len(coords), enc.feat_dim)
    ms_k = wall * 1e3 / n_regions
    ms_p = plain_wall * 1e3 / n_regions
    log(f"DCT rung, ms per {region}^2 region (host pack + H2D + decode + "
        f"encode, batch {enc.batch_size}): kernel path {ms_k:.2f}, plain "
        f"path {ms_p:.2f}")

    # the card's decode of one batch against the slide's own numpy decode
    caps = stats["dct_caps"]
    chunk = coords[:enc.batch_size]
    _, pack = _device_pack(slides[0], chunk, dev, caps, region)
    with torch.inference_mode():
        got = jpegdct.dct_regions_to_planes(*pack)
    want = slides[0].read_regions_yuv420(chunk, 0, (region, region))
    for name, g, w in zip(("Y", "Cb", "Cr"), got, want):
        d = np.abs(g.cpu().numpy().astype(np.int16) - w.astype(np.int16))
        log(f"DCT planes {name} vs the slide's decode: max |d| {d.max()}, "
            f"mean {d.mean():.3g} (<= 1 LSB)")
        if d.max() > 1:
            raise SystemExit(f"DCT {name} plane off by {d.max()} LSB")

    _rung_seeds(slides[0], coords, enc, caps, region)
    astats = {}
    encode_slides(jobs, enc, region, adaptive_rungs=True, stats=astats)
    cal = astats["rung_calibration"]
    log(f"adaptive stream: rung_decisions {astats.get('rung_decisions')}, "
        f"regions dct/yuv/rgb {astats.get('regions_dct', 0)}/"
        f"{astats.get('regions_yuv', 0)}/{astats.get('regions_rgb', 0)}, "
        f"wire {astats.get('wire_mbps_final') or 0:.0f} MB/s")
    rounded = {t: {k: round(v, 2) for k, v in cal[t].items()}
               for t in ("host_ms_mpx", "dev_ms_mpx")}
    log(f"adaptive stream calibration: host_ms_mpx "
        f"{rounded['host_ms_mpx']} dev_ms_mpx {rounded['dev_ms_mpx']}")
    for name in ("dct_decode", "ycc_input", "fused_block", "gated_pool"):
        if launches[name] == 0:
            raise SystemExit(f"the DCT path never launched {name}")
    owned = {n: launches[n] for n in ("dct_decode", "fused_block",
                                      "gated_pool")}
    return {"launches": launches, "owned": owned, "ms_region": ms_k,
            "plain_ms_region": ms_p, "feats": feats}


# ------------------------------------------------------------------ phase 6
class MemoryBagStore:
    """Feature bags held in host memory (BagDataset's store)."""

    def __init__(self, bags):
        self.bags = bags

    def load_features(self, slide_id):
        return self.bags[slide_id]


TRAIN_BAGS = (100_000, 20_000, 60_000, 40_000)   # ResNet50-trunc slides
VAL_BAGS = (80_000, 30_000)


def phase_sharded(dev, *, n=100_000, d_in=1024, size_arg="small",
                  train_bags=TRAIN_BAGS, val_bags=VAL_BAGS) -> dict:
    """The instance-sharded full-bag path at world size 1 (NCCL on the card,
    gloo on the CPU): (a) sharded_clam_forward, plain and through the
    partial kernel, against apply_pooled and the plain pool; (b) four
    shards of one bag through the partial kernel, one all-masked, merged by
    combine_partials against the full-bag kernel; (c) two epochs of
    train_full_bags_sharded on seeded full slide bags. Counts zeroed
    before, gated_pool_partial non-zero after."""
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.parallel import full_bag_train as fbt
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import init_multihost
    from hipt_abmil_atec23_tpu_torch.parallel.sharded_bag import (
        sharded_clam_forward)
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig

    world = init_multihost(device=dev)
    log(f"sharded: process group of {world} ({dist.get_backend()})")
    try:
        mesh = make_mesh([("inst", world)], dev.type)
        clam = _reference_clam(size_arg, 5, dev)
        p = gap.params_from_clam(clam)
        g = torch.Generator().manual_seed(6)
        bag = torch.randn(n, d_in, generator=g).to(dev)
        mask = torch.arange(n, device=dev) < n - n // 40
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
            else (lambda: None)
        zero_counts()
        with torch.no_grad():
            out = gap.apply_pooled(clam, bag, mask)
            ref, _ = gap.gated_attention_pool_reference(bag, mask, p)
            for fused in (False, True):
                logits, a_raw = sharded_clam_forward(clam, bag, mask, mesh,
                                                     use_fused=fused)
                sync()
                err = max((logits - out.logits).abs().max().item(),
                          (logits[0] - ref).abs().max().item(),
                          (a_raw[0, mask] - out.a_raw[0, mask]).abs().max()
                          .item())
                log(f"sharded forward [{n},{d_in}] {size_arg} fused={fused}: "
                    f"max err against apply_pooled and the plain pool "
                    f"{err:.3g} (bound {POOL_TOL})")
                if not (err <= POOL_TOL and torch.isfinite(logits).all()):
                    raise SystemExit(f"sharded forward (fused={fused}) "
                                     "disagrees with apply_pooled")
            # (b) four shards on one card, the third all-masked
            cut = mask.clone()
            cut[n // 2:3 * n // 4] = False
            shards = [gap.gated_attention_pool_partial(
                bag[i:i + n // 4], p, mask=cut[i:i + n // 4])
                for i in range(0, n, n // 4)]
            acc, m, l, _ = (torch.stack([s[j] for s in shards])
                            for j in range(4))
            got = gap.combine_partials(acc[:, 0], m, l, p)
            want, _ = gap.gated_attention_pool(bag, p, mask=cut)
            sync()
            err = (got - want).abs().max().item()
            log(f"combine_partials over 4 shards (one all-masked, m "
                f"{m[2].item():.3g}, l {l[2].item():.3g}): max err against "
                f"the full-bag kernel {err:.3g} (bound {POOL_TOL})")
            if not (err <= POOL_TOL and l[2].item() == 0):
                raise SystemExit("combine_partials disagrees with the "
                                 "full-bag kernel")
        del bag, out, acc
        # (c) full-bag training, one optimizer step per slide
        rng = np.random.default_rng(7)
        sizes = train_bags + val_bags
        store = MemoryBagStore({f"s{i}": rng.standard_normal(
            (k, d_in), dtype=np.float32) for i, k in enumerate(sizes)})
        labels = np.arange(len(sizes)) % 2
        ids = list(store.bags)
        cfg = ExperimentConfig.from_dict({
            "task": {"n_classes": 2},
            "bags": {"max_patches_per_slide": None},
            "model": {"model_type": "clam_sb", "model_size": size_arg},
            "train": {"lr": 2e-4, "max_epochs": 2, "seed": 0}})
        mk = lambda sel: BagDataset([ids[i] for i in sel], labels[sel],
                                    store, cfg.bags)
        nt = len(train_bags)
        step_ms = []
        real_step = fbt.sharded_bag_train_step

        def timed_step(*a, **k):
            sync()
            t0 = time.perf_counter()
            loss = real_step(*a, **k)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return loss

        fbt.sharded_bag_train_step = timed_step
        try:
            t0 = time.perf_counter()
            _, hist = fbt.train_full_bags_sharded(
                cfg, mk(list(range(nt))), mk(list(range(nt, len(sizes)))),
                mesh, verbose=False)
            wall = time.perf_counter() - t0
        finally:
            fbt.sharded_bag_train_step = real_step
        launches = read_counts()
        for h in hist:
            log(f"full-bag train epoch {h['epoch']}: train_loss "
                f"{h['train_loss']:.6g} val_loss {h['val_loss']:.6g} "
                f"val_auc {h['val_auc']}")
        if not all(np.isfinite([h["train_loss"], h["val_loss"]]).all()
                   for h in hist):
            raise SystemExit("full-bag training gave a non-finite loss")
        warm = step_ms[nt:]
        log(f"full-bag train: {len(step_ms)} steps on bags of {train_bags} x "
            f"{d_in} ({size_arg}), ms per optimizer step "
            f"{[round(t, 3) for t in step_ms]} (second "
            f"epoch mean {sum(warm) / len(warm):.3f}); 2 epochs "
            f"{wall:.2f} s")
        log(f"sharded path launches: {launches}")
        if launches["gated_pool_partial"] == 0:
            raise SystemExit("the sharded path never launched "
                             "gated_pool_partial")
        return {"launches": launches,
                "owned": {"gated_pool_partial":
                          launches["gated_pool_partial"]}}
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ phase 7
def missing_file_deps(modules=("cv2", "h5py")):
    """What a phase on slide files lacks among ``modules`` and the native
    reader's build, or None; decided by imports alone, before the phase."""
    import importlib
    try:
        for m in modules:
            importlib.import_module(m)
        from hipt_abmil_atec23_tpu_torch.slideio import native
        native.get_lib()
    except (ImportError, OSError, subprocess.CalledProcessError) as e:
        return getattr(e, "name", None) or \
            "the native slide reader's build (libtiff/libjpeg headers)"
    return None


def phase_serve(dev, encoder, clam, *, slide=SLIDE, region=REGION) -> None:
    what = missing_file_deps()
    if what:
        log(f"serve phase: skipped, missing {what}")
        return
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeConfig, ServeState, serve_once)
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        write_synthetic_slide)
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


# ------------------------------------------------------------------ phase 8
def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profile_dct_decode(dev, dct_slide, region) -> None:
    """The DCT rung's device decode of one batch already on the card
    (CUDA events): the decode kernel, and pack -> encoder input through
    the decode and colour kernels, beside the plain chain's planes and
    input in the same run."""
    coords = grid_coords(dct_slide.level_dimensions[0][0], region)[:2]
    _, pack = _device_pack(dct_slide, coords, dev, region=region)
    with torch.inference_mode():
        stages = {
            "planes, decode kernels (DC pre-pass + decode)": gpu_timer(
                lambda: jpegdct.dct_regions_to_planes(*pack)),
            "pack -> encoder input, decode + colour kernels": gpu_timer(
                lambda: yuv.ycc_to_input(
                    *jpegdct.dct_regions_to_planes(*pack))),
            "planes, plain chain": gpu_timer(
                lambda: jpegdct.dct_regions_to_planes_reference(*pack),
                iters=3),
            "pack -> encoder input, plain chain": gpu_timer(
                lambda: yuv.ycc_to_input_reference(
                    *jpegdct.dct_regions_to_planes_reference(*pack)),
                iters=3)}
    for name, ms in stages.items():
        log(f"profile: DCT decode, {name}: {ms / len(coords):.3f} "
            f"ms/region")


def _profile_stream(jobs, encoder, region, n, path, label) -> None:
    """torch.profiler over one warm stream: the device's busy share and
    the kernel table by name, written to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = encode_slides(jobs, encoder, region)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise SystemExit("torch.profiler recorded no device activity")
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in dev_events) / 1e3
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    head = (f"{label}: profiled wall {wall * 1e3:.1f} ms ({n} regions), "
            f"device busy {busy:.1f} ms, busy share "
            f"{busy / (wall * 1e3):.3f}, device time summed over launches "
            f"{total:.1f} ms")
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


def phase_profile(dev, encoder, per_op_encoder, planes, dct_slide, path, *,
                  slide=SLIDE, region=REGION) -> None:
    """Where one slide's warm encode_stream time goes: the stream's wall,
    its stages timed apart (host plane read, H2D of the pinned planes,
    YCbCr -> RGB + normalize, the encoder on planes and on RGB already on
    the card, the DCT rung's decode stages), and the device's busy share
    and kernel table from torch.profiler over one more stream, the table
    written to ``path``; the same stream and encoder stages for the per-op
    configuration, its table written to ``path``.per_op."""
    s = PlaneSlide(*planes)
    coords = grid_coords(slide, region)
    jobs, n, bs = [("p0", s, coords)], len(coords), encoder.batch_size
    for _ in range(2):
        _, wall = encode_slides(jobs, encoder, region)
        log(f"profile: stream wall ms/region {wall * 1e3 / n:.2f}")
    t0 = time.perf_counter()
    for i in range(0, n, bs):
        batch = s.read_regions_yuv420(coords[i:i + bs], 0, (region, region))
    log(f"profile: host plane read ms/region "
        f"{(time.perf_counter() - t0) * 1e3 / n:.2f}")
    host = [torch.from_numpy(a).pin_memory() for a in batch]
    on_dev = [t.to(dev) for t in host]
    rgb = torch.from_numpy(s.read_regions(coords[:bs], 0, (region, region)))
    rgb = rgb.to(dev)
    k = len(on_dev[0])
    stages = {
        "H2D planes (pinned)": gpu_timer(
            lambda: [t.to(dev, non_blocking=True) for t in host]),
        "YCbCr->RGB + normalize, colour kernel": gpu_timer(
            lambda: yuv.ycc_to_input(*on_dev)),
        "YCbCr->RGB + normalize, plain": gpu_timer(
            lambda: yuv.ycc_to_input_reference(*on_dev)),
        "encoder, planes on the card": gpu_timer(
            lambda: encoder.apply_yuv(*on_dev), iters=3),
        "encoder, RGB on the card": gpu_timer(
            lambda: encoder.apply(rgb), iters=3),
        "per-op encoder, planes on the card": gpu_timer(
            lambda: per_op_encoder.apply_yuv(*on_dev), iters=3)}
    mb = sum(t.numel() for t in host) / k / 1e6
    for name, ms in stages.items():
        log(f"profile: {name} ms/region {ms / k:.2f}"
            + (f" ({mb:.1f} MB/region)" if name.startswith("H2D") else ""))
    _profile_dct_decode(dev, dct_slide, region)
    _profile_stream(jobs, encoder, region, n, path, "fused-block")
    for _ in range(2):
        _, wall = encode_slides(jobs, per_op_encoder, region)
        log(f"profile: per-op stream wall ms/region {wall * 1e3 / n:.2f}")
    _profile_stream(jobs, per_op_encoder, region, n, path + ".per_op",
                    "per-op")


# ------------------------------------------------------------------ phase 9
PACE_MBPS = 200.0
PACE_WINDOW = (0.8, 1.05)  # paced wire_mbps_final, in units of the pace
PACE_WALL = 0.7            # wall >= PACE_WALL x h2d bytes at the pace
STAGED_TOL = 1e-6          # staged against overlapped features, max |d|
VIT256_BATCH = 256         # patches per batch: B.1 at [256, 264, 384]
PATCH = 256                # the vit256 encoder's patch size


def paced_rate_check(stats, wall_s, pace) -> float:
    """The pace shim's window: the stream's final wire estimate within
    PACE_WINDOW x ``pace`` and its wall at least PACE_WALL x its H2D bytes
    at ``pace``; returns the final estimate."""
    final = stats.get("wire_mbps_final")
    floor_s = stats["h2d_bytes"] / 1e6 / pace
    lo, hi = (f * pace for f in PACE_WINDOW)
    log(f"paced stream at {pace:g} MB/s: wire_mbps_final "
        f"{final if final is None else round(final, 2)} (in [{lo:g}, "
        f"{hi:g}]), wall {wall_s:.3f} s against {floor_s:.3f} s of bytes "
        f"at the pace (>= {PACE_WALL} x)")
    if final is None or not lo <= final <= hi:
        raise SystemExit(f"paced wire estimate {final} outside [{lo}, {hi}]")
    if wall_s < PACE_WALL * floor_s:
        raise SystemExit(f"paced stream took {wall_s:.3f} s, under "
                         f"{PACE_WALL} x {floor_s:.3f} s: not throttled")
    return final


def staged_check(what, staged, overlapped, tol=STAGED_TOL) -> float:
    """Staged-stream features ({slide: [N, D]}, in yield order) against the
    overlapped stream's: the same slides in the same order, shapes equal,
    finite, max |d| <= tol; returns max |d|."""
    if list(staged) != list(overlapped):
        raise SystemExit(f"{what}: staged stream yielded {list(staged)}, "
                         f"the overlapped {list(overlapped)}")
    worst = 0.0
    for sid, f in staged.items():
        o = overlapped[sid]
        if f.shape != o.shape or not np.isfinite(f).all():
            raise SystemExit(f"{what} {sid}: staged features {f.shape}, "
                             f"overlapped {o.shape}")
        worst = max(worst, float(np.abs(f - o).max(initial=0.0)))
    log(f"{what}: staged against overlapped features, max |d| {worst:.3g} "
        f"(<= {tol:g})")
    if worst > tol:
        raise SystemExit(f"{what}: staged features disagree ({worst})")
    return worst


def _variant_check(what, got, want):
    cos, rel = feature_agreement({"b": got}, {"b": want})
    log(f"{what} kernel vs plain: min cosine {cos:.6f} (>= 0.999), max rel "
        f"L2 {rel:.3g} (<= 2e-2)")
    if not (np.isfinite(got).all() and cos >= 0.999 and rel <= 2e-2):
        raise SystemExit(f"{what} features disagree with the plain pass")


def _vit256_encoders(dev, vit256_cfg):
    """The vit256 encoder (seeded bf16 weights, every block B.1) and its
    plain twin on the same weights."""
    from hipt_abmil_atec23_tpu_torch.models.vit import vit_small
    cfg = vit256_cfg or VIT_CONFIGS["vit_small"]
    ecfg = EncoderConfig(model_type="vit256", batch_size=VIT256_BATCH,
                         dtype="bfloat16")
    model = vit_small(torch.bfloat16, use_fused_block=True, cfg=cfg,
                      generator=torch.Generator().manual_seed(2))
    plain = vit_small(torch.bfloat16, use_fused_block=True, cfg=cfg)
    plain.load_state_dict(model.state_dict())
    for m in plain.modules():
        if isinstance(m, Block):
            m.plain = True
    enc = build_encoder(ecfg, device=dev, model=model)
    plain_enc = build_encoder(ecfg, device=dev, model=plain)
    plain_enc.plain_unpack = True
    return enc, plain_enc


def phase_encode_stage(dev, res, dres, dct_slides, planes, *,
                       region=REGION) -> dict:
    """The encode stage's device half on phase 3-4's in-memory slides:
    staged against overlapped streams on the plane and DCT rungs, the pace
    shim, the vit256 encoder on 256 px patches, HIPT's mean256 / concat
    variants, and the RGB rung under a host transform (and a resize where
    cv2 imports). ``res`` / ``dres``: phase 3's and phase 4's results;
    ``planes``: one plane slide's (rgb, y, cb, cr)."""
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.ops.augment import build_transform
    enc, plain_enc = res["encoder"], res["plain_encoder"]
    cuda = dev.type == "cuda"
    out = {}

    # B.1 at the vit256 encoder's shape, before the counts are zeroed
    g = torch.Generator().manual_seed(9)
    d = 384
    blk = _random_block(d, 6, g, dev)
    x = torch.randn(VIT256_BATCH, 264, d, generator=g).to(dev, torch.bfloat16)
    with torch.inference_mode():
        _check("fused_block", f"[{VIT256_BATCH},264,{d}] bf16 (vit256), "
               "n_valid 257", fused_vit_block(x, blk, num_heads=6,
                                              n_valid=257),
               fused_vit_block_reference(x, blk, num_heads=6, n_valid=257),
               BLOCK_TOL)
        if cuda:
            out["block_ms_vit256"] = gpu_timer(lambda: fused_vit_block(
                x, blk, num_heads=6, n_valid=257))
            log(f"fused_block [{VIT256_BATCH},264,{d}]: kernel "
                f"{out['block_ms_vit256']:.4f} ms")
    del blk, x

    zero_counts()
    # (a) staged against overlapped, plane rung and DCT rung (phase 4's
    # stream is the DCT rung's overlapped one)
    jobs = res["jobs"]
    n = sum(len(c) for _, _, c in jobs)
    plane_feats, wall = encode_slides(jobs, enc, region, adaptive_rungs=False)
    ms = {"plane overlapped": wall * 1e3 / n,
          "DCT overlapped (phase 4)": dres["ms_region"]}
    djobs = [(f"dct{i}", s, c) for i, (s, (_, _, c)) in
             enumerate(zip(dct_slides, jobs))]
    for rung, rjobs, overlapped in (("plane", jobs, plane_feats),
                                    ("DCT", djobs, dres["feats"])):
        for budget in (None, 1):  # the default, then a flush per batch
            stats = {}
            kw = {} if budget is None else {"stage_budget_bytes": budget}
            feats, wall = encode_slides(rjobs, enc, region, stage=True,
                                        adaptive_rungs=False, stats=stats,
                                        **kw)
            label = f"{rung} staged" + ("" if budget is None else
                                        ", 1-byte budget")
            staged_check(f"{label}, {stats['stage_flushes']} flushes", feats,
                         overlapped)
            if budget is not None and stats["stage_flushes"] < 3:
                raise SystemExit(f"{label}: fewer than three flushes")
            ms[label] = wall * 1e3 / n
    log(f"encode stage, ms per {region}^2 region (decode + H2D + encode, "
        f"batch {enc.batch_size}, {n} regions): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    out["ms_region"] = ms

    # (b) the pace shim on the DCT slides, every rung open
    unpaced = {}
    encode_slides(djobs, enc, region, stats=unpaced)
    paced = {}
    _, wall = encode_slides(djobs, enc, region, stats=paced,
                            wire_mbps_hint=PACE_MBPS, pace_put_mbps=PACE_MBPS)
    first = lambda s: [round(v, 1) for v in s.get("wire_mbps_samples",
                                                  [])[:3]]
    log(f"rung decisions: paced {paced.get('rung_decisions')} (regions "
        f"dct/yuv/rgb {paced.get('regions_dct', 0)}/"
        f"{paced.get('regions_yuv', 0)}/{paced.get('regions_rgb', 0)}), "
        f"unpaced {unpaced.get('rung_decisions')} (regions dct/yuv/rgb "
        f"{unpaced.get('regions_dct', 0)}/{unpaced.get('regions_yuv', 0)}/"
        f"{unpaced.get('regions_rgb', 0)})")
    log(f"first three wire samples, MB/s: paced {first(paced)}, unpaced "
        f"{first(unpaced)}")
    out["paced_mbps"] = paced_rate_check(paced, wall, PACE_MBPS)

    # (c) HIPT mean256 and concat on one batch of two regions (plane entry)
    rgb, y, cb, cr = planes
    yb = torch.from_numpy(np.stack([y[:region, :region],
                                    y[region:2 * region, region:2 * region]]))
    h = region // 2
    cbb, crb = (torch.from_numpy(np.stack([c[:h, :h], c[h:2 * h, h:2 * h]]))
                for c in (cb, cr))
    batch = [t.to(dev) for t in (yb, cbb, crb)]
    got, want = {}, {}
    for variant in ("cls4k", "mean256", "concat"):
        vcfg = EncoderConfig(batch_size=2, hipt_features=variant)
        got[variant] = build_encoder(vcfg, device=dev, model=enc.model
                                     ).apply_yuv(*batch).float().cpu().numpy()
        pe = build_encoder(vcfg, device=dev, model=plain_enc.model)
        pe.plain_unpack = True
        want[variant] = pe.apply_yuv(*batch).float().cpu().numpy()
    d256 = got["mean256"].shape[1]
    for variant in ("mean256", "concat"):
        _variant_check(f"HIPT {variant} [{region}^2 x 2]", got[variant],
                       want[variant])
    if not (np.array_equal(got["concat"][:, d256:], got["cls4k"])
            and np.array_equal(got["concat"][:, :d256], got["mean256"])):
        raise SystemExit("concat is not [mean256 | cls4k] of the same batch")
    log(f"HIPT concat [{got['concat'].shape[1]}] = [mean256 | cls4k] of the "
        f"same batch, bit for bit")

    # (d) the vit256 encoder on one slide's 256 px patches
    venc, vplain = _vit256_encoders(dev, res["widths"].get("vit256_cfg"))
    slide = PlaneSlide(*planes)
    side = rgb.shape[0]
    pcoords = grid_coords(side, PATCH)
    before = read_counts()["fused_block"]
    vfeats, vwall = encode_slides([("v", slide, pcoords)], venc, PATCH)
    out["launches_vit256"] = read_counts()["fused_block"] - before
    vplain_feats, _ = encode_slides([("v", slide, pcoords)], vplain, PATCH)
    _variant_check(f"vit256 [{len(pcoords)} x {PATCH}^2]", vfeats["v"],
                   vplain_feats["v"])
    out["patches_per_s"] = len(pcoords) / vwall
    log(f"vit256: {len(pcoords)} patches of {PATCH}^2 at batch "
        f"{VIT256_BATCH} in {vwall:.3f} s, {out['patches_per_s']:.1f} "
        f"patches/s (decode + H2D + encode); B.1 launches "
        f"{out['launches_vit256']}")

    # (e) the RGB rung under a host transform (and a resize with cv2)
    tcoords = pcoords[:VIT256_BATCH // 2]
    cases = [("macenko", 0)]
    try:
        import cv2  # noqa: F401
        cases.append(("macenko", 224))
    except ImportError:
        log("encode stage: target_patch_size skipped, missing cv2")
    for preset, tps in cases:
        stats = {}
        tf = build_transform(preset)
        feats, _ = encode_slides([("t", slide, tcoords)], venc, PATCH,
                                 transform=tf, target_patch_size=tps,
                                 stats=stats)
        pix = slide.read_regions(tcoords, 0, (PATCH, PATCH))
        if tps:
            pix = np.stack([cv2.resize(p, (tps, tps),
                                       interpolation=cv2.INTER_AREA)
                            for p in pix])
        ref = build_transform(preset)(pix)
        pad = np.zeros((VIT256_BATCH - len(ref),) + ref.shape[1:], np.uint8)
        want_t = venc.apply(torch.from_numpy(np.concatenate([ref, pad]))
                            .to(dev)).float().cpu().numpy()[:len(ref)]
        diff = float(np.abs(feats["t"] - want_t).max())
        log(f"RGB rung, transform {preset}"
            + (f", target_patch_size {tps}" if tps else "")
            + f": regions_rgb {stats.get('regions_rgb', 0)} of "
            f"{len(tcoords)}, max |d| against encoder.apply(transform("
            f"batch)) {diff:.3g} (<= {STAGED_TOL:g})")
        if stats.get("regions_rgb", 0) != len(tcoords) or diff > STAGED_TOL:
            raise SystemExit(f"transform {preset} ({tps}): the stream "
                             "disagrees with encoder.apply(transform(batch))")

    if cuda:
        torch.cuda.synchronize(dev)
    launches = read_counts()
    log(f"encode stage launches: {launches}")
    for name in ("fused_block", "dct_decode", "ycc_input"):
        if launches[name] == 0:
            raise SystemExit(f"the encode stage never launched {name}")
    out.update(launches=launches, owned={})
    return out


def phase_files(dev, encoder, *, slide=SLIDE, region=REGION,
                cli_encode=("--batch_size", "2")) -> None:
    """The encode stage's file-bound half on two synthetic JPEG YCbCr TIFFs:
    seg_and_patch -> encode_many -> the stored bags against encode_slide,
    then the CLI's tile and encode on the same slides (its HIPT_4K is the
    same seeded weights as ``encoder``'s)."""
    from hipt_abmil_atec23_tpu_torch import cli
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.engine.encode import (
        encode_many, encode_slide)
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    from hipt_abmil_atec23_tpu_torch.slideio.pipeline import seg_and_patch
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu_torch.slideio.synthetic import (
        write_synthetic_slide)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        src = os.path.join(d, "slides")
        os.makedirs(src)
        for i in range(2):
            write_synthetic_slide(os.path.join(src, f"s{i}.tif"), slide,
                                  slide, n_levels=3, ycbcr420=True, seed=i)
        tiles = os.path.join(d, "tiles")
        tcfg = TileConfig(patch_size=region, step_size=region,
                          seg=SegConfig(use_otsu=True, a_t=1))
        t0 = time.perf_counter()
        res = seg_and_patch(src, tiles, tcfg, verbose=False)
        t_tile = time.perf_counter() - t0
        sids = sorted(f[:-3] for f in os.listdir(os.path.join(
            tiles, "patches")))
        if list(res.df["status"]) != ["processed", "processed"] or not sids:
            raise SystemExit(f"tile stage: {res.df.to_dict('records')}")
        jobs = [(os.path.join(src, f"{sid}.tif"),
                 os.path.join(tiles, "patches", f"{sid}.h5"), sid)
                for sid in sids]
        store = FeatureBagStore(os.path.join(d, "feats"))
        t0 = time.perf_counter()
        done, failed = encode_many(jobs, encoder, store, verbose=False)
        t_enc = time.perf_counter() - t0
        if done != sids or failed:
            raise SystemExit(f"encode_many: done {done}, failed {failed}")
        bags, solo = {}, {}
        for path, h5, sid in jobs:
            coords, _ = load_coords_h5(h5)
            s = open_slide(path)
            try:
                solo[sid] = encode_slide(s, coords, encoder,
                                         region_size=region)
            finally:
                s.close()
            bags[sid] = store.load_features(sid)
        cos, rel = feature_agreement(bags, solo)
        log(f"file stage: tile {t_tile:.2f} s, encode_many {t_enc:.2f} s "
            f"for {len(sids)} slides; stored bags vs encode_slide min cosine "
            f"{cos:.6f}, max rel L2 {rel:.3g}")
        if cos < 0.999 or rel > 2e-2:
            raise SystemExit("stored bags disagree with encode_slide")
        ctiles, cfeats = os.path.join(d, "cli_tiles"), os.path.join(
            d, "cli_feats")
        cli.main(["tile", "--source", src, "--save_dir", ctiles,
                  "--patch_size", str(region), "--step_size", str(region),
                  "--use_otsu", "--a_t", "1", "--device", dev.type])
        cli.main(["encode", "--data_h5_dir", ctiles, "--data_slide_dir",
                  src, "--feat_dir", cfeats, "--device", dev.type,
                  *cli_encode])
        cli_bags = {sid: FeatureBagStore(cfeats).load_features(sid)
                    for sid in bags}
        cos, rel = feature_agreement(cli_bags, bags)
        log(f"file stage: CLI tile + encode bags vs encode_many's min "
            f"cosine {cos:.6f}, max rel L2 {rel:.3g}")
        if cos < 0.999 or rel > 2e-2:
            raise SystemExit("the CLI's bags disagree with encode_many's")


# ------------------------------------------------------------------ phase 10
WINNING_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "train_winning_hipt_abmil.json")
LOCKSTEP_TOL = 1e-5      # card against CPU per-epoch losses: the CPU lockstep
                         # test's tolerance (tests/test_torch_train.py)
RELOAD_TOL = 1e-6        # evaluate_fold from the .pt against train_fold
BOOT_TOL = 1e-6          # bootstrap chunk against numpy


def planted_bags(n_slides, bag_range, d, seed, signal=1.0, fraction=0.3):
    """Seeded N(0, 1) bags whose class-1 slides carry +signal along one
    direction on a share of their instances (data/synthetic.py's plan,
    without its pandas manifest). Returns ({slide_id: bag}, labels)."""
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=d).astype(np.float32)
    direction /= np.linalg.norm(direction)
    bags, labels = {}, np.arange(n_slides) % 2
    for i in range(n_slides):
        n = int(rng.integers(*bag_range))
        bag = rng.standard_normal((n, d), dtype=np.float32)
        if labels[i]:
            bag[rng.choice(n, max(1, int(fraction * n)), replace=False)] += \
                signal * direction
        bags[f"slide_{i:03d}"] = bag
    return bags, labels


def bootstrap_reference(labels, probs, idx):
    """(auc, f1, acc, balanced_acc) of each resample row of ``idx`` in
    numpy, one row at a time: AUC by midranks (engine/metrics.binary_auc,
    NaN without both classes), F1 of class 1, accuracy, and the mean
    recall over the classes present."""
    from hipt_abmil_atec23_tpu_torch.engine.metrics import binary_auc
    preds = probs.argmax(1)
    out = np.zeros((4, len(idx)))
    for r, row in enumerate(idx):
        lab, prd = labels[row], preds[row]
        tp = np.sum((prd == 1) & (lab == 1))
        denom = 2 * tp + np.sum((prd == 1) & (lab == 0)) + \
            np.sum((prd == 0) & (lab == 1))
        out[:, r] = (binary_auc(lab, probs[row, 1]),
                     2 * tp / max(denom, 1), np.mean(lab == prd),
                     np.mean([np.mean(prd[lab == c] == c)
                              for c in np.unique(lab)]))
    return out


class _StepTimer:
    """Times every train_epoch of the StepFns that train_fold builds
    (synchronised): (steps, seconds) per epoch."""

    def __init__(self, dev):
        from hipt_abmil_atec23_tpu_torch.engine import train as tr
        self.tr, self.dev, self.epochs = tr, dev, []

    def __enter__(self):
        real = self.real = self.tr.build_step_fns

        def build(*a, **k):
            fns = real(*a, **k)
            inner = fns.train_epoch

            def timed(model, opt, feats, *rest):
                _sync(self.dev)
                t0 = time.perf_counter()
                out = inner(model, opt, feats, *rest)
                _sync(self.dev)
                self.epochs.append((len(feats), time.perf_counter() - t0))
                return out
            fns.train_epoch = timed
            return fns
        self.tr.build_step_fns = build
        return self

    def __exit__(self, *exc):
        self.tr.build_step_fns = self.real

    def ms_per_step(self, skip=1):
        """Mean over the epochs after the first ``skip`` (warm)."""
        warm = self.epochs[skip:] or self.epochs
        return 1e3 * sum(t for _, t in warm) / sum(n for n, _ in warm)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fold_sets(bags, labels, store, cfg, splits, fold):
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    ids = list(bags)
    return [BagDataset([ids[i] for i in part], labels[part], store, cfg.bags)
            for part in splits[fold]]


def phase_train_eval(dev, smi, *, n_slides=60, bag_range=(40, 600),
                     inst_bags=(24, (3000, 8000)), full_bags=(8, (20_000,
                     100_000)), inst_size="small", n_boot=100_000) -> dict:
    """The train and eval stages: (a) the winning configuration, (b) card
    against CPU in lockstep, (c) the instance-clustering path, (d)
    full-bag evaluation through the pool kernel, (e) the bootstrap on the
    card. Counts zeroed before (a), read after (e)."""
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.data.bags import (BagDataset,
                                                       FeatureBagStore)
    from hipt_abmil_atec23_tpu_torch.data.splits import (
        generate_kfold_splits)
    from hipt_abmil_atec23_tpu_torch.engine import evaluate as ev
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    from hipt_abmil_atec23_tpu_torch.engine import train as tr
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        ckpt_path, save_params)
    from hipt_abmil_atec23_tpu_torch.engine.experiment import _write_fold_csv
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig

    out = {"card": smi}
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the winning configuration at full width
        bags, labels = planted_bags(n_slides, bag_range, 192, seed=21)
        store = FeatureBagStore(os.path.join(tmp, "feats"))
        for sid, bag in bags.items():
            store.save(sid, bag, formats=("pt",))
        with open(WINNING_CONFIG) as f:   # its "_comment" is no field
            cfg = ExperimentConfig.from_dict(
                {k: v for k, v in json.load(f).items() if k[0] != "_"})
        cfg.results_dir = os.path.join(tmp, "winning")
        cfg.train = dataclasses.replace(cfg.train, max_epochs=4,
                                        min_epochs=1, patience=1,
                                        stop_epoch=1)
        splits = generate_kfold_splits(labels, cfg.train.k,
                                       seed=cfg.train.seed)
        counts = np.bincount(labels, minlength=2)
        folds = []
        for fold in (0, 1):
            sets = _fold_sets(bags, labels, store, cfg, splits, fold)
            draws = []
            real_split = tr.evaluate_split

            def recording(fns, model, ds, n_pad, rng, *a, **k):
                draws.append(rng.bit_generator.state)
                return real_split(fns, model, ds, n_pad, rng, *a, **k)
            ticks = []
            tr.evaluate_split = recording
            try:
                with _StepTimer(dev) as st:
                    t0 = time.perf_counter()
                    res = tr.train_fold(
                        cfg, fold, *sets, counts, verbose=False, device=dev,
                        log_cb=lambda e, r: ticks.append(time.perf_counter()))
            finally:
                tr.evaluate_split = real_split
            epoch_s = np.diff([t0] + ticks).tolist()
            # evaluate_fold from the .pt, on the host stream train_fold's
            # test pass drew its bags from (its last evaluate_split)
            test_rng = np.random.default_rng()
            test_rng.bit_generator.state = draws[-1]
            real_rng = ev.host_rng
            ev.host_rng = lambda *a: test_rng
            try:
                again = ev.evaluate_fold(cfg, fold, sets[2], counts,
                                         cfg.results_dir, device=dev)
            finally:
                ev.host_rng = real_rng
            err = float(np.abs(again.test_probs - res.test_probs).max())
            _write_fold_csv(cfg.results_dir, res)
            log(f"train_eval (a) winning config fold {fold}: stopped at "
                f"epoch {res.stopped_epoch}, history "
                f"{[{k: round(v, 6) for k, v in h.items()} for h in res.history]}"
                f", val AUC {res.val_auc:.4f} test AUC {res.test_auc:.4f}; "
                f"{st.ms_per_step():.3f} ms per optimizer step, epochs "
                f"{[round(1e3 * t, 1) for t in epoch_s]} ms; evaluate_fold "
                f"from the .pt against train_fold's test probabilities "
                f"max |d| {err:.3g} (bound {RELOAD_TOL})")
            if not (err <= RELOAD_TOL and np.isfinite(res.test_probs).all()):
                raise SystemExit("evaluate_fold from the checkpoint does not "
                                 "reproduce train_fold's test probabilities")
            folds.append(dict(fold=fold, stopped_epoch=res.stopped_epoch,
                              ms_per_step=st.ms_per_step(),
                              steps_per_epoch=st.epochs[0][0],
                              ms_per_epoch=[1e3 * t for t in epoch_s],
                              test_auc=res.test_auc, reload_err=err))
        out["winning"] = folds

        # (b) card against CPU in lockstep: dropout off, one initial state
        # dict, one host stream
        sets = _fold_sets(bags, labels, store, cfg, splits, 0)
        lock = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, drop_out=0.0),
            train=dataclasses.replace(cfg.train, max_epochs=2,
                                      early_stopping=False,
                                      continue_training=True))
        init = tr.build_step_fns(lock, counts, 8, 192, device="cpu"
                                 ).init_params(torch.Generator().manual_seed(5))
        hist = []
        for i, where in enumerate((dev, torch.device("cpu"))):
            lock.results_dir = os.path.join(tmp, f"lock_{i}")
            save_params(ckpt_path(lock.results_dir, 0), init)
            hist.append(tr.train_fold(lock, 0, *sets, counts, verbose=False,
                                      device=where).history)
        gap_ = max(abs(a[k] - b[k]) for a, b in zip(*hist)
                   for k in ("train_loss", "val_loss"))
        log(f"train_eval (b) {dev.type} against cpu, 2 epochs: per-epoch "
            f"train / val loss max |d| {gap_:.3g} (bound {LOCKSTEP_TOL}); "
            f"{dev.type} {[(h['train_loss'], h['val_loss']) for h in hist[0]]}")
        if not gap_ <= LOCKSTEP_TOL:
            raise SystemExit("card and CPU training disagree")
        out["lockstep_gap"] = gap_

        # (c) the instance-clustering path: CLAM_SB small, batch 4
        n_inst, inst_range = inst_bags
        ibags, ilabels = planted_bags(n_inst, inst_range, 1024, seed=22)
        istore = MemoryBagStore(ibags)
        icfg = ExperimentConfig.from_dict({
            "results_dir": os.path.join(tmp, "inst"),
            "task": {"n_classes": 2},
            "bags": {"max_patches_per_slide": 4096, "batch_size": 4},
            "model": {"model_type": "clam_sb", "model_size": inst_size,
                      "no_inst_cluster": False, "k_sample": 8},
            "train": {"lr": 2e-4, "reg": 1e-5, "bag_weight": 0.7,
                      "max_epochs": 2, "early_stopping": False, "seed": 3}})
        ids = list(ibags)
        parts = (np.arange(0, n_inst - 8), np.arange(n_inst - 8, n_inst - 4),
                 np.arange(n_inst - 4, n_inst))
        isets = [BagDataset([ids[i] for i in p], ilabels[p], istore,
                            icfg.bags) for p in parts]
        with _StepTimer(dev) as st:
            ires = tr.train_fold(icfg, 0, *isets,
                                 np.bincount(ilabels, minlength=2),
                                 verbose=False, device=dev)
        inst_losses = [h["train_inst_loss"] for h in ires.history]
        log(f"train_eval (c) instance clustering, CLAM_SB {inst_size}, "
            f"[4, 4096, 1024] per step: {st.ms_per_step():.3f} ms per "
            f"optimizer step ({st.epochs[0][0]} steps per epoch, epochs "
            f"{[round(1e3 * t, 1) for _, t in st.epochs]} ms), instance "
            f"loss {inst_losses}")
        if not (all(np.isfinite(inst_losses)) and min(inst_losses) > 0):
            raise SystemExit("the instance-clustering loss is not positive "
                             "and finite")
        out["inst_ms_per_step"] = st.ms_per_step()
        del ibags, istore, isets

        # (d) full-bag evaluation through the pool kernel (B.2)
        n_full, full_range = full_bags
        fbags, flabels = planted_bags(n_full, full_range, 1024, seed=23)
        fcfg = dataclasses.replace(
            icfg, bags=dataclasses.replace(icfg.bags,
                                           max_patches_per_slide=None),
            results_dir=os.path.join(tmp, "full"))
        fds = BagDataset(list(fbags), flabels, MemoryBagStore(fbags),
                         fcfg.bags)
        head = _reference_clam(inst_size, 24, torch.device("cpu"))
        save_params(ckpt_path(fcfg.results_dir, 0), head)
        fcounts = np.bincount(flabels, minlength=2)
        before = read_counts()["gated_pool"]
        _sync(dev)
        t0 = time.perf_counter()
        fres = ev.evaluate_fold(fcfg, 0, fds, fcounts, fcfg.results_dir,
                                device=dev)
        _sync(dev)
        full_s = time.perf_counter() - t0
        launched = read_counts()["gated_pool"] - before
        fns = tr.build_step_fns(fcfg, fcounts, 8, 1024, device=dev)
        model = fns.init_params()
        model.load_state_dict(head.state_dict())
        plain, _ = tr.evaluate_split(fns, model, fds, fds.pad_size(),
                                     np.random.default_rng(0))
        err = float(np.abs(plain - fres.test_probs).max())
        sizes = [len(b) for b in fbags.values()]
        log(f"train_eval (d) evaluate_fold on {n_full} full bags of "
            f"{min(sizes)}-{max(sizes)} x 1024 (CLAM_SB {inst_size}): "
            f"{launched} gated_pool launches, {1e3 * full_s / n_full:.2f} ms "
            f"per slide (host bag to card included); against the head's own "
            f"forward (evaluate_split) max |d| {err:.3g} (bound {POOL_TOL})")
        if launched != n_full or not err <= POOL_TOL:
            raise SystemExit("full-bag evaluation did not launch the pool "
                             "once per slide or disagrees with the head")
        out.update(full_ms_per_slide=1e3 * full_s / n_full,
                   full_launches=launched, full_err=err)
        del fbags, fds

        # (e) the bootstrap on the card over (a)'s fold CSVs
        blabels, bprobs = ev.read_fold_csvs([cfg.results_dir], [0, 1])
        _sync(dev)
        t0 = time.perf_counter()
        boot = M.bootstrap_metrics(blabels, bprobs, n_bootstraps=n_boot,
                                   seed=0, device=dev)
        _sync(dev)
        boot_s = time.perf_counter() - t0
        g = torch.Generator(device=dev).manual_seed(0)
        n = len(blabels)
        chunk = min(10_000, n_boot)
        idx = torch.randint(0, n, (chunk, n), generator=g, device=dev)
        tl = torch.as_tensor(blabels.astype(np.int64), device=dev)
        tp = torch.as_tensor(bprobs, device=dev)
        got = torch.stack(M.bootstrap_chunk(tl, tp, tp.argmax(1), idx, 2)
                          ).cpu().numpy()
        want = bootstrap_reference(blabels, bprobs, idx.cpu().numpy())
        same = np.stack([boot.auc[:chunk], boot.f1[:chunk], boot.acc[:chunk],
                         boot.balanced_acc[:chunk]])
        berr = float(np.nanmax(np.abs(got - want)))
        ok = np.array_equal(np.isnan(got), np.isnan(want)) and \
            np.allclose(got, same, rtol=0, atol=BOOT_TOL, equal_nan=True)
        summ = boot.summarize()
        log(f"train_eval (e) bootstrap_metrics, {n_boot} resamples of {n} "
            f"slides: {boot_s:.3f} s wall; first chunk of {chunk} against "
            f"numpy max |d| {berr:.3g} (bound {BOOT_TOL}); AUC "
            f"{summ['auc']['mean']:.4f} +/- {summ['auc']['std']:.4f}")
        if not (ok and berr <= BOOT_TOL):
            raise SystemExit("the bootstrap chunk disagrees with numpy")
        out.update(boot_s=boot_s, boot_err=berr, boot_n=n)
    launches = read_counts()
    log("train_eval " + json.dumps(out))
    return {"launches": launches, "owned": {}}


# ------------------------------------------------------------------ phase 11
EXPLAIN_TOL = 1e-4       # infer_attention against the head's own a_raw
MAP_COS = 0.99           # fused-block CLS maps against the f32 ones
MAP_MASS = 1e-2          # relative CLS-row mass on the patch tokens, same
EXPLAIN_BIG_BAG = (100_000, 1024)


def _ms_since(dev, t0) -> float:
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3


def explain_scores(what, clam, bag, relative: bool) -> dict:
    """infer_attention on one bag against the head's own forward on the
    same device: the pool's launches in the call, its ms after a warm-up
    call (bag to the card and scores back included), and max |d|
    (relative to max |a_raw| when ``relative``)."""
    from hipt_abmil_atec23_tpu_torch.explain.heatmaps import (
        infer_attention, model_device)
    dev = model_device(clam)
    infer_attention(clam, bag)  # warm-up: the head's pool weights prepared
    before = read_counts()["gated_pool"]
    _sync(dev)
    t0 = time.perf_counter()
    scores = infer_attention(clam, bag)
    ms = _ms_since(dev, t0)
    launched = read_counts()["gated_pool"] - before
    with torch.inference_mode():
        want = clam(torch.as_tensor(bag).to(dev)).a_raw[0].float().cpu()
    want = want.numpy()
    scale = float(np.abs(want).max()) if relative else 1.0
    err = float(np.abs(scores - want).max()) / scale
    log(f"explain (a) infer_attention, {what}: {launched} gated_pool "
        f"launches, {ms:.3f} ms; against the head's forward max |d|"
        f"{' / max |a_raw|' if relative else ''} {err:.3g} (bound "
        f"{EXPLAIN_TOL})")
    if (scores.shape != want.shape or not np.isfinite(scores).all()
            or launched != 1 or not err <= EXPLAIN_TOL):
        raise SystemExit(f"explain: infer_attention on {what} did not launch "
                         "the pool once or disagrees with the head")
    return {"ms": ms, "err": err, "scores": scores}


def map_agreement(got, want):
    """(least cosine, largest relative difference of the mass) over the
    rows of two sets of CLS maps, each map one row."""
    got = got.reshape(-1, np.prod(got.shape[-2:])).astype(np.float64)
    want = want.reshape(got.shape).astype(np.float64)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    mass = np.abs(got.sum(1) - want.sum(1)) / want.sum(1)
    return float(cos.min()), float(mass.max())


def _timed_maps(dev, model, variants):
    """region_attention_cls_maps twice (the first warms the path up);
    the second call's maps, ms and launches by kernel."""
    from hipt_abmil_atec23_tpu_torch.explain.hierarchical import (
        region_attention_cls_maps)
    region_attention_cls_maps(model, variants)
    before = read_counts()
    _sync(dev)
    t0 = time.perf_counter()
    maps = region_attention_cls_maps(model, variants)
    ms = _ms_since(dev, t0)
    return maps, ms, {k: v - before[k] for k, v in read_counts().items()}


def phase_explain(dev, smi, rgb, coords, feats, clam, *, region=REGION,
                  big_bag=EXPLAIN_BIG_BAG, widths=None) -> dict:
    """The explain stage on the card: (a) a slide's MIL heatmap scores
    through infer_attention (one pool launch) on phase 3's bag of one plane
    slide and on a seeded [100000, 1024] bag, then the raster; (b) one
    region's four shifted variants through region_attention_cls_maps in
    the JAX CLI's gallery configuration (f32, no kernel flags) and in bf16
    use_fused_block (17 fused_block launches), the maps held against each
    other, then the galleries. The raster halves need cv2 (else one line
    says so and they are skipped). ``rgb``: the plane slide's pixels;
    ``coords`` / ``feats``: its regions and phase 3's features."""
    from hipt_abmil_atec23_tpu_torch.explain import heatmaps as hm
    from hipt_abmil_atec23_tpu_torch.explain import hierarchical as hier
    widths = widths or {}
    out = {"card": smi}
    try:
        import cv2  # noqa: F401
        raster = True
    except ImportError:
        raster = False
        log("explain: raster halves skipped, missing cv2")

    # B.1 at the extraction's shape, before the counts are zeroed
    n_tiles = 4 * (region // 256) ** 2
    v256 = widths.get("vit256_cfg", VIT_CONFIGS["vit_small"])
    d, heads = v256.embed_dim, v256.num_heads
    g = torch.Generator().manual_seed(21)
    blk = _random_block(d, heads, g, dev)
    x = torch.randn(n_tiles, 264, d, generator=g).to(dev, torch.bfloat16)
    with torch.inference_mode():
        _check("fused_block", f"[{n_tiles},264,{d}] bf16 (region_attention), "
               "n_valid 257", fused_vit_block(x, blk, num_heads=heads,
                                              n_valid=257),
               fused_vit_block_reference(x, blk, num_heads=heads,
                                         n_valid=257), BLOCK_TOL)
        if dev.type == "cuda":
            out["block_ms"] = gpu_timer(lambda: fused_vit_block(
                x, blk, num_heads=heads, n_valid=257))
            log(f"fused_block [{n_tiles},264,{d}]: kernel "
                f"{out['block_ms']:.4f} ms")
    del blk, x

    zero_counts()
    # (a) the MIL heatmap: phase 3's bag, then a bag at ResNet width
    sa = explain_scores(f"phase 3 bag [{len(feats)}, {feats.shape[1]}]",
                        clam, feats, relative=False)
    n, d_in = big_bag
    big = torch.randn(n, d_in, generator=torch.Generator().manual_seed(22))
    sb = explain_scores(f"seeded bag [{n}, {d_in}], CLAM_SB small",
                        _reference_clam("small", 23, dev), big.to(dev),
                        relative=True)
    out.update(scores_ms=sa["ms"], scores_err=sa["err"],
               big_scores_ms=sb["ms"], big_scores_err=sb["err"])
    del big
    rois = hm.sample_rois(coords, sa["scores"], k=2)
    if set(rois["sampled_ids"]) != set(np.argsort(-sa["scores"])[:2]):
        raise SystemExit("explain: sample_rois top-k is not the top scores")
    if raster:
        from hipt_abmil_atec23_tpu_torch.slideio.reader import ImageSlide
        from hipt_abmil_atec23_tpu_torch.slideio.seg import segment_tissue
        t0 = time.perf_counter()
        slide = ImageSlide(rgb)
        seg = segment_tissue(slide, SegConfig(use_otsu=True, a_t=1))
        img = hm.draw_heatmap(slide, coords, sa["scores"], region, seg=seg)
        out["raster_ms"] = (time.perf_counter() - t0) * 1e3
        w, h = slide.level_dimensions[slide.get_best_level_for_downsample(32)]
        if img.shape != (h, w, 3) or img.dtype != np.uint8:
            raise SystemExit(f"explain: heatmap {img.shape} {img.dtype}")
        log(f"explain (a) raster: ImageSlide + segment_tissue + draw_heatmap "
            f"with the seg mask, {img.shape[1]}x{img.shape[0]}: "
            f"{out['raster_ms']:.1f} ms")

    # (b) hierarchical: one region, four shifted variants, two configurations
    reg = np.ascontiguousarray(rgb[:region, :region])
    variants = np.stack([hier.shift_pad(reg, k * 128) for k in range(4)])
    f32 = make_hipt_encoder(torch.float32,
                            generator=torch.Generator().manual_seed(0),
                            **widths)
    fused = make_hipt_encoder(torch.bfloat16, use_fused_block=True, **widths)
    fused.load_state_dict(f32.state_dict())
    f32, fused = f32.to(dev).eval(), fused.to(dev).eval()
    # B.1 calls of one fused region_attention: ViT-256's prefix, its last
    # block for the CLS, ViT-4K's prefix (11 + 1 + 5 = 17 at full depth)
    want_blocks = len(fused.vit256.blocks) + len(fused.vit4k.blocks) - 1
    (w256, w4k), f32_ms, f32_counts = _timed_maps(dev, f32, variants)
    (g256, g4k), fused_ms, fused_counts = _timed_maps(dev, fused, variants)
    if any(f32_counts.values()):
        raise SystemExit(f"explain: the f32 configuration launched "
                         f"{f32_counts}")
    blocks = fused_counts["fused_block"]
    cos256, mass256 = map_agreement(g256, w256)
    cos4k, mass4k = map_agreement(g4k, w4k)
    log(f"explain (b) region_attention_cls_maps, one {region}^2 region x 4 "
        f"shifts ({n_tiles} tiles): f32 {f32_ms:.1f} ms, "
        f"bf16 use_fused_block {fused_ms:.1f} ms ({blocks} fused_block "
        f"launches, want {want_blocks}); fused against f32 maps: "
        f"ViT-256 cosine >= {cos256:.6f}, mass |d| <= {mass256:.3g}; ViT-4K "
        f"cosine >= {cos4k:.6f}, mass |d| <= {mass4k:.3g} (bounds "
        f"{MAP_COS}, {MAP_MASS})")
    ok_maps = all(np.isfinite(m).all() for m in (w256, w4k, g256, g4k))
    if (blocks != want_blocks or not ok_maps
            or min(cos256, cos4k) < MAP_COS
            or max(mass256, mass4k) > MAP_MASS):
        raise SystemExit("explain: region_attention disagrees between the "
                         "configurations or missed a block launch")
    out.update(extract_f32_ms=f32_ms, extract_fused_ms=fused_ms,
               fused_block_launches=blocks, cos256=cos256, cos4k=cos4k,
               mass256=mass256, mass4k=mass4k)
    if raster:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            # the default heads (4k 0 and 5, 256 2) where the widths have them
            h4k = f32.vit4k.cfg.num_heads
            h256 = f32.vit256.cfg.num_heads
            files = hier.hierarchical_gallery(
                reg, f32, tmp, "r0", mode="concat_select",
                select_4k=(0, h4k - 1), select_256=(min(2, h256 - 1),))
            files += hier.patch_gallery(reg[:256, :256], f32.vit256, tmp,
                                        "p0", mode="concat")
            wall = _ms_since(dev, t0)
            if len(files) != 3 or not all(map(os.path.exists, files)):
                raise SystemExit(f"explain: galleries wrote {files}")
        out.update(gallery_ms=wall, gallery_raster_ms=wall - f32_ms)
        log(f"explain (b) hierarchical_gallery(concat_select) + "
            f"patch_gallery(concat) with the f32 model: {wall:.1f} ms, of "
            f"which raster ~{wall - f32_ms:.1f} ms (wall less one f32 "
            "extraction)")
    launches = read_counts()
    log("explain " + json.dumps(out))
    return {"launches": launches, "owned": {}}


# ----------------------------------------------------------------- phase 12
RESNET_BATCH = 256         # patches per batch: the encode stage's default
RESNET_PATCH = 256         # CLAM's patch encoders' input
CPU_PATCHES = 8            # patches held against the port on the CPU
CARD_CPU_F32_REL = 1e-3    # f32 card (TF32 off) against f32 CPU, rel L2:
                           # cuDNN's and oneDNN's conv algorithms sum in
                           # other orders over 13-16 residual blocks
# bf16 card against f32 CPU, (min cosine, max rel L2): the ResNets round
# their folded weights and activations; LeViT also keeps its residual
# stream in bf16 over 24-30 blocks, and LeViT-256's seeded weights grow
# its features to norms ~500: on 8 of these patches its bf16 features
# are 0.085 relative L2 from its f32 ones on the CPU alone, the card's
# as far. The card's arithmetic is held by the f32 check above.
BF16_CPU_TOL = {"resnet50": (0.999, 2e-2), "resnet18": (0.999, 2e-2),
                "levit_256": (0.99, 0.15), "levit_128s": (0.99, 0.15)}
ONLINE_PATCHES = 75        # patches drawn per slide (with replacement)
PROB_TOL = 1e-4            # serve's bucketed pool against the head


def patch_grid(plane, n_side, size):
    """The first n_side x n_side ``size`` px patches of a plane, row-major,
    as one contiguous [n_side^2, size, size] array."""
    return np.ascontiguousarray(
        plane[:n_side * size, :n_side * size]
        .reshape(n_side, size, n_side, size).transpose(0, 2, 1, 3)
        .reshape(n_side * n_side, size, size))


def encoder_gflop(model, size) -> float:
    """GFLOP of one ``size`` px patch through a copy of ``model`` on the
    CPU in f32 (torch.utils.flop_counter: the convolutions and matrix
    products)."""
    import copy
    from torch.utils.flop_counter import FlopCounterMode
    cpu = copy.deepcopy(model).float().cpu()
    if hasattr(cpu, "dtype"):
        cpu.dtype = torch.float32
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        cpu(torch.zeros(1, size, size, 3))
    return fc.get_total_flops() / 1e9


def _colour_imagenet(dev, planes) -> dict:
    """The colour kernel's ImageNet mode at the patch encoders' batch (256
    patches of 256^2, 4:2:0, cut from a plane slide), bf16 and f32,
    against its plain version on the card; timed in bf16."""
    _, y, cb, cr = planes
    n = int(RESNET_BATCH ** 0.5)
    py, pb, pr = (torch.from_numpy(patch_grid(p, n, RESNET_PATCH // s))
                  .to(dev) for p, s in ((y, 1), (cb, 2), (cr, 2)))
    worst = 0.0
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            got = yuv.ycc_to_input(py, pb, pr, dt, normalize="imagenet")
            want = yuv.ycc_to_input_reference(py, pb, pr, dt, "imagenet")
            worst = max(worst, colour_check(
                f"imagenet 4:2:0 {list(py.shape)} {dt}", got, want))
            if not torch.equal(got, want):
                raise SystemExit(f"ycc_input imagenet {dt}: not bit-equal "
                                 "to its plain version")
        call = lambda: yuv.ycc_to_input(py, pb, pr, normalize="imagenet")
        ms = device_ms(call, ("ycc_kernel",))
        call_ms = gpu_timer(call)
        pms = gpu_timer(lambda: yuv.ycc_to_input_reference(
            py, pb, pr, torch.bfloat16, "imagenet"), iters=3)
    px = py.numel()
    nbytes = px * 1.5 + px * 3 * 2
    b_ms, b_by = bound(nbytes, (COLOUR_FLOPS_PER_PX + 3) * px, F32_FLOP_S)
    log(f"ycc_input imagenet {list(py.shape)} 4:2:0 -> bf16: kernel "
        f"{ms:.4f} ms on the device, call {call_ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"shape": f"Y {list(py.shape)} + Cb, Cr {list(pb.shape)} uint8 "
            "-> bf16, ImageNet normalize", "ms": ms, "call_ms": call_ms,
            "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": worst}


def _decode_patches(dev, dct_slide) -> dict:
    """B.3 on one batch of 256 patches of 256^2, aligned and off the 16 px
    MCU lattice: coefficient tap bit-equal, planes within 1 LSB; timed on
    the aligned pack."""
    n = int(RESNET_BATCH ** 0.5)
    aligned = grid_coords(n * RESNET_PATCH, RESNET_PATCH)
    out, worst = {}, 0
    for what, coords in (("aligned", aligned), ("offset", aligned + [8, 24])):
        host, pack = _device_pack(dct_slide, coords, dev,
                                  region=RESNET_PATCH)
        planes, taps, want, want_taps = _decode_pair(pack)
        if planes[0].shape != (RESNET_BATCH, RESNET_PATCH, RESNET_PATCH):
            raise SystemExit(f"dct_decode {what} patches: Y "
                             f"{planes[0].shape}")
        worst = max(worst, decode_check(f"{what} [256 x 256^2]", planes,
                                        taps, want, want_taps))
        if what == "aligned":
            with torch.inference_mode():
                call = lambda: jpegdct.dct_regions_to_planes(*pack)
                ms = device_ms(call, ("dc_kernel", "decode_kernel"))
                call_ms = gpu_timer(call)
                pms = gpu_timer(lambda: jpegdct
                                .dct_regions_to_planes_reference(*pack),
                                iters=3)
            nbytes = (sum(t.numel() * t.element_size() for t in pack)
                      + sum(p.numel() for p in planes))
            b_ms, b_by = bound(nbytes, idct_flops(host), F32_FLOP_S)
            out = {"shape": "v3 pack -> Y [256,256,256] + Cb, Cr "
                   "[256,128,128] uint8 (one batch of 256 patches)",
                   "ms": ms, "call_ms": call_ms, "plain_ms": pms,
                   "bound_ms": b_ms, "bound_by": b_by}
            log(f"dct_decode [256 x 256^2]: kernels {ms:.4f} ms on the "
                f"device, call {call_ms:.4f} ms, plain {pms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), pack "
                f"{sum(a.nbytes for a in host[:27]) / 1e6:.2f} MB")
    out["max_abs_err"] = worst
    return out


def _pool_resnet_bag(dev, clam) -> dict:
    """B.2 at serve's bucket for one ResNet50-trunc slide: [1024, 1024],
    CLAM_SB small (L 512), against its plain version; timed."""
    p = gap.params_from_clam(clam)
    g = torch.Generator().manual_seed(12)
    bag = torch.randn(1024, 1024, generator=g).to(dev)
    mask = torch.ones(1024, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
        ref_logits, ref_scores = gap.gated_attention_pool_reference(
            bag, mask, p)
        err = max((logits - ref_logits).abs().max().item(),
                  (scores - ref_scores).abs().max().item())
        return _pool_row(
            "gated_pool", p, bag, err,
            lambda: gap.gated_attention_pool(bag, p, mask=mask),
            lambda: gap.gated_attention_pool_reference(bag, mask, p),
            "[1024,1024] f32, L 512 (serve's bucket, one ResNet slide)")


def _rung_run(what, jobs, enc, plain_enc, expect, dev, stats_want=None):
    """One rung of the ResNet main path: counts zeroed, encode_stream over
    the jobs, counts read; then the plain pass and the features held
    against it. ``expect``: kernel -> True (must launch) / False (must
    not). Returns (features, launches, patches per second)."""
    zero_counts()
    stats = {}
    feats, wall = encode_slides(jobs, enc, RESNET_PATCH,
                                adaptive_rungs=False, stats=stats)
    _sync(dev)
    launches = read_counts()
    n = sum(len(c) for _, _, c in jobs)
    pps = n / wall
    log(f"resnet50 {what} rung: {n} patches of {RESNET_PATCH}^2 at batch "
        f"{enc.batch_size} in {wall:.3f} s, {pps:.1f} patches/s (host read "
        f"+ H2D + decode + encode); launches {launches}; regions "
        f"dct/yuv/rgb {stats.get('regions_dct', 0)}/"
        f"{stats.get('regions_yuv', 0)}/{stats.get('regions_rgb', 0)}")
    if stats_want and stats.get(f"regions_{stats_want}", 0) != n:
        raise SystemExit(f"resnet50 {what}: not every patch rode the "
                         f"{stats_want} rung")
    for name, must in expect.items():
        if bool(launches[name]) != must:
            raise SystemExit(f"resnet50 {what} rung: {name} launched "
                             f"{launches[name]} times")
    if plain_enc is not None:
        plain, _ = encode_slides(jobs, plain_enc, RESNET_PATCH,
                                 adaptive_rungs=False)
        cos, rel = feature_agreement(feats, plain)
        log(f"resnet50 {what} rung, kernels vs plain: min cosine {cos:.6f} "
            f"(>= 0.999), max rel L2 {rel:.3g} (<= 2e-2)")
        if not (cos >= 0.999 and rel <= 2e-2):
            raise SystemExit(f"resnet50 {what}: kernel features disagree "
                             "with the plain pass")
    for sid, f in feats.items():
        if f.shape != (len(jobs[0][2]), enc.feat_dim) or \
                not np.isfinite(f).all():
            raise SystemExit(f"resnet50 {what} {sid}: bad features "
                             f"{f.shape}")
    return feats, launches, pps


def against_cpu(name, enc, pixels):
    """The card's bf16 encoder ``name``, and an f32 copy of its weights on
    the card (TF32 off), against the f32 copy on the CPU on ``pixels``:
    cosine and relative L2 per patch; returns (f32 rel L2, bf16 rel L2)."""
    sd = enc.model.state_dict()

    def f32_model():
        m = (resnet50_trunc() if name == "resnet50" else resnet18()
             if name == "resnet18" else levit_texture_encoder(name))
        m.load_state_dict(sd)
        return m
    cfg = EncoderConfig(model_type=name, batch_size=len(pixels),
                        dtype="float32")
    x = torch.from_numpy(pixels)
    want = build_encoder(cfg, device="cpu", model=f32_model()).apply(x)
    rels = []
    for what, e, (min_cos, max_rel) in (
            ("f32", build_encoder(cfg, device=enc.device, model=f32_model()),
             (0.9999, CARD_CPU_F32_REL)),
            ("bf16", enc, BF16_CPU_TOL[name])):
        got = e.apply(x.to(e.device)).float().cpu()
        cos, rel = feature_agreement({"p": got.numpy()}, {"p": want.numpy()})
        log(f"{name} {what} on the card against the port on the CPU in "
            f"f32, {len(pixels)} patches: min cosine {cos:.6f} (>= "
            f"{min_cos}), max rel L2 {rel:.3g} (<= {max_rel:g})")
        if not (torch.isfinite(got).all() and cos >= min_cos
                and rel <= max_rel):
            raise SystemExit(f"{name} {what}: the card disagrees with the "
                             "CPU port")
        rels.append(rel)
    torch.cuda.empty_cache()
    return rels


class MemoryOnlineDataset(OnlineEncodingBagDataset):
    """The port's OnlineEncodingBagDataset over in-memory slides and
    coords (the card machine has no h5py for coords h5s): its two file
    reads overridden."""

    def __init__(self, ids, labels, encoder, slides, coords, cfg):
        super().__init__(ids, labels, encoder, {}, "", cfg)
        self.mem_slides, self.mem_coords = slides, coords

    def _load_coords(self, sid):
        return self.mem_coords[sid], {"patch_size": RESNET_PATCH,
                                      "patch_level": 0}

    def _open_slide(self, sid):
        return self.mem_slides[sid]


def _counting(enc):
    """A copy of ``enc`` whose three entries count their calls."""
    import dataclasses
    enc = dataclasses.replace(enc)
    calls = []
    for name in ("apply", "apply_yuv", "apply_dct"):
        def wrapped(*a, _fn=getattr(enc, name)):
            calls.append(len(a[0]))
            return _fn(*a)
        setattr(enc, name, wrapped)
    return enc, calls


def phase_resnet(dev, smi, planes, dct_slide, records) -> dict:
    """ResNet50-trunc (full width, bf16, seeded weights, batch 256) on the
    plane, DCT and RGB rungs through build_encoder -> encode_stream ->
    CLAM_SB small through serve's _mil_bucketed; ResNet-18 and both LeViTs
    on the RGB rung; online training over OnlineEncodingBagDatasets. The
    colour kernel's ImageNet mode, B.3 at the patch batch and B.2 at the
    [1024, 1024] bucket against their plain versions first (their records
    in ``records`` gain those rows)."""
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.data.online import OnlineFeatureGather
    from hipt_abmil_atec23_tpu_torch.engine.train import train_fold
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    out = {"card": smi}

    # 1. kernels at this slice's shapes, before the counts are zeroed
    colour = _colour_imagenet(dev, planes[0])
    decode = _decode_patches(dev, dct_slide)
    clam = _reference_clam("small", 5, dev)
    pool = _pool_resnet_bag(dev, clam)
    torch.cuda.empty_cache()

    # 2. ResNet50-trunc on three rungs, CLAM_SB small on each bag
    cfg = EncoderConfig(model_type="resnet50", batch_size=RESNET_BATCH,
                        dtype="bfloat16")
    enc = build_encoder(cfg, device=dev)
    plain_enc = dataclasses.replace(enc, plain_unpack=True)
    gflop = encoder_gflop(enc.model, RESNET_PATCH)
    out["gflop_per_patch"] = gflop
    log(f"resnet50: {gflop:.3f} GFLOP per {RESNET_PATCH}^2 patch "
        f"(flop counter), {enc.feat_dim}-d, batch {enc.batch_size}, bf16")
    pcoords = grid_coords(planes[0][1].shape[0], RESNET_PATCH)
    slides = {f"mem{i}": PlaneSlide(*p) for i, p in enumerate(planes)}
    jobs = [(sid, s, pcoords) for sid, s in slides.items()]
    encode_slides([(jobs[0][0], jobs[0][1], pcoords[:RESNET_BATCH])], enc,
                  RESNET_PATCH)  # warm-up: cuDNN, the allocator
    plane_feats, plane_l, out["pps_plane"] = _rung_run(
        "plane", jobs, enc, plain_enc,
        {"ycc_input": True, "dct_decode": False, "fused_block": False},
        dev, "yuv")
    dcoords = grid_coords(dct_slide.level_dimensions[0][0], RESNET_PATCH)
    dct_feats, dct_l, out["pps_dct"] = _rung_run(
        "DCT", [("dct0", dct_slide, dcoords)], enc, plain_enc,
        {"ycc_input": True, "dct_decode": True, "fused_block": False},
        dev, "dct")
    rgb_enc = dataclasses.replace(enc, plane_rung=False, dct_rung=False)
    _, rgb_l, out["pps_rgb"] = _rung_run(
        "RGB", jobs[:1], rgb_enc, None,
        {"ycc_input": False, "dct_decode": False, "fused_block": False},
        dev, "rgb")

    zero_counts()
    worst = 0.0
    for sid, f in {**plane_feats, **dct_feats}.items():
        o, ref_logits = score(clam, f, dev)
        with torch.inference_mode():
            want = clam(torch.from_numpy(f).to(dev)).y_prob[0].float().cpu()
        got = o.y_prob[0].float().cpu()
        d = (got - want).abs().max().item()
        dl = (o.logits[0] - ref_logits).abs().max().item() / max(
            1.0, ref_logits.abs().max().item())
        worst = max(worst, d)
        log(f"resnet50 {sid}: CLAM_SB small over [{len(f)}, {f.shape[1]}] "
            f"through _mil_bucketed: p={got.tolist()}, logits "
            f"{o.logits[0].tolist()}; against the head's forward max |dp| "
            f"{d:.3g} (<= {PROB_TOL:g}), logits against the plain pool "
            f"{dl:.3g} of max(1, |logit|) (<= {POOL_TOL:g})")
        if not (d <= PROB_TOL and dl <= POOL_TOL):
            raise SystemExit(f"resnet50 {sid}: the pooled head disagrees")
    score_l = read_counts()
    if score_l["gated_pool"] == 0:
        raise SystemExit("the ResNet bags never launched gated_pool")
    out["prob_err"] = worst

    pix = slides["mem0"].read_regions(pcoords[:CPU_PATCHES], 0,
                                      (RESNET_PATCH,) * 2)
    log("f32 on the card: TF32 off (cudnn.allow_tf32 False around the "
        "ResNet convolutions, cuda.matmul.allow_tf32 False)")
    out["card_cpu_rel_resnet50"] = against_cpu("resnet50", enc, pix)

    # 3. ResNet-18 and both LeViTs on the RGB rung
    for name in ("resnet18", "levit_256", "levit_128s"):
        e = build_encoder(dataclasses.replace(cfg, model_type=name),
                          device=dev)
        e = dataclasses.replace(e, plane_rung=False, dct_rung=False)
        encode_slides([("w", slides["mem0"], pcoords[:RESNET_BATCH])], e,
                      RESNET_PATCH)  # warm-up
        zero_counts()
        feats, wall = encode_slides([("m", slides["mem0"], pcoords)], e,
                                    RESNET_PATCH)
        _sync(dev)
        lc = read_counts()
        if lc["ycc_input"] or lc["dct_decode"] or lc["fused_block"]:
            raise SystemExit(f"{name} on the RGB rung launched {lc}")
        f = feats["m"]
        if f.shape != (len(pcoords), e.feat_dim) or not np.isfinite(f).all():
            raise SystemExit(f"{name}: bad features {f.shape}")
        out[f"pps_{name}"] = len(pcoords) / wall
        out[f"gflop_{name}"] = encoder_gflop(e.model, RESNET_PATCH)
        log(f"{name} RGB rung: {len(pcoords)} patches of {RESNET_PATCH}^2 "
            f"(input {e.input_size}) at batch {e.batch_size} in "
            f"{wall:.3f} s, {out[f'pps_{name}']:.1f} patches/s, "
            f"{out[f'gflop_{name}']:.3f} GFLOP per patch, {e.feat_dim}-d; "
            f"no ycc_input / dct_decode launch")
        out[f"card_cpu_rel_{name}"] = against_cpu(name, e, pix)
        del e
        torch.cuda.empty_cache()

    # 4. online training: CLAM_SB small over in-memory slides, 75 patches
    # drawn per slide per step, encoded by ResNet50-trunc in the loop
    oenc = dataclasses.replace(enc, batch_size=ONLINE_PATCHES)
    quads = [pcoords[(pcoords[:, 0] // (len(planes[0][1]) // 2) == qx)
                     & (pcoords[:, 1] // (len(planes[0][1]) // 2) == qy)]
             for qx in (0, 1) for qy in (0, 1)]
    ids = [f"on{i}" for i in range(8)]
    oslides = {sid: slides[f"mem{i % 2}"] for i, sid in enumerate(ids)}
    ocoords = {sid: quads[i // 2] for i, sid in enumerate(ids)}
    labels = np.array([i % 2 for i in range(8)], np.int32)
    ecfg = ExperimentConfig.from_dict({
        "task": {"n_classes": 2, "label_dict": {"0": 0, "1": 1}},
        "bags": {"max_patches_per_slide": ONLINE_PATCHES, "batch_size": 1},
        "model": {"model_type": "clam_sb", "model_size": "small"},
        "train": {"max_epochs": 2, "early_stopping": False, "seed": 0}})
    parts = (range(0, 4), range(4, 6), range(6, 8))
    with tempfile.TemporaryDirectory() as tmp:
        ecfg.results_dir = tmp
        dss = [MemoryOnlineDataset([ids[i] for i in part], labels[list(part)],
                                   oenc, oslides, ocoords, ecfg.bags)
               for part in parts]
        zero_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with _StepTimer(dev) as timer:
            res = train_fold(ecfg, 0, *dss, np.array([4, 4]),
                             feat_dim=enc.feat_dim, verbose=False,
                             device=dev)
        wall = time.perf_counter() - t0
    online_l = read_counts()
    steps = sum(n for n, _ in timer.epochs)
    out.update(online_ms_per_step_device=timer.ms_per_step(),
               online_ms_per_step_wall=wall * 1e3 / steps,
               online_wall_s=wall)
    log(f"online training: train_fold, 2 epochs, {steps} steps of one "
        f"{ONLINE_PATCHES}-patch bag encoded in the loop: {wall:.2f} s, "
        f"{out['online_ms_per_step_wall']:.1f} ms per step with its "
        f"encode (val and test passes included), train_epoch "
        f"{out['online_ms_per_step_device']:.2f} ms per step (warm epoch); "
        f"history "
        f"{[round(h['train_loss'], 4) for h in res.history]}; launches "
        f"{online_l}")
    if len(res.history) != 2 or not np.isfinite(res.test_probs).all() \
            or online_l["ycc_input"] == 0:
        raise SystemExit("online training did not run through the plane "
                         "rung or gave no finite result")
    genc, calls = _counting(oenc)
    gather = OnlineFeatureGather(slides["mem1"], pcoords, genc,
                                 region_size=RESNET_PATCH)
    idxs = np.arange(0, len(pcoords), 13)
    first = gather.take(idxs)
    n_first = len(calls)
    again = gather.take(idxs[::-1])
    log(f"OnlineFeatureGather.take of {len(idxs)} patches: {n_first} "
        f"encoder calls, then {len(calls) - n_first} for the second take")
    if n_first == 0 or len(calls) != n_first or \
            not np.array_equal(again, first[::-1]):
        raise SystemExit("OnlineFeatureGather re-encoded cached patches")

    records["ycc_input"]["imagenet"] = dict(
        colour, launches=plane_l["ycc_input"] + dct_l["ycc_input"])
    records["dct_decode"]["patch_256"] = dict(
        decode, launches=dct_l["dct_decode"])
    records["gated_pool"]["resnet_bag"] = dict(
        pool, launches=score_l["gated_pool"])
    launches = {k: plane_l[k] + dct_l[k] + rgb_l[k] + score_l[k]
                for k in plane_l}
    log("resnet " + json.dumps(out))
    return {"launches": launches, "owned": {},
            "online": (enc, slides, pcoords)}


# ----------------------------------------------------------------- phase 13
# the reference's DRAS defaults (main.py:359-371; SamplingConfig's)
DRAS_DEFAULTS = dict(samples_per_iteration=100, resampling_iterations=10,
                     sampling_neighbors=20, final_sample_size=100,
                     weight_smoothing=0.15, sampling_update="max",
                     sampling_random=0.2, sampling_random_delta=0.02)
DRAS_PROB_TOL = 1e-5     # card against CPU, eval_sampling's probabilities
DRAS_RATIO_TOL = 0.35    # device loop against host loop: the JAX package's
DRAS_SHARE_TOL = 0.08    # bounds for its own pair (tests/test_sampling.py:301)
KNN_TOL = 1e-4           # probe embeddings, card against CPU (f32)


def square_grid(n, step=256):
    """The first n cells of a square grid of ``step`` px patches, row by
    row, as [n, 2] (x, y) coords."""
    side = int(math.ceil(math.sqrt(n)))
    yx = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                              indexing="ij"), -1).reshape(-1, 2)[:n]
    return (yx[:, ::-1] * step).astype(np.int64)


def dras_head(size_arg, seed):
    """A CLAM_SB ``size_arg`` head on the CPU at the reference init's scale
    (``_reference_clam``) with one planted attention path: fc unit 0 reads
    0.5 v for a seeded unit direction v, and the gated scorer's unit 0
    passes it on to the score with weight 8, so a patch carrying +8 v
    scores ~7 above the rest. Returns (head, v)."""
    head = _reference_clam(size_arg, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    v = torch.randn(head.size[0], generator=g)
    v /= v.norm()
    fc, att = head.attention_net[0], head.attention_net[-1]
    with torch.no_grad():
        fc.weight[0], fc.bias[0] = 0.5 * v, 0.0
        for lin in (att.attention_a[0], att.attention_b[0]):
            lin.weight[0], lin.bias[0] = 0.0, 0.0
            lin.weight[0, 0] = 1.0
        att.attention_c.weight[0, 0] = 8.0
    return head, v


def dras_slides(n_slides, bag_range, d, seed, direction, dev, share=0.05):
    """Seeded N(0, 1) bags of ``d``-d features on square 256 px grids (the
    first slide at the top of ``bag_range``), drawn on ``dev``, each with
    a planted region: a square block of ~``share`` of its patches whose
    features carry +8 ``direction`` (``dras_head``'s attention path).
    Returns (bags, coords, planted masks), dicts by slide id, on the
    host."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    signal = 8.0 * direction.to(dev)
    bags, coords, planted = {}, {}, {}
    for i in range(n_slides):
        n = bag_range[1] if i == 0 else int(rng.integers(*bag_range))
        c = square_grid(n)
        side = int(c[:, 0].max()) // 256 + 1
        r = max(2, int(side * math.sqrt(share)))
        x0, y0 = rng.integers(0, side - r, 2)
        gx, gy = c[:, 0] // 256, c[:, 1] // 256
        hit = (gx >= x0) & (gx < x0 + r) & (gy >= y0) & (gy < y0 + r)
        bag = torch.randn(n, d, generator=g, device=dev)
        bag[torch.from_numpy(np.flatnonzero(hit)).to(dev)] += signal
        sid = f"dras_{i:02d}"
        bags[sid], coords[sid], planted[sid] = bag.cpu().numpy(), c, hit
    return bags, coords, planted


def knn_reference(X, q, k):
    """numpy: the JAX package's f32 distances, then a stable argsort (equal
    distances lower index first)."""
    X, q = X.astype(np.float32), q.astype(np.float32)
    d2 = (q * q).sum(1)[:, None] - 2.0 * (q @ X.T) + (X * X).sum(1)[None]
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def knn_by_topk(sm, X, q, k):
    """knn_indices' first design, timed against it: the k-th distance
    from a top-k, every closer point and the lowest-index ties that fill
    each row to k, then a stable sort of those k."""
    d2 = sm._sq_dists(X, q)
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
    closer, tied = d2 < kth, d2 == kth
    room = k - closer.sum(1, keepdim=True)
    chosen = closer | (tied & (torch.cumsum(tied, 1) <= room))
    rank = torch.arange(d2.shape[1], 0, -1, device=d2.device)
    idx = torch.topk(torch.where(chosen, rank, torch.zeros_like(rank)), k,
                     dim=1).indices
    order = torch.sort(torch.gather(d2, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def _recording(sm, name, dev, recs, secs):
    """Wrap ``sm.name`` (a DRAS loop) to keep each result and its wall
    time (synchronised); returns the original."""
    real = getattr(sm, name)

    def wrapped(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        res = real(*a, **k)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        recs.append(res)
        return res
    setattr(sm, name, wrapped)
    return real


def _dras_eval(sm, cfg, scfg, ds, head, coords, where, device_loop=False,
               seen=None, **kw):
    """eval_sampling on ``where`` with every DRAS result and pass time
    recorded, and with ``seen`` a list, every (subset, attention) the host
    loop's attention function saw: (probs, counts, results, pass seconds,
    wall seconds, launches)."""
    name = "dras_sample_slide_device" if device_loop else "dras_sample_slide"
    recs, secs = [], []
    real = _recording(sm, name, where, recs, secs)
    make = sm.make_attention_fn
    if seen is not None:
        def recording_make(model):
            fn = make(model)

            def attention_fn(subset):
                out = fn(subset)
                seen.append((np.array(subset), out))
                return out
            return attention_fn
        sm.make_attention_fn = recording_make
    zero_counts()
    try:
        _sync(where)
        t0 = time.perf_counter()
        probs, counts = sm.eval_sampling(
            cfg, scfg, ds, head, coords_lookup=coords, seed=13,
            device_loop=device_loop, device=where, **kw)
        _sync(where)
        wall = time.perf_counter() - t0
    finally:
        setattr(sm, name, real)
        sm.make_attention_fn = make
    return probs, counts, recs, secs, wall, read_counts()


def dras_replay(sm, ds, coords, scfg, seen, head_cpu, seed=13):
    """The host loop on the CPU, slide after slide from one numpy Generator
    as eval_sampling draws, fed the card's attention (``seen``) in order:
    (results, subsets that differ from the card's, max |attention| of the
    CPU head on each subset against the card's)."""
    cpu_attention = sm.make_attention_fn(head_cpu)
    calls = iter(seen)
    stats = {"subsets_differ": 0, "attn_err": 0.0}

    def replay(subset):
        card_subset, card_out = next(calls)
        if not np.array_equal(np.asarray(subset), card_subset):
            stats["subsets_differ"] += 1
        stats["attn_err"] = max(stats["attn_err"], float(
            np.abs(cpu_attention(subset) - card_out).max(initial=0.0)))
        return card_out
    rng = np.random.default_rng(seed)
    results = [sm.dras_sample_slide(ds._full_bag(sid), coords[sid], replay,
                                    scfg, rng, device=torch.device("cpu"))
               for sid in ds.slide_ids]
    return results, stats["subsets_differ"], stats["attn_err"]


def host_loop_split(sm, head, bag, coords, res, scfg, dev, reps=5) -> dict:
    """ms of one host-loop iteration's parts at the state a slide's DRAS
    ended in: the subset's attention (to the card and back), the kNN (and
    its indices back), update_sampling_weights and generate_sample_idxs
    (numpy on the host)."""
    attention = sm.make_attention_fn(head)
    sel = np.asarray(res.all_sampled[-scfg.samples_per_iteration:])
    X = torch.from_numpy(coords.astype(np.float32)).to(dev)
    nbrs = sm.knn_indices(X, X[torch.from_numpy(sel).to(dev)],
                          scfg.sampling_neighbors).cpu().numpy()
    attn = attention(bag[sel])
    rng = np.random.default_rng(0)
    parts = {
        "attention": lambda: attention(bag[sel]),
        "knn": lambda: sm.knn_indices(X, X[torch.from_numpy(sel).to(dev)],
                                      scfg.sampling_neighbors).cpu(),
        "update_weights": lambda: sm.update_sampling_weights(
            res.weights, attn, res.all_sampled, nbrs,
            scfg.sampling_neighbors, power=scfg.weight_smoothing,
            normalise=False),
        "generate_idxs": lambda: sm.generate_sample_idxs(
            len(bag), res.all_sampled, res.weights,
            scfg.samples_per_iteration,
            int(scfg.samples_per_iteration * scfg.sampling_random), rng)}
    out = {}
    for name, fn in parts.items():
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def _planted_stats(results, ids, planted):
    """Means over slides of the planted region's share of the final draw,
    its weight ratio (mean weight inside / outside) and its share of the
    whole DRAS bag (final draw and every sampled patch)."""
    share, ratio, bag = [], [], []
    for res, sid in zip(results, ids):
        hit, w = planted[sid], np.asarray(res.weights, np.float64)
        share.append(hit[np.asarray(res.final_idxs)].mean())
        ratio.append(w[hit].mean() / max(w[~hit].mean(), 1e-12))
        bag.append(hit[res.bag_idxs].mean())
    return float(np.mean(share)), float(np.mean(ratio)), float(np.mean(bag))


def phase_dras(dev, smi, records, *, online=None, size_arg="small", d=1024,
               eval_bags=(8, (20_000, 100_000)),
               train_bags=(16, (2_000, 20_000)),
               knn_bags=(60, (40, 600))) -> dict:
    """DRAS sampling and the kNN probe (engine/sampling.py,
    engine/knn_probe.py) at full width: CLAM_SB ``size_arg`` on ``d``-d
    bags, DRAS at the reference's defaults. B.2 at the two DRAS shapes
    against its plain version first (records["gated_pool"]["dras"]), then,
    counts zeroed before each run and read after: eval_sampling's host
    loop on the card (11 pool launches per slide; the CPU loop fed the
    card's attention draws the same bags, probabilities within 1e-5), its
    device loop (11 per slide; held to the host loop by distribution; the
    loop alone under CUDA's sync debug mode 'error'), textural sampling on
    the 100k slide, online encoding of only the sampled patches of a
    32768^2 slide (phase 12's first, tiled 4 x 4) through phase 12's
    ResNet50-trunc (``online``: its encoder, slides and coords), DRAS
    training, and knn_cv_probe (mean, max, hipt_lgp) card against CPU."""
    import copy
    import types
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.data.online import OnlineFeatureGather
    from hipt_abmil_atec23_tpu_torch.data.splits import generate_kfold_splits
    from hipt_abmil_atec23_tpu_torch.engine import knn_probe
    from hipt_abmil_atec23_tpu_torch.engine import sampling as sm
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    cpu = torch.device("cpu")
    out = {"card": smi}
    launches = {k: 0 for k in COUNTERS}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    head_cpu, direction = dras_head(size_arg, 41)
    head = copy.deepcopy(head_cpu).to(dev)
    scfg = sm.SamplingConfig(**DRAS_DEFAULTS)
    n_iter, n_final = scfg.resampling_iterations, sm._bag_cap(scfg)

    # 1. B.2 at the DRAS shapes, before the counts are zeroed
    p = gap.params_from_clam(head)
    g = torch.Generator().manual_seed(42)
    pool_rows = {}
    for what, n, valid in (("subset", scfg.samples_per_iteration, None),
                           ("bag", n_final, n_final - 60)):
        bag = torch.randn(n, d, generator=g).to(dev)
        mask = None if valid is None else \
            (torch.arange(n) < valid).to(dev)
        ref_mask = torch.ones(n, dtype=torch.bool, device=dev) \
            if mask is None else mask
        with torch.inference_mode():
            logits, scores = gap.gated_attention_pool(bag, p, mask=mask)
            rl, rs = gap.gated_attention_pool_reference(bag, ref_mask, p)
            keep = ref_mask
            err = max((logits[0] - rl).abs().max().item(),
                      (scores[keep] - rs[keep]).abs().max().item())
            pool_rows[what] = _pool_row(
                "gated_pool", p, bag, err,
                lambda: gap.gated_attention_pool(bag, p, mask=mask),
                lambda: gap.gated_attention_pool_reference(bag, ref_mask, p),
                f"[{n},{d}] f32, L {head.size[1]}, DRAS {what}"
                + ("" if mask is None else f" ({valid} valid)"))

    # 2. eval_sampling, host loop: the card, then the CPU fed its attention
    n_slides, bag_range = eval_bags
    t0 = time.perf_counter()
    bags, coords, planted = dras_slides(n_slides, bag_range, d, 43,
                                        direction, dev)
    ids = list(bags)
    log(f"dras: {n_slides} slides of {min(map(len, bags.values()))}-"
        f"{max(map(len, bags.values()))} x {d} drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    # the tie order of knn_indices at the main path's shape: a 256 px grid
    # (every distance exact in f32) against numpy's stable argsort
    c0, k = coords[ids[0]], scfg.sampling_neighbors
    q_idx = np.random.default_rng(44).choice(len(c0),
                                             scfg.samples_per_iteration,
                                             replace=False)
    X0 = torch.from_numpy(c0.astype(np.float32)).to(dev)
    q0 = X0[torch.from_numpy(q_idx).to(dev)]
    got = sm.knn_indices(X0, q0, k).cpu().numpy()
    want = knn_reference(c0, c0[q_idx], k)
    bad_rows = int((got != want).any(1).sum())
    # the same neighbours from the first design (a top-k), and the time
    # of each
    topk = lambda: knn_by_topk(sm, X0, q0, k)
    bad_topk = int((topk().cpu().numpy() != want).any(1).sum())
    out["knn_ms"] = dict(
        stable_sort=gpu_timer(lambda: sm.knn_indices(X0, q0, k)),
        topk=gpu_timer(topk))
    log(f"dras knn_indices [{len(q_idx)} x {len(c0)}] on a 256 px grid "
        f"against numpy's stable argsort: {bad_rows} rows differ (the top-k "
        f"design: {bad_topk}); ms stable sort "
        f"{out['knn_ms']['stable_sort']:.4f}, top-k "
        f"{out['knn_ms']['topk']:.4f}")
    del X0, q0
    if bad_rows or bad_topk:
        raise SystemExit("dras: knn_indices breaks distance ties otherwise "
                         "than lax.top_k (lower index first)")
    cfg = ExperimentConfig.from_dict({
        "task": {"n_classes": 2}, "bags": {"max_patches_per_slide": 0},
        "model": {"model_type": "clam_sb", "model_size": size_arg}})
    ds = BagDataset(ids, np.arange(n_slides) % 2, MemoryBagStore(bags),
                    cfg.bags)
    seen = []
    probs, counts, recs, secs, wall, lc = _dras_eval(
        sm, cfg, scfg, ds, head, coords, dev, seen=seen)
    add(lc)
    # held: the CPU host loop fed the card's attention draws the card's
    # bags, the CPU head's attention on each subset is the card's within
    # the pool's tolerance, and the CPU head classifies each card bag as
    # the card did. Run free, the CPU loop parts from the card: B.2's
    # ~1e-6 rounding moves rng.choice's draws (ROADMAP section C)
    per_slide = n_iter + 1
    replayed, sub_differ, attn_err = dras_replay(sm, ds, coords, scfg, seen,
                                                 head_cpu)
    replay_differ = [sid for sid, r, c in zip(ids, recs, replayed)
                     if not (np.array_equal(r.final_idxs, c.final_idxs)
                             and r.all_sampled == c.all_sampled)]
    perr = 0.0
    with torch.no_grad():
        for i, (sid, res) in enumerate(zip(ids, recs)):
            bag, mask = sm._padded_bag(bags[sid], res.bag_idxs, n_final, d,
                                       cpu)
            logits = gap.apply_pooled(head_cpu, bag, mask).logits[0].numpy()
            e = np.exp(logits - logits.max())
            perr = max(perr, float(np.abs(e / e.sum() - probs[i]).max()))
    sizes = [len(bags[s]) for s in ids]
    big = int(np.argmax(sizes))
    split = host_loop_split(sm, head, bags[ids[big]], coords[ids[big]],
                            recs[big], scfg, dev)
    out["host"] = dict(
        ms_per_slide=1e3 * wall / n_slides,
        ms_per_pass=[1e3 * t for t in secs],
        ms_per_iteration=1e3 * sum(secs) / (n_slides * n_iter),
        iteration_split_ms=split, launches=lc["gated_pool"],
        prob_err_cpu=perr, attn_err_cpu=attn_err,
        replay_differing=len(replay_differ),
        patches_used=counts.tolist(), sizes=sizes)
    log(f"dras (a) eval_sampling host loop, {n_slides} slides: "
        f"{out['host']['ms_per_slide']:.1f} ms per slide on the card "
        f"(DRAS passes {[round(1e3 * t, 1) for t in secs]} ms, "
        f"{out['host']['ms_per_iteration']:.2f} ms per iteration; at N "
        f"{sizes[big]} an iteration's parts "
        f"{ {k: round(v, 3) for k, v in split.items()} } ms); "
        f"{lc['gated_pool']} pool launches ({per_slide} per slide wanted)")
    log(f"dras (a) card against CPU: the CPU loop fed the card's attention "
        f"draws other bags on {len(replay_differ)} slides and other subsets "
        f"{sub_differ} times; the CPU head's attention on the card's subsets "
        f"max |d| {attn_err:.3g} (bound {POOL_TOL}), its probabilities on "
        f"the card's bags max |d| {perr:.3g} (bound {DRAS_PROB_TOL})")
    if lc["gated_pool"] != per_slide * n_slides:
        raise SystemExit("dras host loop: the pool did not launch "
                         f"{per_slide} times per slide")
    if replay_differ or sub_differ or not attn_err <= POOL_TOL or \
            not perr <= DRAS_PROB_TOL or not np.isfinite(probs).all():
        raise SystemExit("dras host loop: the card disagrees with the CPU")

    # 3. the device loop: launches, distribution against the host loop
    dprobs, dcounts, drecs, dsecs, dwall, dl = _dras_eval(
        sm, cfg, scfg, ds, head, coords, dev, device_loop=True)
    add(dl)
    (sh, rh, bh), (sd, rd, bd) = (_planted_stats(r, ids, planted)
                                  for r in (recs, drecs))
    base = float(np.mean([planted[s].mean() for s in ids]))
    out["device"] = dict(ms_per_slide=1e3 * dwall / n_slides,
                         ms_per_pass=[1e3 * t for t in dsecs],
                         launches=dl["gated_pool"], share_host=sh,
                         share_device=sd, ratio_host=rh, ratio_device=rd,
                         bag_share_host=bh, bag_share_device=bd,
                         planted_base=base)
    if dev.type == "cuda":
        # the loop alone on a card-resident bag: no host synchronisation
        # (sync debug mode 'error' raises on one), then timed
        sid = ids[0]
        fb = torch.from_numpy(bags[sid]).to(dev)
        X = torch.from_numpy(coords[sid].astype(np.float32)).to(dev)
        n = len(fb)
        loop = lambda: sm._dras_device_loop(
            fb, X, head, n, scfg.samples_per_iteration,
            scfg.final_sample_size, scfg.sampling_neighbors,
            sm._eps_schedule(scfg), scfg.weight_smoothing,
            torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                loop()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        with torch.no_grad():
            out["device"]["loop_ms_100k"] = gpu_timer(loop, iters=5)
            split = _launch_split(loop, calls=3)
        # where its time goes: device ms per loop summed by the first 60
        # characters of each kernel's name, the six largest, and in all
        kernels = {}
        for name, ms in split.items():
            kernels[name[:60]] = kernels.get(name[:60], 0.0) + ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        out["device"]["loop_busy_ms"] = sum(split.values())
        out["device"]["loop_kernels_ms"] = dict(top)
        out["device"]["loop_n"] = n
        del fb, X
    log(f"dras (b) eval_sampling device loop: "
        f"{out['device']['ms_per_slide']:.1f} ms per slide (bag to the card "
        f"included; passes {[round(1e3 * t, 1) for t in dsecs]} ms), the "
        f"loop alone {out['device'].get('loop_ms_100k', float('nan')):.2f} "
        f"ms at N {out['device'].get('loop_n')} with no host sync inside "
        f"(device busy {out['device'].get('loop_busy_ms', float('nan')):.2f}"
        f" ms: {out['device'].get('loop_kernels_ms')}); "
        f"{dl['gated_pool']} pool launches; planted share of the final draw "
        f"host {sh:.3f} device {sd:.3f} (bound {DRAS_SHARE_TOL}), weight "
        f"ratio host {rh:.3f} device {rd:.3f} (bound {DRAS_RATIO_TOL}); "
        f"share of the DRAS bag host {bh:.3f} device {bd:.3f}, base rate "
        f"{base:.3f}")
    if dl["gated_pool"] != per_slide * n_slides or \
            not np.isfinite(dprobs).all():
        raise SystemExit("dras device loop: the pool did not launch "
                         f"{per_slide} times per slide")
    if not (abs(sh - sd) <= DRAS_SHARE_TOL
            and abs(rh - rd) <= DRAS_RATIO_TOL):
        raise SystemExit("dras device loop: its draws do not match the host "
                         "loop's in distribution")

    # 4. textural sampling on the biggest slide: the bag itself as X
    tds = BagDataset(ids[:1], np.zeros(1, np.int32), MemoryBagStore(bags),
                     cfg.bags)
    tex = sm.SamplingConfig(**DRAS_DEFAULTS, sampling_type="textural")
    tprobs, _, _, tsecs, twall, tl = _dras_eval(sm, cfg, tex, tds, head,
                                                coords, dev)
    add(tl)
    out["textural"] = dict(n=sizes[0], ms_per_slide=1e3 * twall,
                           ms_per_pass=1e3 * tsecs[0],
                           launches=tl["gated_pool"])
    log(f"dras (c) textural, [{scfg.samples_per_iteration}, {d}] x [{d}, "
        f"{sizes[0]}] per iteration: {1e3 * twall:.1f} ms for the slide "
        f"(bag to the card included), {tl['gated_pool']} pool launches")
    if tl["gated_pool"] != per_slide or not np.isfinite(tprobs).all():
        raise SystemExit("dras textural: wrong launches or no result")
    del bags, ds, tds

    # 5. online at the defaults: only the sampled patches encoded (phase
    # 12's encoder) of a 32768^2 slide, phase 12's first 8192^2 slide
    # tiled 4 x 4 (each 256^2 patch lies inside one tile)
    if online is None:
        log("dras (d) online: skipped, no encoder from phase 12")
    else:
        enc, slides, _ = online
        sl = next(iter(slides.values()))
        t0 = time.perf_counter()
        big = PlaneSlide(*(np.tile(a, (4, 4) + (1,) * (a.ndim - 2))
                           for a in (sl.rgb, sl.y, sl.cb, sl.cr)))
        side = big.level_dimensions[0][0]
        pcoords = grid_coords(side, RESNET_PATCH)
        log(f"dras (d) online: a {side}^2 slide of {len(pcoords)} patches "
            f"tiled in {time.perf_counter() - t0:.1f} s")
        genc, calls = _counting(enc)
        gathers = {"big": OnlineFeatureGather(big, pcoords, genc,
                                              region_size=RESNET_PATCH)}
        ods = BagDataset(["big"], np.zeros(1, np.int32), None, cfg.bags)
        oprobs, ocounts, _, osecs, owall, ol = _dras_eval(
            sm, cfg, scfg, ods, head, {"big": pcoords}, dev,
            feature_lookup=gathers)
        add(ol)
        encoded = [len(g._cache) for g in gathers.values()]
        out["online"] = dict(encoded=encoded, patches=len(pcoords),
                             used=ocounts.tolist(), encoder_calls=len(calls),
                             ms_per_slide=1e3 * owall,
                             ms_per_pass=1e3 * osecs[0],
                             launches=ol["gated_pool"],
                             ycc_input=ol["ycc_input"])
        log(f"dras (d) online, ResNet50-trunc on the plane rung, DRAS at "
            f"the defaults: patches encoded {encoded} of {len(pcoords)} "
            f"(used {ocounts.tolist()}), {len(calls)} encoder calls, "
            f"{1e3 * osecs[0]:.1f} ms of DRAS and {1e3 * owall:.1f} ms for "
            f"the slide; launches {ol}")
        if encoded != ocounts.tolist() or max(encoded) >= len(pcoords) or \
                ol["gated_pool"] != per_slide or \
                (dev.type == "cuda" and ol["ycc_input"] == 0) or \
                not np.isfinite(oprobs).all():
            raise SystemExit("dras online: not only the sampled patches were "
                             "encoded, or the pool / colour kernel did not "
                             "launch")
        del big, gathers

    # 6. training: one full-bag epoch, then two DRAS epochs
    n_train, train_range = train_bags
    tbags, tlabels = planted_bags(n_train, train_range, d, seed=45)
    tcoords = {sid: square_grid(len(b)) for sid, b in tbags.items()}
    tcfg = ExperimentConfig.from_dict({
        "task": {"n_classes": 2}, "bags": {"max_patches_per_slide": 0},
        "model": {"model_type": "clam_sb", "model_size": size_arg},
        "train": {"lr": 2e-4, "max_epochs": 3, "early_stopping": False,
                  "seed": 5}})
    tids = list(tbags)
    parts = (np.arange(0, n_train - 6), np.arange(n_train - 6, n_train - 3),
             np.arange(n_train - 3, n_train))
    tstore = MemoryBagStore(tbags)
    sets = [BagDataset([tids[i] for i in part], tlabels[part], tstore,
                       tcfg.bags) for part in parts]
    tscfg = sm.SamplingConfig(**DRAS_DEFAULTS, no_sampling_epochs=1)
    recs_t, secs_t = [], []
    real = _recording(sm, "dras_sample_slide", dev, recs_t, secs_t)
    zero_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tcfg.results_dir = tmp
            with _StepTimer(dev) as st:
                t0 = time.perf_counter()
                res = sm.train_fold_sampling(
                    tcfg, tscfg, 0, *sets, np.bincount(tlabels, minlength=2),
                    coords_lookup=tcoords, verbose=False, device=dev)
                _sync(dev)
                twall = time.perf_counter() - t0
    finally:
        sm.dras_sample_slide = real
    trl = read_counts()
    add(trl)
    steps = [t for n, t in st.epochs if n == 1]
    n_passes = len(parts[0]) * (tcfg.train.max_epochs - 1)
    out["train"] = dict(
        ms_per_pass=1e3 * float(np.mean(secs_t)),
        ms_per_sampled_step=1e3 * float(np.mean(steps[1:] or steps)),
        full_epoch_ms=1e3 * st.epochs[0][1], wall_s=twall,
        launches=trl["gated_pool"],
        history=[h["train_loss"] for h in res.history])
    log(f"dras (e) train_fold_sampling, CLAM_SB {size_arg}, {n_train} slides "
        f"of {min(map(len, tbags.values()))}-{max(map(len, tbags.values()))}"
        f" x {d}: {out['train']['ms_per_pass']:.1f} ms per DRAS pass per "
        f"slide, {out['train']['ms_per_sampled_step']:.2f} ms per sampled "
        f"optimizer step [1, {n_final}, {d}], full-bag epoch "
        f"{out['train']['full_epoch_ms']:.0f} ms, {twall:.1f} s in all; "
        f"{trl['gated_pool']} pool launches; losses "
        f"{[round(x, 4) for x in out['train']['history']]}")
    if len(res.history) != 3 or not np.isfinite(res.test_probs).all() or \
            trl["gated_pool"] != n_iter * n_passes or \
            len(secs_t) != n_passes:
        raise SystemExit("dras training: wrong launches or no result")
    del tbags, tstore, sets

    # 7. the kNN probe, card against CPU
    n_knn, knn_range = knn_bags
    kbags, klabels = planted_bags(n_knn, knn_range, 192, seed=21)
    kstore = MemoryBagStore(kbags)
    manifest = types.SimpleNamespace(slide_ids=np.array(list(kbags)),
                                     labels=klabels, n_classes=2)
    splits = generate_kfold_splits(klabels, 5, seed=1)
    out["knn"] = {}
    for method in ("mean", "max", "hipt_lgp"):
        emb, probe = {}, {}
        for where in (dev, cpu):
            _sync(where)
            t0 = time.perf_counter()
            probe[where.type] = knn_probe.knn_cv_probe(
                kstore, manifest, splits, k=20, method=method, device=where)
            _sync(where)
            took = time.perf_counter() - t0
            emb[where.type] = (knn_probe.aggregate_slide_features(
                kstore, manifest.slide_ids, method, device=where), took)
        e_err = float(np.abs(emb[dev.type][0] - emb["cpu"][0]).max())
        p_err = max(abs(probe[dev.type][k] - probe["cpu"][k])
                    for k in probe["cpu"])
        out["knn"][method] = dict(probe=probe[dev.type], emb_err=e_err,
                                  probe_err=p_err,
                                  ms=1e3 * emb[dev.type][1],
                                  cpu_ms=1e3 * emb["cpu"][1])
        log(f"dras (f) knn_cv_probe {method}, {n_knn} bags: "
            f"{probe[dev.type]}; embeddings against the CPU max |d| "
            f"{e_err:.3g} (bound {KNN_TOL}), probe {p_err:.3g}; "
            f"{1e3 * emb[dev.type][1]:.1f} ms on the card, "
            f"{1e3 * emb['cpu'][1]:.1f} on the CPU")
        if not (e_err <= KNN_TOL and p_err <= 1e-6):
            raise SystemExit(f"dras knn probe {method}: the card disagrees "
                             "with the CPU")

    records["gated_pool"]["dras"] = dict(
        pool_rows, launches_host=lc["gated_pool"],
        launches_device=dl["gated_pool"], launches_textural=tl["gated_pool"],
        launches_online=out.get("online", {}).get("launches", 0),
        launches_train=trl["gated_pool"])
    log("dras " + json.dumps(out))
    return {"launches": launches, "owned": {}}


# ------------------------------------------------------------------ phase 14
LANE_TOL = 1e-5          # stacked lanes / folds against one-lane,
                         # sequential and CPU runs (the CPU tests' bound)
RESTORE_TOL = 1e-6       # a restored trial state against its final val loss
FLAX_TOL = 1e-6          # a flax head against the .pt export writes of it


class _Bags:
    """make_fold_datasets' stand-in (engine/experiment.py needs pandas for
    its manifest, which the card machine lacks): the fold's datasets from
    in-memory bags and a split list, with the bucket's bag settings."""

    def __init__(self, bags, labels, splits):
        self.bags, self.labels, self.splits = bags, labels, splits
        self.store = MemoryBagStore(bags)

    def __call__(self, manifest, store, cfg, fold, factory=None):
        return _fold_sets(self.bags, self.labels, self.store, cfg,
                          self.splits, fold)


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    return res, time.perf_counter() - t0


def phase_tune(dev, smi, records, *, n_slides=60, bag_range=(40, 600),
               dras_bags=(8, (20_000, 100_000)), size_arg="small", d=1024,
               lanes=8, epochs=(6, 3, 4, 4)) -> dict:
    """Tuning, trial- and fold-parallel training, flax checkpoints
    (engine/tune.py, tune_parallel.py, parallel/fold_parallel.py,
    engine/flax_ckpt.py) on phase 10's 60 bags in the winning
    configuration and phase 13's slides: (a) run_tuning, (b)
    run_trials_parallel against one-lane and CPU runs, (c)
    run_tuning_hetero beside sequential run_tuning, (d)
    train_folds_parallel against sequential train_fold, (e)
    tune_sampling_params through B.2, (f) a flax head in serve,
    evaluate_fold and the heatmap driver against its export. ``epochs``:
    (a), (b), (c), (d)'s max_epochs. Counts zeroed before each part and
    read after it."""
    import copy
    import dataclasses
    from hipt_abmil_atec23_tpu_torch import cli
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.data.splits import generate_kfold_splits
    from hipt_abmil_atec23_tpu_torch.engine import evaluate as ev
    from hipt_abmil_atec23_tpu_torch.engine import experiment
    from hipt_abmil_atec23_tpu_torch.engine import flax_ckpt
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    from hipt_abmil_atec23_tpu_torch.engine import sampling as sm
    from hipt_abmil_atec23_tpu_torch.engine import serve
    from hipt_abmil_atec23_tpu_torch.engine import train as tr
    from hipt_abmil_atec23_tpu_torch.engine import tune
    from hipt_abmil_atec23_tpu_torch.engine import tune_parallel as tp
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        TrainStateCheckpointer, ckpt_path, flax_ckpt_path)
    from hipt_abmil_atec23_tpu_torch.explain.driver import load_mil_head
    from hipt_abmil_atec23_tpu_torch.models.convert import mil_params_to_jax
    from hipt_abmil_atec23_tpu_torch.parallel.fold_parallel import (
        train_folds_parallel)
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    cpu = torch.device("cpu")
    e_tune, e_lanes, e_hetero, e_folds = epochs
    out = {"card": smi}
    launches = {k: 0 for k in COUNTERS}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    bags, labels = planted_bags(n_slides, bag_range, 192, seed=21)
    store = MemoryBagStore(bags)
    with open(WINNING_CONFIG) as f:
        cfg = ExperimentConfig.from_dict(
            {k: v for k, v in json.load(f).items() if k[0] != "_"})
    splits = generate_kfold_splits(labels, cfg.train.k, seed=cfg.train.seed)
    counts = np.bincount(labels, minlength=2)
    sets = _fold_sets(bags, labels, store, cfg, splits, 0)
    n_pad = max(s.pad_size() for s in sets)
    tmp = tempfile.mkdtemp()
    try:
        # (a) run_tuning over the default space, trial checkpoints kept
        acfg = dataclasses.replace(cfg, results_dir=os.path.join(tmp, "a"))
        val_states = []
        real_split = tr.evaluate_split

        def recording(fns, model, ds, n_pad_, rng, *a, **k):
            if ds is sets[1]:
                val_states.append(rng.bit_generator.state)
            return real_split(fns, model, ds, n_pad_, rng, *a, **k)
        tr.evaluate_split = recording
        zero_counts()
        try:
            (best, rows, trials), wall = _timed(dev, lambda: tune.run_tuning(
                acfg, sets, counts, num_samples=4, max_epochs=e_tune,
                grace_period=2, checkpoint_trials=True, verbose=False,
                output_csv=os.path.join(tmp, "a.csv"), device=dev))
        finally:
            tr.evaluate_split = real_split
        add(read_counts())
        n_epochs = [len(t.history) for t in trials]
        errs, start = [], 0
        for ti, trial in enumerate(trials):
            # the trial's last per-epoch validation pass, replayed from its
            # last retained checkpoint on the host stream it drew from
            state = val_states[start + n_epochs[ti] - 1]
            start += n_epochs[ti] + 1
            tcfg = tune.apply_trial_config(acfg, trial.config)
            fns = tr.build_step_fns(tcfg, counts, n_pad, 192, device=dev)
            model = fns.init_params()
            opt = fns.tx(model.parameters())
            ck = TrainStateCheckpointer(os.path.join(
                acfg.results_dir, f"trial_{ti}", "ckpts"))
            _, _, step = ck.restore(model, opt)
            rng = np.random.default_rng()
            rng.bit_generator.state = state
            _, loss = tr.evaluate_split(fns, model, sets[1], n_pad, rng)
            errs.append(abs(loss - trial.history[-1]["val_loss"]))
            if step != n_epochs[ti] - 1 or \
                    ck.all_steps() != list(range(max(0, step - 1), step + 1)):
                raise SystemExit(f"tune (a): trial {ti} kept steps "
                                 f"{ck.all_steps()}, last epoch {step}")
        out["tuning"] = dict(epochs=n_epochs, killed=sum(
            n < e_tune for n in n_epochs), wall_s=wall,
            ms_per_trial_epoch=1e3 * wall / sum(n_epochs),
            restore_err=max(errs), best=best)
        log(f"tune (a) run_tuning, 4 trials of the default space on the "
            f"winning configuration, max_epochs {e_tune}, grace 2: epochs "
            f"{n_epochs} ({out['tuning']['killed']} stopped early), "
            f"{out['tuning']['ms_per_trial_epoch']:.1f} ms per trial epoch, "
            f"{wall:.2f} s; the last kept checkpoint against each trial's "
            f"final val loss max |d| {max(errs):.3g} (bound {RESTORE_TOL}); "
            f"best {best}")
        if not max(errs) <= RESTORE_TOL:
            raise SystemExit("tune (a): a restored trial state does not give "
                             "the trial's final validation loss")

        # (b) run_trials_parallel: 8 lanes, dropout 0, one initial state per
        # lane; each lane alone, and the 8 on the CPU
        bcfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, drop_out=0.0),
            train=dataclasses.replace(cfg.train, early_stopping=False))
        draws = tune.sample_configs({"lr": tune.LogUniform(1e-4, 1e-2),
                                     "reg": tune.LogUniform(1e-5, 1e-1)},
                                    lanes, 0)
        lrs = np.array([t["lr"] for t in draws], np.float32)
        regs = np.array([t["reg"] for t in draws], np.float32)
        run = lambda where, lr, reg: tp.run_trials_parallel(
            bcfg, sets, counts, lr, reg, max_epochs=e_lanes, verbose=False,
            device=where)
        zero_counts()
        many, wall_many = _timed(dev, lambda: run(dev, lrs, regs))
        add(read_counts())
        real_heads = tp._lane_heads
        ones, walls_one = [], []
        try:
            for t in range(lanes):
                tp._lane_heads = lambda fns, seed, _, t=t: real_heads(
                    fns, seed, [t])
                one, w = _timed(dev, lambda: run(dev, lrs[t:t + 1],
                                                 regs[t:t + 1]))
                ones.append(one.val_loss[0])
                walls_one.append(w)
        finally:
            tp._lane_heads = real_heads
        on_cpu, wall_cpu = _timed(cpu, lambda: run(cpu, lrs, regs))
        gap_one = float(np.abs(many.val_loss - np.stack(ones)).max())
        gap_cpu = float(np.abs(many.val_loss - on_cpu.val_loss).max())
        out["lanes"] = dict(
            ms_per_epoch_lanes=1e3 * wall_many / e_lanes,
            ms_per_epoch_one=1e3 * float(np.median(walls_one)) / e_lanes,
            ms_per_epoch_cpu=1e3 * wall_cpu / e_lanes, gap_one=gap_one,
            gap_cpu=gap_cpu, best=many.best_trial,
            steps_per_epoch=len(sets[0]))
        log(f"tune (b) run_trials_parallel, {lanes} lanes x {e_lanes} epochs "
            f"of {len(sets[0])} steps (dropout 0): "
            f"{out['lanes']['ms_per_epoch_lanes']:.1f} ms per epoch for "
            f"{lanes} lanes, {out['lanes']['ms_per_epoch_one']:.1f} for one "
            f"(median), {out['lanes']['ms_per_epoch_cpu']:.1f} for {lanes} on "
            f"the CPU; val losses against each lane alone max |d| "
            f"{gap_one:.3g}, against the CPU {gap_cpu:.3g} (bound "
            f"{LANE_TOL}); best lane {many.best_trial}")
        if not (gap_one <= LANE_TOL and gap_cpu <= LANE_TOL
                and on_cpu.best_trial == many.best_trial):
            raise SystemExit("tune (b): stacked lanes disagree with one-lane "
                             "or CPU runs")

        # (c) two buckets of 8 trials: stacked, then sequential
        space = {"lr": tune.LogUniform(1e-4, 1e-2),
                 "reg": tune.LogUniform(1e-5, 1e-1),
                 "model_size": tune.GridSearch(["hipt_smaller",
                                                "hipt_small"])}
        ccfg = dataclasses.replace(cfg, results_dir=os.path.join(tmp, "c"))
        real_mk = experiment.make_fold_datasets
        experiment.make_fold_datasets = _Bags(bags, labels, splits)
        zero_counts()
        try:
            (hbest, hrows), wall_h = _timed(dev, lambda: tp.run_tuning_hetero(
                ccfg, None, None, counts, space=space, num_samples=lanes,
                max_epochs=e_hetero, grace_period=1, seed=0, verbose=False,
                device=dev))
        finally:
            experiment.make_fold_datasets = real_mk
        (sbest, srows, _), wall_s = _timed(dev, lambda: tune.run_tuning(
            ccfg, sets, counts, space=space, num_samples=lanes,
            max_epochs=e_hetero, grace_period=1, seed=0, verbose=False,
            device=dev))
        add(read_counts())
        out["hetero"] = dict(
            trials=len(hrows), wall_s=wall_h, sequential_wall_s=wall_s,
            epochs=[r["epochs"] for r in hrows],
            sequential_epochs=[r["epochs"] for r in srows],
            best=hbest, sequential_best=sbest)
        log(f"tune (c) run_tuning_hetero, {len(hrows)} trials in 2 buckets x "
            f"{e_hetero} epochs: {wall_h:.2f} s (epochs "
            f"{out['hetero']['epochs']}); sequential run_tuning on the same "
            f"trials {wall_s:.2f} s (epochs "
            f"{out['hetero']['sequential_epochs']})")
        if len(hrows) != 2 * lanes or not all(
                np.isfinite(r["last10_val_loss"]) for r in hrows):
            raise SystemExit("tune (c): the stacked search gave no result")

        # (d) every fold at once: the winning configuration (dropout 0.85),
        # then dropout 0 against sequential train_fold
        fold_sets = [_fold_sets(bags, labels, store, cfg, splits, f)
                     for f in range(cfg.train.k)]
        dcfg = dataclasses.replace(
            cfg, results_dir=os.path.join(tmp, "d"),
            train=dataclasses.replace(cfg.train, max_epochs=e_folds,
                                      min_epochs=1, patience=1, stop_epoch=1))
        zero_counts()
        win, wall_win = _timed(dev, lambda: train_folds_parallel(
            dcfg, fold_sets, counts, verbose=False, device=dev))
        lock = dataclasses.replace(
            dcfg, model=dataclasses.replace(dcfg.model, drop_out=0.0))
        par, wall_par = _timed(dev, lambda: train_folds_parallel(
            lock, fold_sets, counts, verbose=False, device=dev))
        seq, wall_seq = [], 0.0
        for f in range(cfg.train.k):
            fcfg = dataclasses.replace(lock, results_dir=os.path.join(
                tmp, "d", str(f)))
            r, w = _timed(dev, lambda: tr.train_fold(
                fcfg, f, *fold_sets[f], counts, verbose=False, device=dev))
            seq.append(r)
            wall_seq += w
        add(read_counts())
        pattern = [len(h) for h in par.histories]
        fgap = max(abs(a[k] - b[k]) for r, h in zip(seq, par.histories)
                   for a, b in zip(r.history, h)
                   for k in ("val_loss", "train_loss"))
        out["folds"] = dict(
            winning_wall_s=wall_win, winning_summary={
                k: v.tolist() for k, v in win.summary.items()},
            winning_epochs=[len(h) for h in win.histories],
            lockstep_wall_s=wall_par, sequential_wall_s=wall_seq,
            epochs=pattern, sequential_epochs=[len(r.history) for r in seq],
            gap=fgap)
        log(f"tune (d) train_folds_parallel, k = {cfg.train.k}, max_epochs "
            f"{e_folds}: winning configuration {wall_win:.2f} s, epochs "
            f"{out['folds']['winning_epochs']}, test AUC "
            f"{[round(float(v), 4) for v in win.summary['test_auc']]}; "
            f"dropout 0 "
            f"{wall_par:.2f} s against sequential train_fold {wall_seq:.2f} "
            f"s: epochs {pattern} / {out['folds']['sequential_epochs']}, "
            f"per-epoch losses max |d| {fgap:.3g} (bound {LANE_TOL})")
        if pattern != out["folds"]["sequential_epochs"] or \
                not fgap <= LANE_TOL or \
                not all(np.isfinite(v).all() for v in win.summary.values()):
            raise SystemExit("tune (d): fold-parallel training disagrees with "
                             "sequential train_fold")
        del fold_sets, win, par, seq

        # (e) tune_sampling_params on phase 13's slides through B.2
        n_dras, dras_range = dras_bags
        head_cpu, direction = dras_head(size_arg, 41)
        head = copy.deepcopy(head_cpu).to(dev)
        dbags, coords, _ = dras_slides(n_dras, dras_range, d, 43, direction,
                                       dev)
        ecfg = ExperimentConfig.from_dict({
            "task": {"n_classes": 2}, "bags": {"max_patches_per_slide": 0},
            "model": {"model_type": "clam_sb", "model_size": size_arg}})
        ds = BagDataset(list(dbags), np.arange(n_dras) % 2,
                        MemoryBagStore(dbags), ecfg.bags)
        zero_counts()
        (sbest, srows), wall_e = _timed(dev, lambda: tune.tune_sampling_params(
            ecfg, ds, head, coords_lookup=coords, num_samples=4, seed=0,
            verbose=False, device=dev))
        got = read_counts()
        add(got)
        want = sum(n_dras * (r["resampling_iterations"] + 1) for r in srows)
        bi = [r["auc"] for r in srows].index(max(r["auc"] for r in srows))
        probs, _ = sm.eval_sampling(ecfg, tune.sampling_config_of(sbest), ds,
                                    head, coords_lookup=coords, seed=bi,
                                    device=dev)
        again = M.auc_score(ds.labels, probs, 2)
        out["sampling"] = dict(
            wall_s=wall_e, ms_per_trial=1e3 * wall_e / len(srows),
            launches=got["gated_pool"], launches_wanted=want,
            aucs=[r["auc"] for r in srows], best=sbest, rerun_auc=again)
        log(f"tune (e) tune_sampling_params, 4 trials on {n_dras} slides of "
            f"{min(map(len, dbags.values()))}-{max(map(len, dbags.values()))}"
            f" x {d}: {out['sampling']['ms_per_trial']:.0f} ms per trial, "
            f"{got['gated_pool']} pool launches (wanted {want}: 8 x "
            f"(iterations + 1) per trial); AUCs "
            f"{[round(a, 4) for a in out['sampling']['aucs']]}, the best "
            f"rerun {again:.6f}")
        if got["gated_pool"] != want or again != srows[bi]["auc"]:
            raise SystemExit("tune (e): the pool's launches or the best "
                             "trial's rerun disagree")
        del dbags, ds, coords

        # (f) a flax head: the port's writer, then serve, evaluate_fold and
        # the heatmap driver load it and the .pt that export writes of it
        fhead = _reference_clam("hipt_smaller", 47, cpu)
        fdir, pdir = os.path.join(tmp, "flax"), os.path.join(tmp, "pt")
        flax_ckpt.save_params(flax_ckpt_path(fdir, 0),
                              mil_params_to_jax(fhead.state_dict()))
        cli.main(["export", "--ckpt", flax_ckpt_path(fdir, 0), "--out",
                  ckpt_path(pdir, 0), "--device", dev.type])
        fcfg = ExperimentConfig.from_dict({
            "task": {"n_classes": 2}, "bags": {"max_patches_per_slide": None},
            "model": {"model_type": "clam_sb",
                      "model_size": "hipt_smaller"}})
        ids = list(bags)[:8]
        fds = BagDataset(ids, labels[:8], store, fcfg.bags)
        feats = bags[ids[0]]
        stub = type("Encoder", (), {"feat_dim": 192})()
        zero_counts()
        got = {}
        for name, path in (("flax", flax_ckpt_path(fdir, 0)),
                           ("pt", ckpt_path(pdir, 0))):
            state = serve.ServeState(device=dev, encoder=stub)
            serve._ensure_state(serve.ServeConfig(
                slide_dir=tmp, out_dir=tmp, ckpt_path=path,
                model=fcfg.model), state)
            s = serve._mil_bucketed(state, feats).y_prob[0].cpu().numpy()
            e = ev.evaluate_fold(fcfg, 0, fds, counts, os.path.dirname(path),
                                 device=dev).test_probs
            m = load_mil_head(path, fcfg.model, 2, 192, dev)
            with torch.no_grad():
                h = gap.apply_pooled(m, torch.from_numpy(feats).to(dev)
                                     ).y_prob[0].cpu().numpy()
            got[name] = (s, e, h)
        add(read_counts())
        ferr = max(float(np.abs(a - b).max())
                   for a, b in zip(got["flax"], got["pt"]))
        out["flax"] = dict(err=ferr, probs=got["flax"][0].tolist())
        log(f"tune (f) a flax CLAM_SB hipt_smaller written without flax: "
            f"serve (_ensure_state + _mil_bucketed), evaluate_fold on "
            f"{len(ids)} full bags and load_mil_head (the heatmap driver's "
            f"loader) against the .pt export writes of it, max |d| "
            f"{ferr:.3g} (bound {FLAX_TOL})")
        if not ferr <= FLAX_TOL:
            raise SystemExit("tune (f): the flax head and its export "
                             "disagree")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    records["gated_pool"]["tune"] = dict(
        launches=launches["gated_pool"],
        launches_sampling=out["sampling"]["launches"])
    log("tune " + json.dumps(out, default=str))
    return {"launches": launches, "owned": {}}


def set_launches(records, paths) -> None:
    """Each record's launches from the run of the path that owns its kernel
    (``paths``: name -> a phase's result, whose "owned" holds the counts
    of its kernels), and every path's count beside them."""
    owned = {}
    for r in paths.values():
        owned.update(r["owned"])
    for name, rec in records.items():
        rec["launches"] = owned[name]
        rec["launches_by_path"] = {p: r["launches"][name]
                                   for p, r in paths.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one slide's encode_stream (phase 8) "
                         "and write the kernel tables to PATH and "
                         "PATH.per_op")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    dev = require_cuda()
    t0 = time.perf_counter()
    planes = [he_like_planes(10 + i, SLIDE) for i in range(2)]
    dct_slides = [DctMemorySlide(*p[1:]) for p in planes]
    log(f"fixtures: {len(planes)} x {SLIDE}^2 texture, planes and JPEG "
        f"coefficients in {time.perf_counter() - t0:.1f} s")
    rgb = planes[0][0]
    regions = torch.from_numpy(np.stack([rgb[:REGION, :REGION],
                                         rgb[REGION:, REGION:]])).to(dev)
    kres = phase_kernels(dev, dct_slides[0], planes[0], regions)
    res = phase_slice(dev, planes)
    dres = phase_dct_slice(dev, res, dct_slides)
    pres = phase_per_op_slice(dev, res)
    sres = phase_sharded(dev)
    phase_serve(dev, res["encoder"], res["clam"])
    eres = phase_encode_stage(dev, res, dres, dct_slides, planes[0])
    tres = phase_train_eval(dev, smi)
    missing = missing_file_deps(("cv2", "h5py", "pandas"))
    if missing:
        log(f"encode stage, file-bound part: skipped, missing {missing}")
    else:
        phase_files(dev, res["encoder"])
    xres = phase_explain(dev, smi, planes[0][0], res["jobs"][0][2],
                         res["feats"]["mem0"], res["clam"])
    rres = phase_resnet(dev, smi, planes, dct_slides[0], kres["records"])
    dras = phase_dras(dev, smi, kres["records"], online=rres["online"])
    tune = phase_tune(dev, smi, kres["records"])
    if args.profile:
        phase_profile(dev, res["encoder"], pres["encoder"], planes[0],
                      dct_slides[0], args.profile)
    records = kres["records"]
    set_launches(records, {**kres["paths"], "plane": res, "dct": dres,
                           "per_op": pres, "sharded": sres,
                           "encode_stage": eres, "train_eval": tres,
                           "explain": xres, "resnet": rres,
                           "dras": dras, "tune": tune})
    records["fused_block"].update(
        launches_vit256=eres["launches_vit256"],
        ms_256x264x384=eres.get("block_ms_vit256"))
    log(f"card: {smi}")
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
