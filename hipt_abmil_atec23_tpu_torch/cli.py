"""The port's command line: the tile, encode and serve stages.

    python -m hipt_abmil_atec23_tpu_torch.cli <tile|encode|serve> [flags]

Each subcommand takes the JAX package's flags (hipt_abmil_atec23_tpu/cli.py:
tile, encode, serve) and writes the same artifacts, so either package reads
what the other wrote: coords h5s, masks and stitches under the tile stage's
save_dir, feature bags in the reference layout under feat_dir, the serve
journal and results. ``--device`` picks the card (``cuda``, the default) or
the CPU (``cpu``). Choices the port does not have yet (the ResNet and LeViT
encoders, flax MIL checkpoints) raise an error that names the ROADMAP item
that ports them; the other subcommands of the JAX CLI are not ported yet.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import List, Optional

ENCODERS = ["resnet18", "resnet50", "levit_128s", "levit_256", "HIPT_4K",
            "vit256"]


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")


def _add_tile(sub):
    p = sub.add_parser("tile", help="segment tissue + enumerate patch coords "
                       "(reference: create_patches_fp.py)")
    p.add_argument("--source", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--step_size", type=int, default=256)
    p.add_argument("--patch_level", type=int, default=0)
    p.add_argument("--contour_fn", default="four_pt",
                   choices=["four_pt", "four_pt_hard", "center", "basic"])
    p.add_argument("--preset", default=None)
    p.add_argument("--process_list", default=None)
    p.add_argument("--sthresh", type=int, default=8)
    p.add_argument("--mthresh", type=int, default=7)
    p.add_argument("--close", type=int, default=4)
    p.add_argument("--use_otsu", action="store_true")
    p.add_argument("--a_t", type=int, default=100)
    p.add_argument("--a_h", type=int, default=16)
    p.add_argument("--max_n_holes", type=int, default=8)
    p.add_argument("--seg_level", type=int, default=-1)
    p.add_argument("--pad_slide", action="store_true")
    p.add_argument("--no_seg", action="store_true")
    p.add_argument("--no_patch", action="store_true")
    p.add_argument("--no_stitch", action="store_true")
    p.add_argument("--no_auto_skip", action="store_true")
    _add_device(p)


def _cmd_tile(a):
    # host work only: --device is taken for a uniform command line
    from hipt_abmil_atec23_tpu_torch.slideio.pipeline import seg_and_patch
    from hipt_abmil_atec23_tpu_torch.utils.config import SegConfig, TileConfig
    cfg = TileConfig(
        patch_size=a.patch_size, step_size=a.step_size,
        patch_level=a.patch_level, contour_fn=a.contour_fn,
        pad_slide=a.pad_slide,
        seg=SegConfig(seg_level=a.seg_level, sthresh=a.sthresh,
                      mthresh=a.mthresh, use_otsu=a.use_otsu, close=a.close,
                      a_t=a.a_t, a_h=a.a_h, max_n_holes=a.max_n_holes))
    res = seg_and_patch(a.source, a.save_dir, cfg, preset=a.preset,
                        process_list=a.process_list, do_seg=not a.no_seg,
                        do_patch=not a.no_patch, do_stitch=not a.no_stitch,
                        auto_skip=not a.no_auto_skip,
                        pad_slide=a.pad_slide)
    print(f"[tile] done in {res.total_time:.1f}s; statuses:\n"
          f"{res.df['status'].value_counts().to_string()}")


def _add_encode(sub):
    p = sub.add_parser("encode", help="extract per-slide feature bags "
                       "(reference: extract_features_fp.py)")
    p.add_argument("--data_h5_dir", required=True,
                   help="dir containing patches/*.h5 coords")
    p.add_argument("--data_slide_dir", required=True)
    p.add_argument("--csv_path", default=None,
                   help="optional slide list CSV (slide_id column)")
    p.add_argument("--feat_dir", required=True)
    p.add_argument("--model_type", default="HIPT_4K", choices=ENCODERS)
    p.add_argument("--pretraining_dataset", default="ImageNet",
                   choices=["ImageNet", "Histo"])
    p.add_argument("--use_transforms", default="none")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--target_patch_size", type=int, default=0,
                   help="resize decoded patches before embedding "
                        "(reference: --target_patch_size)")
    p.add_argument("--slide_ext", default=".tif")
    p.add_argument("--vit256_ckpt", default=None)
    p.add_argument("--vit4k_ckpt", default=None)
    p.add_argument("--resnet_ckpt", default=None)
    p.add_argument("--levit_ckpt", default=None,
                   help="original-layout LeViT torch checkpoint")
    p.add_argument("--no_skip", action="store_true")
    p.add_argument("--float32", action="store_true")
    p.add_argument("--hipt_features", default="cls4k",
                   choices=["cls4k", "mean256", "concat"],
                   help="HIPT output variant (reference forward_asset_dict)")
    p.add_argument("--stage_h2d", action="store_true",
                   help="copy every batch to the device before the first "
                        "compute dispatch (encode_stream stage=True)")
    _add_device(p)


def _cmd_encode(a):
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.engine.encode import (
        build_encoder, encode_many)
    from hipt_abmil_atec23_tpu_torch.ops.augment import build_transform
    from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig

    cfg = EncoderConfig(model_type=a.model_type,
                        pretraining_dataset=a.pretraining_dataset,
                        transforms=a.use_transforms, batch_size=a.batch_size,
                        vit256_ckpt=a.vit256_ckpt, vit4k_ckpt=a.vit4k_ckpt,
                        resnet_ckpt=a.resnet_ckpt, levit_ckpt=a.levit_ckpt,
                        hipt_features=a.hipt_features,
                        dtype="float32" if a.float32 else "bfloat16")
    encoder = build_encoder(cfg, device=a.device)
    transform = build_transform(a.use_transforms)
    store = FeatureBagStore(a.feat_dir)

    patches_dir = os.path.join(a.data_h5_dir, "patches")
    if a.csv_path:
        import pandas as pd
        slide_ids = pd.read_csv(a.csv_path)["slide_id"].astype(str).tolist()
        slide_ids = [os.path.splitext(s)[0] for s in slide_ids]
    else:
        slide_ids = sorted(os.path.splitext(f)[0]
                           for f in os.listdir(patches_dir)
                           if f.endswith(".h5"))
    jobs = []
    for sid in slide_ids:
        h5 = os.path.join(patches_dir, f"{sid}.h5")
        if not os.path.exists(h5):
            print(f"[encode] {sid}: no coords h5, skipping")
            continue
        jobs.append((os.path.join(a.data_slide_dir, sid + a.slide_ext),
                     h5, sid))
    t0 = time.perf_counter()
    done, failed = encode_many(jobs, encoder, store,
                               skip_existing=not a.no_skip,
                               transform=transform,
                               target_patch_size=a.target_patch_size,
                               stage=a.stage_h2d)
    dt = time.perf_counter() - t0
    print(f"[encode] {len(done)} slides in {dt:.1f}s "
          f"({len(done) / max(dt, 1e-9) * 3600:.1f} slides/hour)")
    if failed:
        # the tile stage's process list has statuses; this is the encode
        # stage's record, so training can tell an incomplete store apart
        fcsv = os.path.join(a.feat_dir, "encode_failures.csv")
        os.makedirs(a.feat_dir, exist_ok=True)
        with open(fcsv, "a", newline="") as f:
            w = csv.writer(f)  # quotes commas/newlines in exception text
            for sid, err in failed:
                w.writerow([sid, repr(err)])
        print(f"[encode] {len(failed)} slides FAILED "
              f"({', '.join(s for s, _ in failed)}) -> {fcsv}")


def _add_serve(sub):
    p = sub.add_parser("serve", help="continuous slide-inference service: "
                       "watch a folder, tile+encode+score new slides "
                       "through one pipelined stream")
    p.add_argument("--slide_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt", required=True,
                   help="MIL checkpoint (reference-layout torch .pt)")
    p.add_argument("--model_type", default="clam_sb")
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--encoder", default="HIPT_4K", choices=ENCODERS)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--patch_size", type=int, default=4096)
    p.add_argument("--patch_level", type=int, default=0)
    p.add_argument("--use_otsu", action="store_true")
    p.add_argument("--a_t", type=int, default=100)
    p.add_argument("--vit256_ckpt", default=None)
    p.add_argument("--vit4k_ckpt", default=None)
    p.add_argument("--resnet_ckpt", default=None)
    p.add_argument("--once", action="store_true",
                   help="drain pending slides once and exit (cron-style)")
    p.add_argument("--poll_s", type=float, default=5.0)
    p.add_argument("--max_drains", type=int, default=None,
                   help="stop the daemon after N polls (bounded serving)")
    p.add_argument("--save_features", action="store_true",
                   help="persist feature bags (FeatureBagStore layout) "
                        "so heatmap/eval stages can reuse them")
    p.add_argument("--top_k", type=int, default=8)
    p.add_argument("--float32", action="store_true")
    p.add_argument("--min_stable_s", type=float, default=10.0,
                   help="mtime age a slide file must reach before it is "
                        "served (guards against scoring mid-upload files)")
    _add_device(p)


def _cmd_serve(a):
    from hipt_abmil_atec23_tpu_torch.engine.encode import NOT_PORTED_ENCODERS
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeConfig, ServeState, serve_forever, serve_once, write_config)
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        EncoderConfig, ModelConfig, SegConfig, TileConfig)
    # refused before serving starts: the daemon logs a failed drain and
    # polls on, so these would otherwise never stop it
    if a.encoder in NOT_PORTED_ENCODERS:
        raise NotImplementedError(f"encoder {a.encoder!r} is not ported yet "
                                  "(ROADMAP §A.11)")
    if not a.ckpt.endswith(".pt"):
        raise NotImplementedError(f"{a.ckpt!r}: the port serves "
                                  "reference-layout torch .pt MIL heads; "
                                  "flax checkpoints are not ported yet "
                                  "(ROADMAP §A.7)")
    cfg = ServeConfig(
        slide_dir=a.slide_dir, out_dir=a.out_dir, ckpt_path=a.ckpt,
        encoder=EncoderConfig(
            model_type=a.encoder, batch_size=a.batch_size,
            vit256_ckpt=a.vit256_ckpt, vit4k_ckpt=a.vit4k_ckpt,
            resnet_ckpt=a.resnet_ckpt,
            dtype="float32" if a.float32 else "bfloat16"),
        model=ModelConfig(model_type=a.model_type, model_size=a.model_size),
        tile=TileConfig(patch_size=a.patch_size, step_size=a.patch_size,
                        patch_level=a.patch_level,
                        seg=SegConfig(use_otsu=a.use_otsu, a_t=a.a_t)),
        n_classes=a.n_classes, poll_s=a.poll_s,
        save_features=a.save_features, top_k=a.top_k,
        min_stable_s=a.min_stable_s)
    write_config(cfg)
    if a.once:
        recs = serve_once(cfg, ServeState(device=a.device))
        n_done = sum(1 for r in recs if r.get("status") == "done")
        print(f"[serve] drained {len(recs)} slides "
              f"({n_done} scored, {len(recs) - n_done} failed_seg)")
    else:
        n = serve_forever(cfg, device=a.device, max_drains=a.max_drains)
        print(f"[serve] served {n} slides")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="hipt_abmil_atec23_tpu_torch",
        description="WSI MIL pipeline on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_tile, _add_encode, _add_serve):
        add(sub)
    a = parser.parse_args(argv)
    {"tile": _cmd_tile, "encode": _cmd_encode, "serve": _cmd_serve}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
