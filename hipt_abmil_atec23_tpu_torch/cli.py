"""The port's command line: the tile, encode, train, eval, splits,
bootstrap, count, serve and heatmap stages.

    python -m hipt_abmil_atec23_tpu_torch.cli <tile|encode|train|eval|splits|
                                               bootstrap|count|serve|heatmap>
                                               [flags]

Each subcommand takes the JAX package's flags (hipt_abmil_atec23_tpu/cli.py)
and writes the same artifacts, so either package reads what the other wrote:
coords h5s, masks and stitches under the tile stage's save_dir, feature bags
in the reference layout under feat_dir, split CSVs, fold CSVs, summaries and
the experiment settings, the serve journal and results, heatmaps,
blockmaps, ROIs and attention galleries. Checkpoints are the reference's
``s_{fold}_checkpoint.pt``. ``--device`` picks the card (``cuda``, the
default) or the CPU (``cpu``). Every encoder of the JAX package (HIPT_4K,
vit256, resnet50, resnet18, levit_128s, levit_256) runs in ``encode``,
``serve``, ``heatmap`` and online training (``train --extract_features``).
Choices the port does not have yet (flax MIL checkpoints, tuning, fold-
and trial-parallel training, DRAS sampling) raise an error that names the
ROADMAP item that ports them; knn, export and parity are not ported yet.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

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


# train / eval flags the port refuses, with the ROADMAP item that ports them
_NOT_PORTED = {"tuning": "§A.10", "trial_parallel": "§A.10",
               "fold_parallel": "§A.10", "sampling": "§A.9",
               "use_sampling": "§A.9"}


def _add_train(sub):
    p = sub.add_parser("train", help="k-fold CV MIL training "
                       "(reference: main.py)")
    p.add_argument("--task", default="treatment")
    p.add_argument("--csv_path", required=True)
    p.add_argument("--feat_dir", required=True)
    p.add_argument("--results_dir", required=True)
    p.add_argument("--exp_code", default="exp")
    p.add_argument("--split_dir", default="")
    p.add_argument("--model_type", default="clam_sb",
                   choices=["clam_sb", "clam_mb", "mil"])
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--drop_out", type=float, default=0.0)
    p.add_argument("--no_inst_cluster", action="store_true")
    p.add_argument("--subtyping", action="store_true")
    p.add_argument("--B", type=int, default=8, help="k_sample")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--opt", default="adam", choices=["adam", "sgd"])
    p.add_argument("--bag_loss", default="ce",
                   choices=["ce", "balanced_ce", "svm"])
    p.add_argument("--bag_weight", type=float, default=0.7)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--min_epochs", type=int, default=50)
    p.add_argument("--no_early_stopping", action="store_true")
    p.add_argument("--weighted_sample", action="store_true")
    p.add_argument("--max_patches_per_slide", type=int, default=75)
    p.add_argument("--perturb_variance", type=float, default=0.0)
    p.add_argument("--number_of_augs", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=1,
                   help="bags per optimizer step (1 = reference-faithful)")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--k_start", type=int, default=-1)
    p.add_argument("--k_end", type=int, default=-1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--epoch_chunk", type=int, default=1,
                   help="epochs of batches drawn on the host at once "
                        "(the JAX package's draw order)")
    p.add_argument("--full_bag_sharded", action="store_true",
                   help="exact full-bag training: the instance axis shards "
                        "over the process group (no subsampling; clam_sb)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    p.add_argument("--log_data", action="store_true")
    p.add_argument("--debug_loader", action="store_true",
                   help="iterate the data pipeline once without training "
                        "(reference: --debug_loader)")
    # online feature extraction: a frozen encoder in the training loop
    # (reference: --extract_features, core_utils.py:106-119)
    p.add_argument("--extract_features", action="store_true")
    p.add_argument("--data_h5_dir", default=None)
    p.add_argument("--data_slide_dir", default=None)
    p.add_argument("--slide_ext", default=".tif")
    p.add_argument("--model_architecture", default="resnet50",
                   choices=ENCODERS)
    p.add_argument("--pretraining_dataset", default="ImageNet")
    p.add_argument("--use_transforms", default="none")
    p.add_argument("--vit256_ckpt", default=None)
    p.add_argument("--vit4k_ckpt", default=None)
    p.add_argument("--resnet_ckpt", default=None)
    # not ported yet: each is refused, naming its ROADMAP item
    for flag in ("sampling", "tuning", "trial_parallel", "fold_parallel"):
        p.add_argument(f"--{flag}", action="store_true",
                       help=f"not ported yet (ROADMAP {_NOT_PORTED[flag]})")
    _add_route_flags(p, "train")
    _add_device(p)


# the JAX CLI's flags that act only on a route above; accepted (with or
# without a value) so its command lines parse, and unused
_ROUTE_FLAGS = {
    "train": ("sampling_type texture_model texture_feat_dir sampling_average "
              "device_sampling samples_per_iteration resampling_iterations "
              "sampling_random sampling_random_delta sampling_neighbors "
              "final_sample_size weight_smoothing sampling_update "
              "no_sampling_epochs fully_random grid_sample "
              "num_tuning_samples tuning_output_file checkpoint_trials "
              "resume_tuning grace_period"),
    "eval": ("device_sampling samples_per_iteration resampling_iterations "
             "sampling_neighbors final_sample_size weight_smoothing "
             "sampling_random sampling_random_delta fully_random "
             "sampling_type texture_model texture_feat_dir sampling_average "
             "tune_sampling num_tuning_samples eval_features data_slide_dir "
             "data_h5_dir eval_encoder resnet_ckpt vit256_ckpt vit4k_ckpt")}


def _add_route_flags(p, cmd: str) -> None:
    for name in _ROUTE_FLAGS[cmd].split():
        p.add_argument(f"--{name}", nargs="?", const=True,
                       help="acts only on a route not ported yet")


def _refuse_not_ported(a, cmd: str) -> None:
    for flag, item in _NOT_PORTED.items():
        if getattr(a, flag, False):
            raise NotImplementedError(f"{cmd} --{flag} is not ported yet "
                                      f"(ROADMAP {item})")


def _train_cfg(a):
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.data.tasks import get_task
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        BagConfig, ExperimentConfig, ModelConfig, TrainConfig)
    task = dataclasses.replace(get_task(a.task), csv_path=a.csv_path)
    return ExperimentConfig(
        exp_code=a.exp_code, results_dir=a.results_dir, split_dir=a.split_dir,
        log_data=a.log_data, task=task,
        bags=BagConfig(feat_dir=a.feat_dir,
                       max_patches_per_slide=a.max_patches_per_slide,
                       perturb_variance=a.perturb_variance,
                       number_of_augs=a.number_of_augs,
                       batch_size=a.batch_size),
        model=ModelConfig(model_type=a.model_type, model_size=a.model_size,
                          drop_out=a.drop_out,
                          no_inst_cluster=a.no_inst_cluster,
                          subtyping=a.subtyping, k_sample=a.B),
        train=TrainConfig(lr=a.lr, reg=a.reg, opt=a.opt, bag_loss=a.bag_loss,
                          bag_weight=a.bag_weight, max_epochs=a.max_epochs,
                          min_epochs=a.min_epochs,
                          early_stopping=not a.no_early_stopping,
                          weighted_sample=a.weighted_sample, seed=a.seed,
                          k=a.k, k_start=a.k_start, k_end=a.k_end,
                          continue_training=a.continue_training,
                          epoch_chunk=a.epoch_chunk))


def _debug_loader(cfg, manifest, store) -> None:
    """Load every bag once, no training (reference: --debug_loader,
    core_utils.py:205-208)."""
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    rng = np.random.default_rng(cfg.train.seed)
    ds = BagDataset(list(manifest.slide_ids), manifest.labels, store,
                    cfg.bags)
    sizes = []
    for i, sid in enumerate(ds.slide_ids):
        bag = ds.get_bag(i, rng)
        sizes.append(len(bag))
        print(f"[debug_loader] {sid}: bag {bag.shape}")
    print(f"[debug_loader] {len(sizes)} bags OK; "
          f"mean {np.mean(sizes):.1f} max {np.max(sizes)}")


def _train_full_bags(cfg, manifest, store, device) -> None:
    """Exact full-bag training with the instance axis sharded over the
    process group (parallel/full_bag_train.py): every slide trains on all
    of its instances."""
    import pandas as pd
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        ckpt_path, save_params)
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.parallel.full_bag_train import (
        train_full_bags_sharded)
    from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
    from hipt_abmil_atec23_tpu_torch.parallel.multihost import init_multihost
    world = init_multihost(device=device)
    try:
        mesh = make_mesh([("inst", world)], device.type)
        os.makedirs(cfg.results_dir, exist_ok=True)
        rows = []
        for fold in range(cfg.train.k):
            tr, va, _ = make_fold_datasets(manifest, store, cfg, fold)
            model, hist = train_full_bags_sharded(cfg, tr, va, mesh)
            save_params(ckpt_path(cfg.results_dir, fold), model)
            pd.DataFrame(hist).to_csv(
                os.path.join(cfg.results_dir, f"history_{fold}.csv"),
                index=False)
            rows.append({"folds": fold, "val_auc": hist[-1]["val_auc"],
                         "val_loss": hist[-1]["val_loss"]})
        summary = pd.DataFrame(rows)
        summary.to_csv(os.path.join(cfg.results_dir, "summary.csv"),
                       index=False)
        print(summary)
    finally:
        dist.destroy_process_group()


def _cmd_train(a):
    import contextlib
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    _refuse_not_ported(a, "train")
    device = resolve_device(a.device)
    cfg = _train_cfg(a)
    manifest = SlideManifest.from_csv(a.csv_path, cfg.task.label_dict,
                                      ignore=cfg.task.ignore)
    store = FeatureBagStore(a.feat_dir)
    if a.debug_loader:
        _debug_loader(cfg, manifest, store)
        return

    def run():
        if a.extract_features:
            _train_online(a, cfg, manifest, device)
            return
        if a.full_bag_sharded:
            _train_full_bags(cfg, manifest, store, device)
            return
        from hipt_abmil_atec23_tpu_torch.engine.experiment import run_cv
        summary, _ = run_cv(cfg, manifest, store, device=device)
        print(summary)

    ctx = contextlib.nullcontext()
    if a.trace:
        from hipt_abmil_atec23_tpu_torch.utils.logging import trace
        ctx = trace(a.trace)
    with ctx:
        if a.profile:
            # reference: --profile wraps main in cProfile (main.py:514-521)
            import cProfile
            import pstats
            pr = cProfile.Profile()
            pr.enable()
            run()
            pr.disable()
            pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
        else:
            run()


def _train_online(a, cfg, manifest, device) -> None:
    """MIL training with a frozen encoder in the loop, no feature bags
    (reference: --extract_features path): bags are sampled coords of each
    slide, encoded when drawn (data/online.py)."""
    import warnings
    import pandas as pd
    from hipt_abmil_atec23_tpu_torch.data.online import (
        OnlineEncodingBagDataset)
    from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        _write_fold_csv, fold_range, make_fold_datasets, summary_csv_name)
    from hipt_abmil_atec23_tpu_torch.engine.train import train_fold
    from hipt_abmil_atec23_tpu_torch.ops.augment import build_transform
    from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig

    if not (a.data_h5_dir and a.data_slide_dir):
        raise SystemExit("--extract_features requires --data_h5_dir and "
                         "--data_slide_dir")
    enc_cfg = EncoderConfig(
        model_type=a.model_architecture,
        pretraining_dataset=a.pretraining_dataset,
        vit256_ckpt=a.vit256_ckpt, vit4k_ckpt=a.vit4k_ckpt,
        resnet_ckpt=a.resnet_ckpt)
    if not (a.resnet_ckpt or (a.vit256_ckpt and a.vit4k_ckpt)):
        warnings.warn(
            "--extract_features without encoder checkpoints: the frozen "
            "encoder runs with seeded RANDOM weights (pipeline testing "
            "only). Pass --resnet_ckpt or --vit256_ckpt/--vit4k_ckpt for "
            "real features.")
    encoder = build_encoder(enc_cfg, device=device)
    transform = build_transform(a.use_transforms)
    coords_dir = os.path.join(a.data_h5_dir, "patches")
    slide_paths = {sid: os.path.join(a.data_slide_dir, sid + a.slide_ext)
                   for sid in manifest.slide_ids}

    def factory(sub_manifest, is_train):
        return OnlineEncodingBagDataset(
            list(sub_manifest.slide_ids), sub_manifest.labels, encoder,
            slide_paths, coords_dir, cfg.bags,
            transform=transform if is_train else None)

    rows = []
    for fold in fold_range(cfg):
        tr, va, te = make_fold_datasets(manifest, None, cfg, fold,
                                        factory=factory)
        try:
            res = train_fold(cfg, fold, tr, va, te, manifest.class_counts(),
                             feat_dim=encoder.feat_dim, device=device)
        finally:
            for ds in (tr, va, te):
                ds.close()
        _write_fold_csv(cfg.results_dir, res)
        rows.append({"folds": fold, "test_auc": res.test_auc,
                     "val_auc": res.val_auc, "test_acc": res.test_acc,
                     "val_acc": res.val_acc})
    summary = pd.DataFrame(rows)
    summary.to_csv(os.path.join(cfg.results_dir, summary_csv_name(cfg)),
                   index=False)
    print(summary)


def _add_eval(sub):
    p = sub.add_parser("eval", help="per-fold checkpoint inference "
                       "(reference: eval.py)")
    p.add_argument("--task", default="treatment")
    p.add_argument("--csv_path", required=True)
    p.add_argument("--feat_dir", required=True)
    p.add_argument("--models_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--split_dir", default="")
    p.add_argument("--splits", default="test", choices=["test", "val", "all"])
    p.add_argument("--model_type", default="clam_sb")
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--drop_out", type=float, default=0.0)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--folds", type=int, nargs="*", default=None)
    p.add_argument("--max_patches_per_slide", type=int, default=75)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--use_sampling", action="store_true",
                   help="inference-time DRAS sampling: not ported yet "
                        "(ROADMAP §A.9)")
    _add_route_flags(p, "eval")
    _add_device(p)


def _cmd_eval(a):
    import dataclasses
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.data.tasks import get_task
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.evaluate import run_eval
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        BagConfig, ExperimentConfig, ModelConfig, TrainConfig)
    _refuse_not_ported(a, "eval")
    device = resolve_device(a.device)
    task = dataclasses.replace(get_task(a.task), csv_path=a.csv_path)
    cfg = ExperimentConfig(
        exp_code="eval", results_dir=a.save_dir, split_dir=a.split_dir,
        task=task,
        bags=BagConfig(feat_dir=a.feat_dir,
                       max_patches_per_slide=a.max_patches_per_slide),
        model=ModelConfig(model_type=a.model_type, model_size=a.model_size,
                          drop_out=a.drop_out),
        train=TrainConfig(k=a.k, seed=a.seed))
    manifest = SlideManifest.from_csv(a.csv_path, task.label_dict)
    run_eval(cfg, manifest, FeatureBagStore(a.feat_dir), a.models_dir,
             a.save_dir, splits=a.splits, folds=a.folds, device=device)


def _add_splits(sub):
    p = sub.add_parser("splits", help="generate k-fold split CSVs "
                       "(reference: create_splits_seq.py)")
    p.add_argument("--task", default="treatment")
    p.add_argument("--csv_path", required=True)
    p.add_argument("--split_dir", required=True)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--seed", type=int, default=1)
    _add_device(p)


def _cmd_splits(a):
    # host work only: --device is taken for a uniform command line
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.data.splits import (
        check_split_disjoint, generate_kfold_splits, save_split_bool_csv,
        save_split_csv, save_split_descriptor)
    from hipt_abmil_atec23_tpu_torch.data.tasks import get_task
    task = get_task(a.task)
    manifest = SlideManifest.from_csv(a.csv_path, task.label_dict,
                                      ignore=task.ignore)
    os.makedirs(a.split_dir, exist_ok=True)
    ids = list(manifest.slide_ids)
    for i, s in enumerate(generate_kfold_splits(manifest.labels, a.k,
                                                seed=a.seed)):
        check_split_disjoint(s)
        save_split_csv(os.path.join(a.split_dir, f"splits_{i}.csv"), ids, s)
        save_split_bool_csv(
            os.path.join(a.split_dir, f"splits_{i}_bool.csv"), ids, s)
        save_split_descriptor(
            os.path.join(a.split_dir, f"splits_{i}_descriptor.csv"),
            manifest.labels, s, task.n_classes)
    print(f"[splits] wrote {a.k} folds to {a.split_dir}")


def _add_bootstrap(sub):
    p = sub.add_parser("bootstrap", help="bootstrap CIs from fold CSVs "
                       "(reference: bootstrapping.py)")
    p.add_argument("--dirs", nargs="+", required=True)
    p.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--bootstraps", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--plot_roc", action="store_true",
                   help="pooled ROC curve per run-repeat dir "
                        "(reference: bootstrapping.py --plot_roc_curves)")
    p.add_argument("--roc_plot_path", default="roc_curves.png")
    _add_device(p)


def _cmd_bootstrap(a):
    from hipt_abmil_atec23_tpu_torch.engine.evaluate import (
        bootstrap_from_fold_csvs, plot_roc_curves)
    out = bootstrap_from_fold_csvs(a.dirs, a.folds,
                                   n_bootstraps=a.bootstraps, seed=a.seed,
                                   device=a.device)
    text = json.dumps(out, indent=2)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    if a.plot_roc:
        print(f"[bootstrap] ROC plot -> "
              f"{plot_roc_curves(a.dirs, a.folds, a.roc_plot_path)}")


def _add_count(sub):
    p = sub.add_parser("count", help="patch-count statistics "
                       "(reference: count_patches.py)")
    p.add_argument("--patches_dir", required=True)
    p.add_argument("--csv_path", default=None)
    _add_device(p)


def _cmd_count(a):
    # host work only: --device is taken for a uniform command line
    import h5py
    import pandas as pd
    rows = []
    for f in sorted(os.listdir(a.patches_dir)):
        if not f.endswith(".h5"):
            continue
        with h5py.File(os.path.join(a.patches_dir, f), "r") as h:
            rows.append({"slide_id": os.path.splitext(f)[0],
                         "n_patches": len(h["coords"])})
    df = pd.DataFrame(rows)
    if a.csv_path and os.path.exists(a.csv_path):
        labels = pd.read_csv(a.csv_path)
        labels["slide_id"] = labels["slide_id"].astype(str)
        df = df.merge(labels[["slide_id", "label"]], on="slide_id",
                      how="left")
        print(df.groupby("label")["n_patches"].agg(["count", "sum", "mean"]))
    print(f"total {df['n_patches'].sum()} patches over {len(df)} slides; "
          f"mean {df['n_patches'].mean():.1f} "
          f"median {df['n_patches'].median():.1f}")


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
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeConfig, ServeState, serve_forever, serve_once, write_config)
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        EncoderConfig, ModelConfig, SegConfig, TileConfig)
    from hipt_abmil_atec23_tpu_torch.models.abmil import check_model_type
    # refused before serving starts: the daemon logs a failed drain and
    # polls on, so these would otherwise never stop it
    check_model_type(a.model_type)
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


def _add_heatmap(sub):
    p = sub.add_parser("heatmap", help="attention heatmaps "
                       "(reference: create_heatmaps.py)")
    p.add_argument("--config", default=None,
                   help="JSON job config: batch mode over many slides "
                        "(explain/driver.py); other flags but --device "
                        "ignored")
    p.add_argument("--confirm", action="store_true",
                   help="print the resolved config and ask Y/N before "
                        "running (reference: create_heatmaps.py:85-101; "
                        "off by default so batch jobs stay unattended)")
    p.add_argument("--slide", default=None)
    p.add_argument("--coords_h5", default=None)
    p.add_argument("--features", default=None,
                   help="precomputed features (.pt/.h5/.npy); if absent, "
                   "encode on the fly")
    p.add_argument("--ckpt", default=None,
                   help="MIL checkpoint (reference-layout torch .pt)")
    p.add_argument("--model_type", default="clam_sb")
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--encoder", default="HIPT_4K")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--cmap", default="coolwarm")
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--sample_topk", type=int, default=8)
    # hierarchical ViT-attention galleries over the top ROIs (reference:
    # HIPT_4K/hipt_heatmap_utils.py:347-664, hipt_4k.py:167-305)
    p.add_argument("--hierarchical", action="store_true",
                   help="shift-averaged hierarchical heatmap galleries for "
                        "the top --hier_regions ROIs")
    p.add_argument("--hier_mode", default="concat_select",
                   choices=["indiv", "concat", "concat_select"])
    p.add_argument("--hier_regions", type=int, default=2)
    p.add_argument("--patch_gallery", action="store_true",
                   help="ViT-256 patch-level attention galleries for the "
                        "top ROI's patches (hipt_heatmap_utils.py:158-294)")
    p.add_argument("--vit256_ckpt", default=None)
    p.add_argument("--vit4k_ckpt", default=None)
    _add_device(p)


def _confirm(job) -> None:
    """Print every (nested) config entry, then gate on Y/N (reference:
    create_heatmaps.py:85-101)."""
    import dataclasses
    for key, value in dataclasses.asdict(job).items():
        if isinstance(value, dict):
            print("\n" + key)
            for vk, vv in value.items():
                print(f"{vk} : {vv}")
        else:
            print(f"\n{key} : {value}")
    decision = input("Continue? Y/N ")
    if decision in ("Y", "y", "Yes", "yes"):
        return
    if decision in ("N", "n", "No", "NO"):
        raise SystemExit(0)
    raise NotImplementedError(decision)


def _read_features(path: str) -> np.ndarray:
    if path.endswith(".pt"):
        from hipt_abmil_atec23_tpu_torch.data.bags import _load_pt
        return _load_pt(path)
    if path.endswith(".npy"):
        return np.load(path)
    import h5py
    with h5py.File(path) as f:
        return np.asarray(f["features"])


def _cmd_heatmap(a):
    if a.config:
        # config-driven batch mode (reference: create_heatmaps.py YAML)
        from hipt_abmil_atec23_tpu_torch.explain.driver import (
            HeatmapJobConfig, run_heatmap_job)
        job = HeatmapJobConfig.load(a.config)
        if a.confirm:
            _confirm(job)
        run_heatmap_job(job, device=a.device)
        return
    for req in ("slide", "coords_h5", "ckpt", "save_dir"):
        if getattr(a, req) is None:
            raise SystemExit(f"--{req} is required without --config")
    import cv2
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.explain.driver import (
        load_mil_head, require_pt)
    from hipt_abmil_atec23_tpu_torch.explain.heatmaps import (
        draw_heatmap, infer_attention, sample_rois, save_blockmap)
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu_torch.utils.config import ModelConfig

    require_pt(a.ckpt)
    device = resolve_device(a.device)
    os.makedirs(a.save_dir, exist_ok=True)
    coords, attrs = load_coords_h5(a.coords_h5)
    patch_size = int(attrs["patch_size"])
    patch_level = int(attrs.get("patch_level", 0))
    slide = open_slide(a.slide)
    sid = os.path.splitext(os.path.basename(a.slide))[0]

    if a.features:
        feats = _read_features(a.features)
    else:
        from hipt_abmil_atec23_tpu_torch.engine.encode import (
            build_encoder, encode_slide)
        from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig
        enc = build_encoder(EncoderConfig(model_type=a.encoder),
                            device=device)
        feats = encode_slide(slide, coords, enc, patch_level=patch_level,
                             region_size=patch_size)

    model = load_mil_head(a.ckpt, ModelConfig(model_type=a.model_type,
                                              model_size=a.model_size),
                          a.n_classes, feats.shape[1], device)
    scores = infer_attention(model, feats)
    save_blockmap(os.path.join(a.save_dir, f"{sid}_blockmap.h5"),
                  coords, scores)
    hm = draw_heatmap(slide, coords, scores, patch_size,
                      patch_level=patch_level, cmap=a.cmap, alpha=a.alpha)
    cv2.imwrite(os.path.join(a.save_dir, f"{sid}_heatmap.jpg"),
                cv2.cvtColor(hm, cv2.COLOR_RGB2BGR))
    rois = sample_rois(coords, scores, k=a.sample_topk)
    patches = slide.read_regions(rois["sampled_coords"], patch_level,
                                 (patch_size, patch_size))
    for j, (patch, score) in enumerate(zip(patches, rois["sampled_scores"])):
        cv2.imwrite(os.path.join(
            a.save_dir, f"{sid}_roi{j}_{score:.3f}.png"),
            cv2.cvtColor(patch, cv2.COLOR_RGB2BGR))
    if a.hierarchical or a.patch_gallery:
        _heatmap_galleries(a, device, slide, sid, rois, patch_size,
                           patch_level)
    slide.close()
    print(f"[heatmap] wrote heatmap + blockmap + {len(patches)} ROIs "
          f"to {a.save_dir}")


def _heatmap_galleries(a, device, slide, sid, rois, patch_size,
                       patch_level):
    """Hierarchical / patch ViT-attention galleries for the top ROI regions,
    from HIPT_4K in f32 with no kernel flags (as the JAX CLI builds it):
    the DINO checkpoints when both are given, else seeded random weights."""
    import torch
    from hipt_abmil_atec23_tpu_torch.explain.hierarchical import (
        hierarchical_gallery, patch_gallery)
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        load_dino_, load_torch_state_dict)
    from hipt_abmil_atec23_tpu_torch.models.hipt import (
        center_crop_multiple, make_hipt_encoder)

    hipt = make_hipt_encoder(torch.float32,
                             generator=torch.Generator().manual_seed(0))
    if a.vit256_ckpt and a.vit4k_ckpt:
        load_dino_(hipt, load_torch_state_dict(a.vit256_ckpt),
                   load_torch_state_dict(a.vit4k_ckpt))
    hipt = hipt.to(device).eval()
    out_dir = os.path.join(a.save_dir, "galleries")
    k = min(a.hier_regions, len(rois["sampled_coords"]))
    regions = slide.read_regions(rois["sampled_coords"][:k], patch_level,
                                 (patch_size, patch_size))
    for j, reg in enumerate(regions):
        reg = center_crop_multiple(reg, 256)
        if a.hierarchical:
            hierarchical_gallery(reg, hipt, out_dir, f"{sid}_roi{j}",
                                 mode=a.hier_mode, alpha=a.alpha)
        if a.patch_gallery and j == 0:
            patch_gallery(reg[:256, :256], hipt.vit256, out_dir,
                          f"{sid}_roi{j}_patch", mode="concat",
                          alpha=a.alpha)
    print(f"[heatmap] galleries for {k} ROI regions -> {out_dir}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="hipt_abmil_atec23_tpu_torch",
        description="WSI MIL pipeline on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_tile, _add_encode, _add_train, _add_eval, _add_splits,
                _add_bootstrap, _add_count, _add_serve, _add_heatmap):
        add(sub)
    a = parser.parse_args(argv)
    {"tile": _cmd_tile, "encode": _cmd_encode, "train": _cmd_train,
     "eval": _cmd_eval, "splits": _cmd_splits, "bootstrap": _cmd_bootstrap,
     "count": _cmd_count, "serve": _cmd_serve,
     "heatmap": _cmd_heatmap}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
