"""The port's command line: the tile, encode, train, eval, splits,
bootstrap, count, serve, heatmap, knn, export and parity stages.

    python -m hipt_abmil_atec23_tpu_torch.cli <tile|encode|train|eval|splits|
                                               bootstrap|count|serve|heatmap|
                                               knn|export|parity> [flags]

Each subcommand takes the JAX package's flags (hipt_abmil_atec23_tpu/cli.py)
and writes the same artifacts, so either package reads what the other wrote:
coords h5s, masks and stitches under the tile stage's save_dir, feature bags
in the reference layout under feat_dir, split CSVs, fold CSVs, summaries and
the experiment settings, the serve journal and results, heatmaps,
blockmaps, ROIs and attention galleries, tuning results. Checkpoints are
the reference's ``s_{fold}_checkpoint.pt``; ``eval``, ``serve`` and
``heatmap`` also load the JAX package's flax ``.msgpack`` heads, and
``export`` turns one into the reference's ``.pt``. ``--device`` picks the
card (``cuda``, the default) or the CPU (``cpu``). Every encoder of the JAX
package (HIPT_4K, vit256, resnet50, resnet18, levit_128s, levit_256) runs
in ``encode``, ``serve``, ``heatmap`` and online training (``train
--extract_features``). DRAS sampling runs in ``train --sampling`` and
``eval --use_sampling`` (host loop or ``--device_sampling``, spatial or
textural, precomputed bags or ``--eval_features``; ``--tune_sampling``
searches its parameters first). ``train --tuning`` searches
hyperparameters (ASHA, ``--trial_parallel`` for stacked lr / reg trials),
``train --fold_parallel`` trains every fold at once, and ``parity`` chains
tile -> encode -> splits -> train -> bootstrap against the reference's
headline AUC.
"""
from __future__ import annotations

import argparse
import contextlib
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


def _add_trace(p):
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run "
                        "(trace.json) and the program's spans "
                        "(spans.jsonl) to DIR")


def _traced(a):
    """The run's --trace context: utils/logging.trace, or nothing."""
    if not a.trace:
        return contextlib.nullcontext()
    from hipt_abmil_atec23_tpu_torch.utils.logging import trace
    return trace(a.trace)


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
    _add_trace(p)
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
    with _traced(a):
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


def _add_sampling(p, cmd: str) -> None:
    """The DRAS flags (reference: main.py:358-371; eval.py's sampling
    path); train adds the update rule, the full-bag epochs and the grid
    initial sample."""
    p.add_argument("--sampling_type", default="spatial",
                   choices=["spatial", "textural"])
    p.add_argument("--texture_model", default="resnet50",
                   choices=["resnet50", "levit_128s"],
                   help="kNN space for textural sampling: resnet50 reuses "
                        "the MIL feature bags, levit_128s loads a second "
                        "feature store (reference: main.py:366, "
                        "sampling_utils.py:51-63)")
    p.add_argument("--texture_feat_dir", default=None,
                   help="feature dir holding levit_128s texture bags "
                        "(reference: data_root_dir/levit_128s)")
    p.add_argument("--sampling_average", action="store_true",
                   help="use the running-average weight update instead of "
                        "max (reference: main.py:367)")
    p.add_argument("--device_sampling", action="store_true",
                   help="run each slide's DRAS loop on the device with no "
                        "host synchronisation inside it (statistically "
                        "equivalent draws, not the reference's RNG stream)")
    p.add_argument("--samples_per_iteration", type=int, default=100)
    p.add_argument("--resampling_iterations", type=int, default=10)
    p.add_argument("--sampling_random", type=float, default=0.2)
    p.add_argument("--sampling_random_delta", type=float, default=0.02)
    p.add_argument("--sampling_neighbors", type=int, default=20)
    p.add_argument("--final_sample_size", type=int, default=100)
    p.add_argument("--weight_smoothing", type=float, default=0.15)
    p.add_argument("--fully_random", action="store_true")
    if cmd == "train":
        p.add_argument("--sampling_update", default="max",
                       choices=["max", "average", "newest", "none"])
        p.add_argument("--no_sampling_epochs", type=int, default=20)
        p.add_argument("--grid_sample", action="store_true")


def _sampling_cfg(a):
    from hipt_abmil_atec23_tpu_torch.engine.sampling import SamplingConfig
    extra = {}
    if hasattr(a, "sampling_update"):
        extra = dict(sampling_update=a.sampling_update,
                     no_sampling_epochs=a.no_sampling_epochs,
                     grid_initial_sample=a.grid_sample)
    return SamplingConfig(
        sampling_type=a.sampling_type, sampling_average=a.sampling_average,
        samples_per_iteration=a.samples_per_iteration,
        resampling_iterations=a.resampling_iterations,
        sampling_random=a.sampling_random,
        sampling_random_delta=a.sampling_random_delta,
        sampling_neighbors=a.sampling_neighbors,
        final_sample_size=a.final_sample_size,
        weight_smoothing=a.weight_smoothing, fully_random=a.fully_random,
        device_loop=a.device_sampling, **extra)


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
                   choices=["clam_sb", "clam_mb", "mil", "gigapath_slide"],
                   help="gigapath_slide is refused: it serves and "
                        "evaluates only (ROADMAP F.6)")
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
    _add_trace(p)
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
    # DRAS active sampling (reference: main.py:358-371)
    p.add_argument("--sampling", action="store_true")
    _add_sampling(p, "train")
    # hyperparameter tuning (reference: main.py --tuning)
    p.add_argument("--tuning", action="store_true")
    p.add_argument("--num_tuning_samples", type=int, default=20)
    p.add_argument("--tuning_output_file", default=None)
    p.add_argument("--checkpoint_trials", action="store_true",
                   help="per-epoch train-state checkpoints per trial "
                        "(reference: tune.checkpoint_dir saves, "
                        "core_utils_tuning.py:235-240)")
    p.add_argument("--resume_tuning", action="store_true",
                   help="skip trials already in the tuning results CSV "
                        "(reference: Tuner.restore, main.py:259-263)")
    p.add_argument("--grace_period", type=int, default=8)
    p.add_argument("--trial_parallel", action="store_true",
                   help="lr / reg trials as one stacked run (torch.func."
                        "vmap); architecture fixed across trials")
    p.add_argument("--fold_parallel", action="store_true",
                   help="train every fold at once (stacked heads), folds "
                        "split over the process group's ranks when it has "
                        "more than one and they divide k")
    _add_device(p)


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
                          epoch_chunk=a.epoch_chunk,
                          fold_parallel=a.fold_parallel))


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
    if a.model_type == "gigapath_slide":
        raise SystemExit(
            "train: gigapath_slide is not trainable on the port yet: its "
            "dilated-attention kernel has no backward pass (ROADMAP F.6). "
            "serve and eval take it with a released or exported .pt")
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    device = resolve_device(a.device)
    cfg = _train_cfg(a)
    manifest = SlideManifest.from_csv(a.csv_path, cfg.task.label_dict,
                                      ignore=cfg.task.ignore)
    store = FeatureBagStore(a.feat_dir)
    if a.debug_loader:
        _debug_loader(cfg, manifest, store)
        return

    def run():
        if a.tuning:
            _train_tuning(a, cfg, manifest, store, device)
            return
        if a.sampling:
            _train_sampling(a, cfg, manifest, store, device)
            return
        if a.extract_features:
            _train_online(a, cfg, manifest, device)
            return
        if a.full_bag_sharded:
            _train_full_bags(cfg, manifest, store, device)
            return
        if a.fold_parallel:
            _train_fold_parallel(cfg, manifest, store, device)
            return
        from hipt_abmil_atec23_tpu_torch.engine.experiment import run_cv
        summary, _ = run_cv(cfg, manifest, store, device=device)
        print(summary)

    with _traced(a):
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


def _train_tuning(a, cfg, manifest, store, device) -> None:
    """Hyperparameter search on fold 0 (reference: main.py --tuning):
    ASHA over DEFAULT_SEARCH_SPACE through train_fold, or with
    --trial_parallel lr / reg trials as one stacked run."""
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.engine.tune import write_rows
    folds = make_fold_datasets(manifest, store, cfg, 0)
    out_csv = a.tuning_output_file or os.path.join(cfg.results_dir,
                                                   "tuning_results.csv")
    os.makedirs(cfg.results_dir, exist_ok=True)
    if a.trial_parallel:
        from hipt_abmil_atec23_tpu_torch.engine.tune import (
            LogUniform, sample_configs)
        from hipt_abmil_atec23_tpu_torch.engine.tune_parallel import (
            run_trials_parallel)
        space = {"lr": LogUniform(1e-5, 1e-2), "reg": LogUniform(1e-5, 1e-1)}
        trials = sample_configs(space, a.num_tuning_samples, cfg.train.seed)
        lrs = np.array([t["lr"] for t in trials], np.float32)
        regs = np.array([t["reg"] for t in trials], np.float32)
        res = run_trials_parallel(cfg, folds, manifest.class_counts(), lrs,
                                  regs, device=device)
        last10 = res.val_loss[:, -10:].mean(1)
        write_rows(out_csv, [{"lr": lr, "reg": reg, "last10_val_loss": v}
                             for lr, reg, v in zip(res.lr, res.reg, last10)])
        print(f"[tune] best: lr={res.best_lr:.2e} reg={res.best_reg:.2e}")
        return
    from hipt_abmil_atec23_tpu_torch.engine.tune import run_tuning
    best, _, _ = run_tuning(cfg, folds, manifest.class_counts(),
                            num_samples=a.num_tuning_samples,
                            grace_period=a.grace_period, output_csv=out_csv,
                            checkpoint_trials=a.checkpoint_trials,
                            resume=a.resume_tuning, device=device)
    print(f"[tune] best config: {best}")


def _train_fold_parallel(cfg, manifest, store, device) -> None:
    """Every fold at once (parallel/fold_parallel.py). Under a launcher
    with more than one rank (torchrun) the folds split over the process
    group's ranks when the world size divides k; otherwise each rank
    trains them all. Rank 0 alone writes summary.csv."""
    import pandas as pd
    import torch.distributed as dist
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.parallel.fold_parallel import (
        train_folds_parallel)
    k = cfg.train.k
    folds = [make_fold_datasets(manifest, store, cfg, f) for f in range(k)]
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from hipt_abmil_atec23_tpu_torch.parallel.multihost import (
            init_multihost)
        init_multihost(device=device)
    mesh = None
    if dist.is_initialized():
        world = dist.get_world_size()
        if world > 1 and k % world == 0:
            from hipt_abmil_atec23_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh([("fold", world)], device.type)
    res = train_folds_parallel(cfg, folds, manifest.class_counts(), mesh,
                               device=device)
    if dist.is_initialized() and dist.get_rank():
        return
    summary = pd.DataFrame({"folds": np.arange(k), **res.summary})
    os.makedirs(cfg.results_dir, exist_ok=True)
    summary.to_csv(os.path.join(cfg.results_dir, "summary.csv"), index=False)
    print(summary)


def _train_sampling(a, cfg, manifest, store, device) -> None:
    """DRAS training across folds (engine/sampling.train_fold_sampling);
    spatial coords come from the h5 feature bags."""
    import pandas as pd
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        _write_fold_csv, fold_range, make_fold_datasets, summary_csv_name)
    from hipt_abmil_atec23_tpu_torch.engine.sampling import (
        train_fold_sampling)
    scfg = _sampling_cfg(a)
    coords_lookup = {}
    for sid in manifest.slide_ids:
        try:
            _, coords = store.load_with_coords(sid)
        except (FileNotFoundError, KeyError, OSError):
            raise SystemExit(
                f"--sampling needs h5 feature bags with coords "
                f"(missing for {sid}); encode with h5 output")
        coords_lookup[sid] = coords
    texture_lookup = _build_texture_lookup(a, manifest.slide_ids)
    rows = []
    for fold in fold_range(cfg):
        tr, va, te = make_fold_datasets(manifest, store, cfg, fold)
        res = train_fold_sampling(
            cfg, scfg, fold, tr, va, te, manifest.class_counts(),
            coords_lookup=coords_lookup, texture_lookup=texture_lookup,
            device=device)
        _write_fold_csv(cfg.results_dir, res)
        rows.append({"folds": fold, "test_auc": res.test_auc,
                     "val_auc": res.val_auc, "test_acc": res.test_acc,
                     "val_acc": res.val_acc})
    summary = pd.DataFrame(rows)
    summary.to_csv(os.path.join(cfg.results_dir, summary_csv_name(cfg)),
                   index=False)
    print(summary)


def _build_texture_lookup(a, slide_ids):
    """slide_id -> [N, Dt] LeViT texture features for textural DRAS.

    Reference semantics (sampling_utils.py:51-63): texture_model=resnet50
    reuses the MIL feature bags as the kNN space (the bag itself,
    downstream); levit_128s loads a SECOND pre-extracted feature store
    (reference: core_utils_sampling.py:327-337 reads
    data_root_dir/levit_128s). Returns None unless that second store is
    needed."""
    if a.sampling_type != "textural" or a.texture_model != "levit_128s":
        return None
    if not a.texture_feat_dir:
        raise SystemExit(
            "--sampling_type textural with --texture_model levit_128s needs "
            "--texture_feat_dir (encode the slides with the levit encoder "
            "first: cli encode --model_type levit_128s)")
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    tstore = FeatureBagStore(a.texture_feat_dir)
    lookup = {}
    for sid in slide_ids:
        try:
            lookup[sid] = tstore.load_features(sid)
        except (FileNotFoundError, KeyError, OSError):
            raise SystemExit(f"texture feature bag missing for {sid!r} "
                             f"under {a.texture_feat_dir}")
    return lookup


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
    p.add_argument("--model_type", default="clam_sb",
                   help="clam_sb, clam_mb, mil or gigapath_slide (whole "
                        "bags with the h5 store's coords, fold .pt)")
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--drop_out", type=float, default=0.0)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--folds", type=int, nargs="*", default=None)
    p.add_argument("--max_patches_per_slide", type=int, default=75)
    p.add_argument("--seed", type=int, default=1)
    # inference-time DRAS sampling (reference: eval.py --use_sampling path)
    p.add_argument("--use_sampling", action="store_true")
    _add_sampling(p, "eval")
    p.add_argument("--tune_sampling", action="store_true",
                   help="search DRAS sampling params on the val split first "
                        "(reference: eval.py:172-227)")
    p.add_argument("--num_tuning_samples", type=int, default=10)
    # on-the-fly extraction of only the sampled patches
    # (reference: --eval_features, eval_utils.py:231-260)
    p.add_argument("--eval_features", action="store_true")
    p.add_argument("--data_slide_dir", default=None)
    p.add_argument("--data_h5_dir", default=None,
                   help="tile-stage coords dir (required for --eval_features)")
    p.add_argument("--eval_encoder", default="resnet50", choices=ENCODERS,
                   help="encoder for --eval_features")
    p.add_argument("--resnet_ckpt", default=None)
    p.add_argument("--vit256_ckpt", default=None)
    p.add_argument("--vit4k_ckpt", default=None)
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
    store = FeatureBagStore(a.feat_dir)
    if a.use_sampling:
        _eval_with_sampling(a, cfg, manifest, store, device)
        return
    run_eval(cfg, manifest, store, a.models_dir, a.save_dir,
             splits=a.splits, folds=a.folds, device=device)


def _resolve_slide_paths(slide_dir: str, slide_ids) -> dict:
    """slide_id -> file path; matches any supported slide extension."""
    from hipt_abmil_atec23_tpu_torch.slideio.pipeline import SLIDE_EXTS
    out = {}
    for sid in slide_ids:
        for ext in SLIDE_EXTS:
            p = os.path.join(slide_dir, sid + ext)
            if os.path.exists(p):
                out[sid] = p
                break
        else:
            raise FileNotFoundError(
                f"no slide file for {sid!r} in {slide_dir} "
                f"(tried {SLIDE_EXTS})")
    return out


def _eval_with_sampling(a, cfg, manifest, store, device) -> None:
    """DRAS inference-time evaluation (reference: eval.py sampling path +
    eval_utils.summary_sampling): per fold, the fold's head (.pt, else the
    JAX package's .msgpack) classifies each slide's DRAS bag
    (engine/sampling.eval_sampling); with --tune_sampling the sampling
    parameters are searched on the first fold's val split first. Writes
    fold_k.csv and summary.csv (and sampling_tuning.csv) as the JAX CLI
    does."""
    import dataclasses
    import pandas as pd
    from hipt_abmil_atec23_tpu_torch.data.bags import BagDataset
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import fold_ckpt
    from hipt_abmil_atec23_tpu_torch.engine.experiment import (
        make_fold_datasets)
    from hipt_abmil_atec23_tpu_torch.engine.sampling import eval_sampling
    from hipt_abmil_atec23_tpu_torch.explain.driver import load_mil_head

    scfg = _sampling_cfg(a)
    texture_lookup = _build_texture_lookup(a, manifest.slide_ids)
    os.makedirs(a.save_dir, exist_ok=True)
    folds = a.folds if a.folds else list(range(cfg.train.k))
    # honor --splits like the plain eval path (reference eval.py evaluates
    # the chosen split in its sampling mode too)
    fold_te = {}
    for fold in folds:
        if a.splits == "all":
            fold_te[fold] = BagDataset(manifest.slide_ids, manifest.labels,
                                       store, cfg.bags)
        else:
            tr, va, te = make_fold_datasets(manifest, store, cfg, fold)
            fold_te[fold] = {"train": tr, "val": va, "test": te}[a.splits]

    feature_lookup = None
    coords_lookup = {}
    if a.eval_features:
        # encode only the sampled patches on the fly; open only the slides
        # the requested folds evaluate
        if not (a.data_slide_dir and a.data_h5_dir):
            raise SystemExit("--eval_features requires --data_slide_dir and "
                             "--data_h5_dir")
        from hipt_abmil_atec23_tpu_torch.data.online import (
            build_feature_gathers)
        from hipt_abmil_atec23_tpu_torch.engine.encode import build_encoder
        from hipt_abmil_atec23_tpu_torch.utils.config import EncoderConfig
        needed = sorted({sid for te in fold_te.values()
                         for sid in te.slide_ids})
        slide_paths = _resolve_slide_paths(a.data_slide_dir, needed)
        encoder = build_encoder(EncoderConfig(
            model_type=a.eval_encoder, resnet_ckpt=a.resnet_ckpt,
            vit256_ckpt=a.vit256_ckpt, vit4k_ckpt=a.vit4k_ckpt),
            device=device)
        coords_dir = os.path.join(a.data_h5_dir, "patches")
        if not os.path.isdir(coords_dir):
            coords_dir = a.data_h5_dir
        feature_lookup = build_feature_gathers(slide_paths, coords_dir,
                                               encoder, needed)
        coords_lookup = {sid: g.coords for sid, g in feature_lookup.items()}
    else:
        for sid in manifest.slide_ids:
            _, coords_lookup[sid] = store.load_with_coords(sid)
    bags_full = dataclasses.replace(cfg.bags, max_patches_per_slide=0)
    if a.tune_sampling:
        if feature_lookup is not None:
            raise SystemExit("--tune_sampling needs precomputed features; "
                             "drop --eval_features or encode first")
        # search the sampling parameters on the first fold's val split
        # (reference: eval.py:172-227 tunes at eval time)
        from hipt_abmil_atec23_tpu_torch.engine.tune import (
            sampling_config_of, tune_sampling_params)
        _, va0, _ = make_fold_datasets(manifest, store, cfg, folds[0])
        va_ds = BagDataset(va0.slide_ids, va0.labels, store, bags_full)
        model0 = load_mil_head(fold_ckpt(a.models_dir, folds[0]), cfg.model,
                               cfg.task.n_classes,
                               va_ds._full_bag(va_ds.slide_ids[0]).shape[1],
                               device)
        best, _ = tune_sampling_params(
            cfg, va_ds, model0, coords_lookup=coords_lookup,
            num_samples=a.num_tuning_samples,
            output_csv=os.path.join(a.save_dir, "sampling_tuning.csv"),
            device=device)
        print(f"[eval-sampling] tuned params: {best}")
        scfg = sampling_config_of(best, scfg)
    rows = []
    try:
        for fold in folds:
            te = fold_te[fold]
            ds = BagDataset(te.slide_ids, te.labels, store, bags_full)
            feat_dim = (feature_lookup[ds.slide_ids[0]].shape[1]
                        if feature_lookup is not None
                        else ds._full_bag(ds.slide_ids[0]).shape[1])
            model = load_mil_head(fold_ckpt(a.models_dir, fold), cfg.model,
                                  cfg.task.n_classes, feat_dim, device)
            probs, counts = eval_sampling(
                cfg, scfg, ds, model, coords_lookup=coords_lookup,
                texture_lookup=texture_lookup, seed=cfg.train.seed + fold,
                feature_lookup=feature_lookup,
                device_loop=a.device_sampling, device=device)
            auc = M.auc_score(ds.labels, probs, cfg.task.n_classes)
            rows.append({"folds": fold, "test_auc": auc,
                         "test_acc": M.accuracy(ds.labels, probs.argmax(1)),
                         "mean_patches_used": float(counts.mean())})
            df = pd.DataFrame({"slide_id": ds.slide_ids, "Y": ds.labels,
                               "Y_hat": probs.argmax(1)})
            for c in range(cfg.task.n_classes):
                df[f"p_{c}"] = probs[:, c]
            df.to_csv(os.path.join(a.save_dir, f"fold_{fold}.csv"),
                      index=False)
            print(f"[eval-sampling] fold {fold}: auc {auc:.4f}")
    finally:
        for g in (feature_lookup or {}).values():
            g.slide.close()
    pd.DataFrame(rows).to_csv(os.path.join(a.save_dir, "summary.csv"),
                              index=False)


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


def _add_knn(sub):
    p = sub.add_parser("knn", help="slide-level kNN probe over aggregated "
                       "features (reference: HIPT_knn.py)")
    p.add_argument("--task", default="treatment")
    p.add_argument("--csv_path", required=True)
    p.add_argument("--feat_dir", required=True)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--agg", default="mean",
                   choices=["mean", "max", "hipt_lgp"])
    p.add_argument("--lgp_ckpt", default=None,
                   help="HIPT_LGP_FC torch checkpoint for --agg hipt_lgp "
                        "(reference: HIPT_knn.py:14 external HIPT repo)")
    p.add_argument("--seed", type=int, default=1)
    _add_device(p)


def _cmd_knn(a):
    from hipt_abmil_atec23_tpu_torch.data.bags import FeatureBagStore
    from hipt_abmil_atec23_tpu_torch.data.manifest import SlideManifest
    from hipt_abmil_atec23_tpu_torch.data.splits import generate_kfold_splits
    from hipt_abmil_atec23_tpu_torch.data.tasks import get_task
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.engine.knn_probe import knn_cv_probe
    device = resolve_device(a.device)
    task = get_task(a.task)
    manifest = SlideManifest.from_csv(a.csv_path, task.label_dict)
    store = FeatureBagStore(a.feat_dir)
    splits = generate_kfold_splits(manifest.labels, a.folds, seed=a.seed)
    lgp_state = None
    if a.lgp_ckpt:
        from hipt_abmil_atec23_tpu_torch.models.convert import (
            load_torch_state_dict)
        lgp_state = load_torch_state_dict(a.lgp_ckpt, checkpoint_key=None)
    out = knn_cv_probe(store, manifest, splits, k=a.k,
                       temperature=a.temperature, method=a.agg,
                       lgp_state=lgp_state, device=device)
    print(json.dumps(out, indent=2))


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
                   help="MIL checkpoint (reference-layout torch .pt; any "
                        "other name is a flax checkpoint)")
    p.add_argument("--model_type", default="clam_sb",
                   help="clam_sb, clam_mb, mil or gigapath_slide (scored "
                        "with the tiles' coords; its width is the "
                        "encoder's)")
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
    _add_trace(p)
    _add_device(p)


def _cmd_serve(a):
    from hipt_abmil_atec23_tpu_torch.engine.serve import (
        ServeConfig, ServeState, serve_forever, serve_once, write_config)
    from hipt_abmil_atec23_tpu_torch.utils.config import (
        EncoderConfig, ModelConfig, SegConfig, TileConfig)
    from hipt_abmil_atec23_tpu_torch.models.abmil import check_model_type
    # refused before serving starts: the daemon logs a failed drain and
    # polls on, so this would otherwise never stop it
    check_model_type(a.model_type)
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
    with _traced(a):
        if a.once:
            recs = serve_once(cfg, ServeState(device=a.device))
        else:
            n = serve_forever(cfg, device=a.device, max_drains=a.max_drains)
    if a.once:
        n_done = sum(1 for r in recs if r.get("status") == "done")
        print(f"[serve] drained {len(recs)} slides "
              f"({n_done} scored, {len(recs) - n_done} failed_seg)")
    else:
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
                   help="MIL checkpoint (reference-layout torch .pt; any "
                        "other name is a flax checkpoint)")
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
    from hipt_abmil_atec23_tpu_torch.explain.driver import load_mil_head
    from hipt_abmil_atec23_tpu_torch.explain.heatmaps import (
        draw_heatmap, infer_attention, sample_rois, save_blockmap)
    from hipt_abmil_atec23_tpu_torch.slideio.patching import load_coords_h5
    from hipt_abmil_atec23_tpu_torch.slideio.reader import open_slide
    from hipt_abmil_atec23_tpu_torch.utils.config import ModelConfig

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


def _add_export(sub):
    p = sub.add_parser("export", help="export a flax MIL checkpoint to "
                       "the reference's torch s_k_checkpoint.pt layout")
    p.add_argument("--ckpt", required=True, help="msgpack fold checkpoint")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--model_type", default="clam_sb",
                   choices=["clam_sb", "clam_mb"])
    p.add_argument("--model_size", default="hipt_smaller")
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--drop_out", type=float, default=0.0,
                   help="match the reference model's dropout flag so the "
                        "attention module index lines up (eval_utils.py:44)")
    _add_device(p)


def _cmd_export(a):
    """The JAX CLI's export (cli.py:1132-1170) without flax: the checkpoint
    read by engine/flax_ckpt.py, checked against the head it names (a
    strict state-dict load), bridged to the reference layout."""
    # host work only: --device is taken for a uniform command line
    import torch
    from hipt_abmil_atec23_tpu_torch.engine.flax_ckpt import load_params
    from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
    from hipt_abmil_atec23_tpu_torch.models.convert import (
        mil_state_dict_from_jax)
    sd = mil_state_dict_from_jax(load_params(a.ckpt), a.model_type,
                                 a.n_classes, with_dropout=a.drop_out > 0)
    build_mil_model(a.model_type, size_arg=a.model_size,
                    n_classes=a.n_classes, dropout=a.drop_out
                    ).load_state_dict(sd)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    torch.save(sd, a.out)
    print(f"[export] {a.ckpt} -> {a.out} ({len(sd)} tensors, reference "
          f"CLAM layout; loads via eval.py --models_exp_code)")


def _add_parity(sub):
    p = sub.add_parser(
        "parity", help="one-command real-weights AUC parity recipe: "
        "tile -> encode (HIPT_4K from the released DINO ckpts) -> splits "
        "-> k-fold train -> bootstrap, then compare the bootstrap AUC to "
        "the reference headline 0.6462 +/- 0.0328 "
        "(reference: docs/README.md:92, extract_features_fp.py:214)")
    p.add_argument("--slide_dir", required=True)
    p.add_argument("--csv_path", required=True,
                   help="dataset CSV (slide_id + label columns, the "
                        "reference's dataset_csv contract)")
    p.add_argument("--vit256_ckpt", required=True,
                   help="e.g. ckpts/vit256_small_dino.pth")
    p.add_argument("--vit4k_ckpt", required=True,
                   help="e.g. ckpts/vit4k_xs_dino.pth")
    p.add_argument("--work_dir", required=True,
                   help="all intermediates land here (tiles/ feats/ "
                        "splits/ results/); every stage skips work that "
                        "already exists, so the recipe is resumable")
    p.add_argument("--task", default="treatment")
    p.add_argument("--target_auc", type=float, default=0.6462)
    p.add_argument("--target_std", type=float, default=0.0328)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--slide_ext", default=".svs")
    p.add_argument("--region_size", type=int, default=4096,
                   help="HIPT region edge (reference: hipt_4k.py 4096px "
                        "two-stage input)")
    p.add_argument("--encode_batch_size", type=int, default=8)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--min_epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_patches_per_slide", type=int, default=75)
    p.add_argument("--bootstraps", type=int, default=100_000)
    p.add_argument("--use_otsu", action="store_true")
    p.add_argument("--a_t", type=int, default=100)
    p.add_argument("--strict", action="store_true",
                   help="exit 1 when the AUC lands outside the combined "
                        "one-std band")
    p.add_argument("--extra_train_args", default="",
                   help="extra flags appended verbatim to the train stage "
                        "(e.g. '--no_inst_cluster --bag_loss ce')")
    _add_device(p)


def parity_stages(a) -> List[List[str]]:
    """The JAX CLI's parity stages (cli.py:1240-1335), each with this
    run's --device appended."""
    tiles = os.path.join(a.work_dir, "tiles")
    feats = os.path.join(a.work_dir, "feats")
    splits = os.path.join(a.work_dir, "splits")
    results = os.path.join(a.work_dir, "results")
    stages = [
        ["tile", "--source", a.slide_dir, "--save_dir", tiles,
         "--patch_size", str(a.region_size), "--step_size",
         str(a.region_size), "--a_t", str(a.a_t)]
        + (["--use_otsu"] if a.use_otsu else []),
        ["encode", "--data_h5_dir", tiles, "--data_slide_dir", a.slide_dir,
         "--csv_path", a.csv_path, "--feat_dir", feats, "--model_type",
         "HIPT_4K", "--vit256_ckpt", a.vit256_ckpt, "--vit4k_ckpt",
         a.vit4k_ckpt, "--slide_ext", a.slide_ext, "--batch_size",
         str(a.encode_batch_size)],
        ["splits", "--task", a.task, "--csv_path", a.csv_path,
         "--split_dir", splits, "--k", str(a.k), "--seed", str(a.seed)],
        ["train", "--task", a.task, "--csv_path", a.csv_path, "--feat_dir",
         feats, "--results_dir", results, "--exp_code", "parity",
         "--split_dir", splits, "--k", str(a.k), "--seed", str(a.seed),
         "--lr", str(a.lr), "--max_epochs", str(a.max_epochs),
         "--min_epochs", str(a.min_epochs), "--max_patches_per_slide",
         str(a.max_patches_per_slide)] + a.extra_train_args.split(),
    ]
    return [argv + ["--device", a.device] for argv in stages]


def _cmd_parity(a):
    """Chains the port's own stages in-process; each prints the equivalent
    standalone command, so a failed stage can be rerun or tweaked by hand.
    Writes parity_summary.json beside them."""
    from hipt_abmil_atec23_tpu_torch.engine.evaluate import (
        bootstrap_from_fold_csvs)
    os.makedirs(a.work_dir, exist_ok=True)
    for argv in parity_stages(a):
        print("[parity] stage: python -m hipt_abmil_atec23_tpu_torch.cli "
              + " ".join(argv), flush=True)
        rc = main(argv)
        if rc:
            raise SystemExit(rc)
    results = os.path.join(a.work_dir, "results")
    out = bootstrap_from_fold_csvs([results], list(range(a.k)),
                                   n_bootstraps=a.bootstraps, seed=0,
                                   device=a.device)
    auc, std = out["auc"]["mean"], out["auc"]["std"]
    band = a.target_std + std
    ok = abs(auc - a.target_auc) <= band
    with open(os.path.join(a.work_dir, "parity_summary.json"), "w") as f:
        json.dump({"auc": auc, "auc_std": std,
                   "target_auc": a.target_auc, "target_std": a.target_std,
                   "within_band": bool(ok), "bootstrap": out}, f, indent=2)
    print(f"[parity] bootstrap AUC {auc:.4f} +/- {std:.4f} vs reference "
          f"{a.target_auc:.4f} +/- {a.target_std:.4f} "
          f"(|delta| = {abs(auc - a.target_auc):.4f}, combined one-std "
          f"band = {band:.4f}) -> {'WITHIN BAND' if ok else 'OUTSIDE BAND'}")
    if a.strict and not ok:
        raise SystemExit(1)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="hipt_abmil_atec23_tpu_torch",
        description="WSI MIL pipeline on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_tile, _add_encode, _add_train, _add_eval, _add_splits,
                _add_bootstrap, _add_count, _add_serve, _add_heatmap,
                _add_knn, _add_export, _add_parity):
        add(sub)
    a = parser.parse_args(argv)
    {"tile": _cmd_tile, "encode": _cmd_encode, "train": _cmd_train,
     "eval": _cmd_eval, "splits": _cmd_splits, "bootstrap": _cmd_bootstrap,
     "count": _cmd_count, "serve": _cmd_serve,
     "heatmap": _cmd_heatmap, "knn": _cmd_knn, "export": _cmd_export,
     "parity": _cmd_parity}[a.cmd](a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
