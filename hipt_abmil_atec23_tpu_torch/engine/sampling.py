"""DRAS-MIL: attention-guided active patch sampling.

Counterpart of hipt_abmil_atec23_tpu/engine/sampling.py (reference:
utils/sampling_utils.py, utils/core_utils_sampling.py): approximate
full-slide inference and training by iteratively sampling patches, scoring
them with the MIL attention head, propagating the scores to spatial or
textural neighbours, and resampling from the updated weights.

- The host loop (``dras_sample_slide``) keeps the reference's numpy draws:
  ``generate_sample_idxs`` and ``update_sampling_weights`` are the JAX
  package's numpy code, so one ``numpy.random.Generator`` gives both
  packages the same samples, draw for draw.
- ``knn_indices`` is a brute-force distance matrix on the caller's device
  (JAX's f32 formula, a true-f32 product), its ties broken by index as
  ``lax.top_k`` breaks them: lower index first.
- Subset attention (``make_attention_fn``): a gated single-branch CLAM head
  scores a subset through ``gated_attention_pool`` (the pool kernel on the
  card, its plain version on the CPU), any other attention head through its
  own ``forward(attention_only=True)``.
- The device loop (``dras_sample_slide_device``) is a loop of device ops
  with no host synchronisation inside it: Gumbel-top-k draws from a device
  ``torch.Generator`` over the epsilon-greedy mixture, the 'max' update as
  a scatter. It matches the host loop in distribution, not bit for bit
  (docs/COMPONENT_MAP.md divergence 7).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from hipt_abmil_atec23_tpu_torch.device import true_f32

SAMPLING_UPDATES = ("max", "average", "newest", "none")


@dataclass
class SamplingConfig:
    """Flags mirror the reference CLI (reference: main.py:359-371)."""
    sampling_type: str = "spatial"       # spatial | textural
    samples_per_iteration: int = 100
    resampling_iterations: int = 10
    sampling_random: float = 0.2
    sampling_random_delta: float = 0.02
    sampling_neighbors: int = 20
    final_sample_size: int = 100
    weight_smoothing: float = 0.15       # 'power'
    sampling_update: str = "max"
    no_sampling_epochs: int = 20
    fully_random: bool = False
    grid_initial_sample: bool = False
    sampling_average: bool = False
    device_loop: bool = False            # dras_sample_slide_device

    def __post_init__(self):
        # reference parity: --sampling_average overrides the update mode to
        # 'average' (core_utils_sampling.py:314-317, eval_utils.py:197)
        if self.sampling_average:
            self.sampling_update = "average"


def generate_sample_idxs(n: int, previous: Sequence[int],
                         weights: Optional[np.ndarray],
                         samples_per_iteration: int, num_random: int,
                         rng: np.random.Generator,
                         grid: bool = False,
                         coords: Optional[np.ndarray] = None) -> List[int]:
    """Weighted + epsilon-random sample, optionally grid-stratified initial
    sample (reference: generate_sample_idxs, sampling_utils.py:11-48)."""
    if grid:
        assert coords is not None and len(coords) > 0
        splits = int(math.sqrt(samples_per_iteration))
        xs, ys = coords[:, 0], coords[:, 1]
        xb = np.linspace(xs.min(), xs.max() + 1e-5, splits + 1)
        yb = np.linspace(ys.min(), ys.max() + 1e-5, splits + 1)
        cell = (np.searchsorted(xb, xs, side="right") - 1) * (splits + 1) + \
            (np.searchsorted(yb, ys, side="right") - 1)
        idxs: List[int] = []
        for c in np.unique(cell):
            members = np.flatnonzero(cell == c)
            idxs.append(int(rng.choice(members)))
        if len(idxs) < samples_per_iteration:
            extra = rng.choice(n, samples_per_iteration - len(idxs),
                               replace=False)
            idxs.extend(int(e) for e in extra)
        return idxs[:samples_per_iteration]

    nonrandom: List[int] = []
    n_weighted = int(samples_per_iteration - num_random)
    if n_weighted > 0:
        # no-repeat zeroing can exhaust the weighted pool on small bags
        # (weights stay unnormalized between iterations, so the sum can hit
        # exactly 0); cap at the drawable entries, top-up happens below
        s = weights.sum()
        drawable = int(np.count_nonzero(weights)) if s > 0 else 0
        k_w = min(n_weighted, drawable)
        if k_w > 0:
            nonrandom = list(rng.choice(n, size=k_w, replace=False,
                                        p=weights / s))
        num_random += n_weighted - k_w
    if num_random > 0:
        # np.setdiff1d(np.arange(n), taken) by a mask: the same sorted
        # array in O(n) (the sort was most of a 100k-patch iteration)
        taken = np.zeros(n, bool)
        taken[np.asarray(list(previous) + nonrandom, dtype=int)] = True
        available = np.flatnonzero(~taken)
        k = min(num_random, len(available))
        return list(rng.choice(available, k, replace=False)) + nonrandom
    return nonrandom


def update_sampling_weights(weights: np.ndarray, attention: np.ndarray,
                            all_sample_idxs: Sequence[int],
                            neighbor_idxs: np.ndarray, neighbors: int,
                            power: float = 0.15, normalise: bool = True,
                            sampling_update: str = "max",
                            repeats_allowed: bool = False) -> np.ndarray:
    """Propagate attention to k nearest neighbors and fold into the weights
    (reference: update_sampling_weights, sampling_utils.py:66-187), as
    vectorized scatters."""
    assert sampling_update in SAMPLING_UPDATES
    weights = np.asarray(weights, np.float64).copy()
    if sampling_update != "none":
        nbr = np.asarray(neighbor_idxs)[:, :neighbors]       # [S, k]
        flat = nbr.ravel()
        rep = np.repeat(np.asarray(attention, np.float64), nbr.shape[1])
        new = np.zeros(len(weights))
        if sampling_update == "max":
            np.maximum.at(new, flat, rep)
            new = np.power(new, power)
            weights = np.maximum(weights, new)
        elif sampling_update == "average":
            # the reference's order-dependent running pairwise average
            # new = (prev + attn) / 2 in visit order (sampling_utils.py:
            # 76-83); S * k is small, so the host loop is cheap
            attn64 = np.asarray(attention, np.float64)
            for i in range(nbr.shape[0]):
                for index in nbr[i]:
                    if new[index] > 0:
                        new[index] = (new[index] + attn64[i]) / 2
                    else:
                        new[index] = attn64[i]
            touched = new > 0
            new = np.power(new, power)
            weights[touched] = new[touched]
        elif sampling_update == "newest":
            new[flat] = rep  # last write wins, like the reference loop order
            touched = np.zeros(len(weights), bool)
            touched[flat] = True
            weights[touched] = np.power(new[touched], power)
    if not repeats_allowed and len(all_sample_idxs):
        weights[np.asarray(list(all_sample_idxs), int)] = 0.0
    if normalise:
        s = weights.sum()
        if s > 0:
            weights = weights / s
        else:
            weights = np.full_like(weights, 1.0 / len(weights))
    return weights


def _sq_dists(X: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[S, N] squared distances in the JAX package's f32 formula
    |q|^2 - 2 q.x^T + |x|^2 (sampling.py:164)."""
    with true_f32():
        return (torch.sum(q * q, 1)[:, None] - 2.0 * q @ X.T
                + torch.sum(X * X, 1)[None])


def knn_indices(X, queries, k: int, device="cuda") -> torch.Tensor:
    """Exact kNN of ``queries`` among all rows of ``X`` ([S, k] indices on
    X's device, nearest first), with ``lax.top_k``'s tie order: of equal
    distances the lower index comes first, at the k-th boundary too, as a
    stable sort of the [S, N] distances gives them (replaces ball_tree,
    reference: core_utils_sampling.py:408). A tensor ``X`` stays on its
    device; an array goes to ``device``."""
    if isinstance(X, torch.Tensor):
        x = X.to(torch.float32)
    else:
        from hipt_abmil_atec23_tpu_torch.device import resolve_device
        x = torch.as_tensor(np.asarray(X, np.float32),
                            device=resolve_device(device))
    q = torch.as_tensor(queries, dtype=torch.float32, device=x.device)
    return torch.sort(_sq_dists(x, q), dim=1, stable=True).indices[:, :k]


@dataclass
class DrasResult:
    final_idxs: np.ndarray
    weights: np.ndarray
    all_sampled: List[int]

    @property
    def bag_idxs(self) -> np.ndarray:
        """The bag actually trained/classified on: the final weighted draw
        PLUS every patch sampled along the way (reference --use_all_samples,
        its only implemented path: core_utils_sampling.py:449-454,
        eval_utils.py:462-465). The final draw alone would systematically
        exclude every high-attention patch the loop already found, because
        sampled indices are zero-weighted."""
        return np.concatenate([np.asarray(self.final_idxs, int),
                               np.asarray(self.all_sampled, int)])


def _take(features, idxs):
    """Rows ``idxs`` of an ndarray, a tensor (on its device) or a lazy
    source with ``take(idxs, axis=0)``."""
    if isinstance(features, torch.Tensor):
        return features[torch.as_tensor(np.asarray(idxs, np.int64),
                                        device=features.device)]
    return features.take(np.asarray(idxs, dtype=int), axis=0)


def _knn_space(features, coords, cfg: SamplingConfig, texture_features,
               device) -> torch.Tensor:
    """The rows kNN runs over, f32 on ``device``: the coords (spatial), the
    texture features, or the bag itself (textural without them)."""
    if cfg.sampling_type == "spatial":
        X = coords
    elif texture_features is not None:
        X = texture_features
    elif isinstance(features, (np.ndarray, torch.Tensor)):
        X = features
    else:
        raise ValueError("textural sampling over a lazy feature source "
                         "requires texture_features")
    if isinstance(X, torch.Tensor):
        return X.to(device, torch.float32)
    return torch.as_tensor(np.asarray(X, np.float32), device=device)


def dras_sample_slide(
    features,                      # [N, D] full bag, or any lazy source
    coords: np.ndarray,            # [N, 2]
    attention_fn: Callable,        # subset -> [n] scores
    cfg: SamplingConfig,
    rng: np.random.Generator,
    texture_features=None,
    device="cuda",
) -> DrasResult:
    """The per-slide DRAS loop (reference: core_utils_sampling.py:302-512 /
    eval_utils.py summary_sampling): initial (grid or random) sample ->
    attention -> kNN propagate -> weighted + epsilon-random resample, for
    ``resampling_iterations``; returns the final weighted sample.

    ``features`` is an ndarray, a tensor, or anything with ``len()`` and
    ``take(idxs, axis=0)``, such as OnlineFeatureGather, which encodes
    only the patches actually sampled (reference: --eval_features,
    eval_utils.py:231-260). The kNN space lives on ``device``; the draws
    and the weights stay on the host."""
    n = len(features)
    if cfg.fully_random or n <= cfg.final_sample_size:
        k = min(cfg.final_sample_size, n)
        return DrasResult(final_idxs=rng.choice(n, k, replace=False),
                          weights=np.full(n, 1.0 / n), all_sampled=[])

    X = _knn_space(features, coords, cfg, texture_features, device)
    # reference floor: weights start at the constant 1e-4, NOT 1/n
    # (core_utils_sampling.py:420); weights stay unnormalized between
    # iterations, so the attention**power-vs-floor comparison depends on the
    # absolute fill value whenever n != 10^4.
    weights = np.full(n, 1e-4)
    all_sampled: List[int] = []
    spi = min(cfg.samples_per_iteration, n)
    idxs = generate_sample_idxs(
        n, [], weights, spi, num_random=spi, rng=rng,
        grid=cfg.grid_initial_sample, coords=coords)
    sampling_random = cfg.sampling_random
    neighbors = min(cfg.sampling_neighbors, n)

    for it in range(cfg.resampling_iterations):
        all_sampled.extend(int(i) for i in idxs)
        sel = np.asarray(idxs, dtype=np.int64)
        attn = np.asarray(attention_fn(_take(features, sel)))
        q = X[torch.as_tensor(sel, device=X.device)]
        nbrs = knn_indices(X, q, neighbors).cpu().numpy()
        # normalise=False like every reference loop call site
        # (core_utils_sampling.py:429,446, eval_utils.py:404,460): draws
        # normalize transiently instead
        weights = update_sampling_weights(
            weights, attn, all_sampled, nbrs, neighbors,
            power=cfg.weight_smoothing, normalise=False,
            sampling_update=cfg.sampling_update)
        sampling_random = max(0.0, sampling_random - cfg.sampling_random_delta)
        num_random = int(spi * sampling_random)
        if it < cfg.resampling_iterations - 1:
            idxs = generate_sample_idxs(n, all_sampled, weights, spi,
                                        num_random, rng)

    k = min(cfg.final_sample_size, n)
    s = weights.sum()
    if s > 0:
        p = weights / s
    else:
        # degenerate: every patch already sampled and zero-weighted (tiny
        # slides); fall back to uniform - the bag is the union anyway
        p = np.full(n, 1.0 / n)
    nz = int((p > 0).sum())
    final = rng.choice(n, min(k, nz), replace=False, p=p)
    return DrasResult(final_idxs=final, weights=weights,
                      all_sampled=all_sampled)


# ---------------------------------------------------------------------------
# DRAS training / evaluation (reference: utils/core_utils_sampling.py:106-671,
# utils/eval_utils.py summary_sampling :180-566)
# ---------------------------------------------------------------------------

def subset_scores(model, bag: torch.Tensor) -> torch.Tensor:
    """Raw attention scores [n] of a subset [n, D] on the head's device: a
    gated single-branch CLAM pools it through ``gated_attention_pool``
    with no mask (the kernel on the card), any other CLAM head returns its
    first branch of ``forward(attention_only=True)``."""
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        gated_attention_pool, params_from_clam, pool_eligible)
    if pool_eligible(model):
        return gated_attention_pool(bag, params_from_clam(model))[1]
    if not hasattr(model, "attention_net"):
        raise ValueError(f"DRAS needs an attention head (clam_sb / clam_mb), "
                         f"not {type(model).__name__}")
    return model(bag, None, attention_only=True)[0]


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    from hipt_abmil_atec23_tpu_torch.ops.masking import masked_softmax
    return masked_softmax(scores[None], torch.ones_like(scores[None],
                                                        dtype=torch.bool),
                          dim=-1)[0]


def make_attention_fn(model):
    """``attention_fn(subset) -> [n]`` softmax attention (f32 numpy) of a
    subset (ndarray or tensor) under ``model``'s current weights, on its
    device. The JAX package pads subsets to one compiled shape and slices
    ``out[:n]``; here each subset goes as it is."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def attention_fn(subset) -> np.ndarray:
        if len(subset) == 0:
            return np.zeros(0, np.float32)
        bag = torch.as_tensor(subset, dtype=torch.float32).to(dev)
        return _softmax(subset_scores(model, bag)).cpu().numpy()

    return attention_fn


def _padded_bag(full, idxs, n_final: int, feat_dim: int, device):
    """Rows ``idxs`` of ``full`` in an [n_final, D] f32 bag on ``device``
    with its validity mask (the JAX package's static DRAS bag)."""
    sub = _take(full, idxs)
    sub = torch.as_tensor(sub, dtype=torch.float32).to(device)
    bag = torch.zeros((n_final, feat_dim), dtype=torch.float32,
                      device=device)
    bag[:len(sub)] = sub
    mask = torch.arange(n_final, device=device) < len(sub)
    return bag, mask


def train_fold_sampling(cfg, scfg: SamplingConfig, fold, train_ds, val_ds,
                        test_ds, class_counts, *, coords_lookup,
                        texture_lookup=None, verbose: bool = True,
                        device="cuda"):
    """Train one fold with DRAS active sampling after `no_sampling_epochs`
    full-bag epochs (reference: train_sampling, core_utils_sampling.py:
    106-299), on ``device``.

    coords_lookup: slide_id -> [N, 2] patch coords (spatial features).
    texture_lookup: slide_id -> [N, Dt] texture features (textural mode).

    ``host_rng(seed, fold)`` feeds the epoch orders, the bag draws and the
    host loop's DRAS draws in the JAX package's order. Dropout masks come
    from one seeded device generator (the JAX package folds its key per
    step), the device loop's draws from one per (epoch, slide). As
    ``train_fold``, ``continue_training`` starts from the fold's .pt."""
    from hipt_abmil_atec23_tpu_torch.data.bags import epoch_order
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        ckpt_path, load_params, save_params)
    from hipt_abmil_atec23_tpu_torch.engine.train import (
        EarlyStopper, FoldResult, _epoch_tensors, build_step_fns,
        evaluate_split)
    from hipt_abmil_atec23_tpu_torch.utils.seeding import (
        host_rng, torch_generator)

    tc = cfg.train
    feat_dim = train_ds._full_bag(train_ds.slide_ids[0]).shape[1]
    for ds in (train_ds, val_ds, test_ds):
        ds._feat_dim = feat_dim
    n_pad = max(train_ds.pad_size(), val_ds.pad_size(), test_ds.pad_size())
    fns = build_step_fns(cfg, class_counts, n_pad, feat_dim, device=device)
    model = fns.init_params(torch_generator(tc.seed, fold))
    os.makedirs(cfg.results_dir, exist_ok=True)
    cpath = ckpt_path(cfg.results_dir, fold)
    if tc.continue_training and os.path.exists(cpath):
        load_params(cpath, model)
    optimizer = fns.tx(model.parameters())
    dev = next(model.parameters()).device
    dropout_gen = torch_generator(tc.seed, fold, 1, device=dev)
    attention_fn = make_attention_fn(model)

    rng = host_rng(tc.seed, fold)
    stopper = EarlyStopper(tc.min_epochs, tc.patience, tc.stop_epoch) \
        if tc.early_stopping else None
    history = []
    n_final = _bag_cap(scfg)
    textures = texture_lookup or {}

    for epoch in range(tc.max_epochs):
        order = epoch_order(train_ds.labels, cfg.task.n_classes, rng,
                            tc.weighted_sample)
        if epoch < scfg.no_sampling_epochs:
            feats, mask, labels = _epoch_tensors(train_ds, order, 1, n_pad,
                                                 rng)
            train_loss, _, _ = fns.train_epoch(model, optimizer, feats, mask,
                                               labels, dropout_gen)
        else:
            # DRAS epoch: per slide, sample with the current model then take
            # one optimizer step on the final sample
            losses = []
            for si, idx in enumerate(order):
                sid = train_ds.slide_ids[idx]
                full = train_ds._full_bag(sid)
                if scfg.device_loop:
                    res = dras_sample_slide_device(
                        full, coords_lookup[sid], model, scfg,
                        torch_generator(tc.seed, fold,
                                        (epoch + 1) * 7919 + si, device=dev),
                        texture_features=textures.get(sid))
                else:
                    res = dras_sample_slide(
                        full, coords_lookup[sid], attention_fn, scfg, rng,
                        texture_features=textures.get(sid), device=dev)
                bag, mask = _padded_bag(full, res.bag_idxs, n_final,
                                        feat_dim, dev)
                lb = np.full((1, 1), train_ds.labels[idx], np.int32)
                bl, _, _ = fns.train_epoch(model, optimizer, bag[None, None],
                                           mask[None, None], lb, dropout_gen)
                losses.append(bl)
            train_loss = float(np.mean(losses))

        val_probs, val_loss = evaluate_split(fns, model, val_ds, n_pad, rng)
        val_auc = M.auc_score(val_ds.labels, val_probs, cfg.task.n_classes)
        history.append(dict(epoch=epoch, train_loss=train_loss,
                            val_loss=val_loss, val_auc=val_auc))
        if verbose:
            print(f"[dras fold {fold}] epoch {epoch} "
                  f"{'full' if epoch < scfg.no_sampling_epochs else 'sampled'}"
                  f": train {train_loss:.4f} val {val_loss:.4f} "
                  f"auc {val_auc:.4f}")
        if stopper is not None:
            if stopper.update(epoch, val_loss):
                save_params(cpath, model)
            if stopper.early_stop:
                break

    if stopper is not None and os.path.exists(cpath):
        load_params(cpath, model)
    else:
        save_params(cpath, model)

    val_probs, val_loss = evaluate_split(fns, model, val_ds, n_pad, rng)
    test_probs, test_loss = evaluate_split(fns, model, test_ds, n_pad, rng)
    return FoldResult(
        fold=fold,
        val_auc=M.auc_score(val_ds.labels, val_probs, cfg.task.n_classes),
        test_auc=M.auc_score(test_ds.labels, test_probs, cfg.task.n_classes),
        val_acc=M.accuracy(val_ds.labels, val_probs.argmax(1)),
        test_acc=M.accuracy(test_ds.labels, test_probs.argmax(1)),
        val_loss=val_loss, test_loss=test_loss,
        stopped_epoch=len(history) - 1, test_probs=test_probs,
        test_labels=test_ds.labels, test_slide_ids=list(test_ds.slide_ids),
        history=history)


def eval_sampling(cfg, scfg: SamplingConfig, ds, model, *,
                  coords_lookup, texture_lookup=None, seed: int = 0,
                  feature_lookup=None, device_loop: bool = False,
                  device="cuda"):
    """Sampling-based inference (reference: summary_sampling,
    eval_utils.py:180-566) on ``device``: per slide, DRAS-select a final
    sample and classify it through ``apply_pooled`` (the pool kernel on
    the card for a gated single-branch CLAM); returns per-slide probs and
    the number of patches each slide used.

    ``feature_lookup`` (slide_id -> lazy feature source with take/len)
    replaces precomputed bags with on-the-fly encoding of only the sampled
    patches (reference: --eval_features, eval_utils.py:231-260); it always
    takes the host loop, as in the JAX package. The host loop draws from
    ``default_rng(seed)``; the device loop from one device generator per
    slide."""
    from hipt_abmil_atec23_tpu_torch.device import resolve_device
    from hipt_abmil_atec23_tpu_torch.ops.gated_attention_pool import (
        apply_pooled)
    from hipt_abmil_atec23_tpu_torch.utils.seeding import torch_generator
    device = resolve_device(device)
    model = model.to(device).eval()
    rng = np.random.default_rng(seed)
    attention_fn = make_attention_fn(model)
    n_final = _bag_cap(scfg)
    if feature_lookup is not None:
        feat_dim = feature_lookup[ds.slide_ids[0]].shape[1]
    else:
        feat_dim = ds._full_bag(ds.slide_ids[0]).shape[1]
    textures = texture_lookup or {}

    probs = np.zeros((len(ds), cfg.task.n_classes), np.float32)
    sampled_counts = np.zeros(len(ds), np.int64)
    for i, sid in enumerate(ds.slide_ids):
        full = feature_lookup[sid] if feature_lookup is not None \
            else ds._full_bag(sid)
        if device_loop and feature_lookup is None:
            res = dras_sample_slide_device(
                full, coords_lookup[sid], model, scfg,
                torch_generator(seed, i, device=device),
                texture_features=textures.get(sid))
        else:
            res = dras_sample_slide(
                full, coords_lookup[sid], attention_fn, scfg, rng,
                texture_features=textures.get(sid), device=device)
        bag, mask = _padded_bag(full, res.bag_idxs, n_final, feat_dim,
                                device)
        with torch.no_grad():
            logits = apply_pooled(model, bag, mask).logits[0].cpu().numpy()
        e = np.exp(logits - logits.max())
        probs[i] = e / e.sum()
        sampled_counts[i] = len(set(res.all_sampled)) + len(res.final_idxs)
    return probs, sampled_counts


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def _bag_cap(scfg: SamplingConfig) -> int:
    """Static pad for the DRAS bag: final draw + everything sampled along
    the way (all_sampled <= iterations x samples_per_iteration)."""
    return _round8(scfg.final_sample_size
                   + scfg.resampling_iterations * scfg.samples_per_iteration)


# ---------------------------------------------------------------------------
# DRAS on the device: the whole resampling loop as device ops, with no host
# synchronisation until the result is read. The host variant above keeps
# exact reference RNG semantics; this one trades bitwise parity for one
# stream of launches. Divergence (documented): the reference's split draw
# (num_random uniform + the rest weighted, jointly without replacement)
# becomes a Gumbel-top-k draw over the per-iteration MIXTURE distribution -
# statistically equivalent epsilon-greedy exploration, different bits. The
# update is the 'max' rule whatever cfg.sampling_update says, as in the JAX
# package.
# ---------------------------------------------------------------------------

def _gumbel_topk(logp: torch.Tensor, k: int,
                 gen: torch.Generator) -> torch.Tensor:
    """k indices drawn without replacement with probabilities exp(logp):
    the top k of logp + Gumbel noise (uniforms kept off 0, so no -inf)."""
    u = torch.rand(logp.shape, generator=gen, device=logp.device)
    g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.topk(logp + g, k).indices


def _eps_schedule(cfg: SamplingConfig) -> List[float]:
    """The per-iteration random share (static, like the host loop's)."""
    eps, e = [], cfg.sampling_random
    for _ in range(cfg.resampling_iterations):
        eps.append(e)
        e = max(0.0, e - cfg.sampling_random_delta)
    return eps


def dras_sample_slide_device(
    features,                     # [N, D] ndarray or tensor
    coords,                       # [N, 2]
    model,
    cfg: SamplingConfig,
    generator: torch.Generator,
    texture_features=None,
) -> DrasResult:
    """DRAS for one slide on the device of ``generator`` (the head's):
    the bag, the kNN space, the weights and every draw stay there; the
    result is read once at the end. Nothing is cached between slides:
    ``params_from_clam`` keeps the pool's weights on the head, and the
    loop compiles nothing."""
    dev = generator.device
    feats = torch.as_tensor(features, dtype=torch.float32).to(dev)
    n = int(feats.shape[0])
    spi = min(cfg.samples_per_iteration, n)
    k_final = min(cfg.final_sample_size, n)
    neighbors = min(cfg.sampling_neighbors, n)
    X = _knn_space(feats, coords, cfg, texture_features, dev)
    with torch.no_grad():
        final, weights, sampled = _dras_device_loop(
            feats, X, model, n, spi, k_final, neighbors, _eps_schedule(cfg),
            float(cfg.weight_smoothing), generator)
    return DrasResult(
        final_idxs=final.cpu().numpy(),
        weights=weights.cpu().numpy(),
        all_sampled=[int(i) for i in np.flatnonzero(sampled.cpu().numpy())])


def _dras_device_loop(features, X, model, n, spi, k_final, neighbors, eps,
                      power, gen):
    """(final [k_final], weights [N] f32, sampled [N] bool), all on the
    device; every op is asynchronous (no .item(), no copy to the host, no
    branch on a device value)."""
    dev = X.device
    weights = torch.full((n,), 1e-4, device=dev)            # reference floor
    sampled = torch.zeros(n, dtype=torch.bool, device=dev)
    idxs = _gumbel_topk(torch.zeros(n, device=dev), spi, gen)  # uniform init
    for i, e in enumerate(eps):
        sampled.index_fill_(0, idxs, True)
        attn = _softmax(subset_scores(model, features.index_select(0, idxs)))
        # exact kNN of the sampled points among all rows of X
        nbrs = knn_indices(X, X.index_select(0, idxs), neighbors)  # [spi, k]
        # 'max' propagation: w[nbr] = max(w[nbr], attn_i^power) as a
        # scatter-max over zeros (softmax attention is >= 0), then zero
        # everything already sampled
        vals = (attn ** power)[:, None].expand(-1, neighbors).reshape(-1)
        prop = torch.zeros(n, device=dev).scatter_reduce_(
            0, nbrs.reshape(-1), vals, "amax")
        weights = torch.where(sampled, torch.zeros_like(weights),
                              torch.maximum(weights, prop))
        if i == len(eps) - 1:
            break  # the last pass scores its draw; nothing draws again
        # epsilon-greedy mixture draw without replacement (Gumbel top-k)
        wsum = weights.sum().clamp_min(1e-30)
        un = (~sampled).float()
        mix = (1.0 - e) * weights / wsum + e * un / un.sum().clamp_min(1.0)
        logp = torch.where(mix > 0, torch.log(mix.clamp_min(1e-30)),
                           torch.full_like(mix, -math.inf))
        idxs = _gumbel_topk(logp, spi, gen)
    # final weighted draw over ALL patches (reference normalizes once);
    # degenerate all-zero weights fall back to uniform like the host path
    logp = torch.where(weights > 0, torch.log(weights.clamp_min(1e-30)),
                       torch.full_like(weights, -math.inf))
    logp = torch.where(weights.sum() > 0, logp, torch.zeros_like(logp))
    return _gumbel_topk(logp, k_final, gen), weights, sampled
