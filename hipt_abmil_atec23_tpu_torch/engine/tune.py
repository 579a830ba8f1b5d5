"""Hyperparameter search: ASHA successive halving and plateau stopping.

Counterpart of hipt_abmil_atec23_tpu/engine/tune.py (reference: main.py:
40-268, Ray Tune's grid / loguniform spaces, ASHAScheduler on the
validation loss, TrialPlateauStopper at utils/tuning_utils.py:10-105, the
best configuration by the mean of the last 10 epochs' validation loss at
main.py:256-268), without Ray: each trial is the port's ``train_fold``
with an in-process scheduler whose ASHA rungs stop underperformers at
epoch milestones.

The search spaces draw from one ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages sample the same trials. Results are rows
of dicts written as CSV with the ``csv`` module (pandas' columns and number
formats), so tuning runs on a host without pandas.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# search spaces (reference: main.py:54-206)
# --------------------------------------------------------------------------

@dataclass
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclass
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclass
class Choice:
    values: Sequence[Any]

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]


@dataclass
class GridSearch:
    values: Sequence[Any]


# the reference's main tuning space (reference: main.py:95-106 style)
DEFAULT_SEARCH_SPACE: Dict[str, Any] = {
    "lr": LogUniform(1e-5, 1e-2),
    "reg": LogUniform(1e-5, 1e-1),
    "drop_out": Uniform(0.0, 0.9),
    "max_patches_per_slide": Choice([50, 75, 100, 150, 300]),
    "model_size": Choice(["hipt_smallest", "hipt_smaller", "hipt_small",
                          "hipt_medium", "hipt_big"]),
    "B": Choice([4, 8, 16]),
}


def sample_configs(space: Dict[str, Any], num_samples: int,
                   seed: int = 0) -> List[Dict[str, Any]]:
    """Random samples crossed with every GridSearch axis (Ray's rule: the
    grid is exhaustive per sample), in the JAX package's draw order."""
    rng = np.random.default_rng(seed)
    grid_axes = {k: v.values for k, v in space.items()
                 if isinstance(v, GridSearch)}
    rand_axes = {k: v for k, v in space.items()
                 if not isinstance(v, GridSearch)}

    def grid_product():
        if not grid_axes:
            yield {}
            return
        keys = list(grid_axes)
        idx = [0] * len(keys)
        while True:
            yield {k: grid_axes[k][i] for k, i in zip(keys, idx)}
            for j in range(len(keys) - 1, -1, -1):
                idx[j] += 1
                if idx[j] < len(grid_axes[keys[j]]):
                    break
                idx[j] = 0
            else:
                return

    configs = []
    for _ in range(num_samples):
        base = {k: v.sample(rng) for k, v in rand_axes.items()}
        for g in grid_product():
            configs.append({**base, **g})
    return configs


# --------------------------------------------------------------------------
# stoppers and the scheduler
# --------------------------------------------------------------------------

class TrialPlateauStopper:
    """Stop a trial when the metric's std over a window falls below ``std``
    (a plateau) or the windowed mean has risen ``num_results`` times in a
    row (reference: utils/tuning_utils.py:10-105, with the JAX package's
    mean-rise rule)."""

    def __init__(self, std: float = 0.001, num_results: int = 4,
                 grace_period: int = 4,
                 metric_threshold: Optional[float] = None,
                 mode: str = "min"):
        self.std = std
        self.num_results = num_results
        self.grace_period = grace_period
        self.metric_threshold = metric_threshold
        self.mode = mode
        self._values: List[float] = []
        self._prev_mean: Optional[float] = None
        self._rise_count = 0

    def __call__(self, value: float) -> bool:
        self._values.append(value)
        n = len(self._values)
        if n < self.grace_period or n < self.num_results:
            return False
        limit = self.metric_threshold
        if limit is not None:
            if self.mode == "min" and min(self._values) > limit:
                return True
            if self.mode == "max" and max(self._values) < limit:
                return True
        window = self._values[-self.num_results:]
        mean = float(np.mean(window))
        if float(np.std(window)) < self.std:
            return True
        if self._prev_mean is not None:
            rising = mean > self._prev_mean
            if (self.mode == "min" and rising) or \
               (self.mode == "max" and not rising):
                self._rise_count += 1
                if self._rise_count >= self.num_results:
                    return True
            else:
                self._rise_count = 0
        self._prev_mean = mean
        return False


class ASHAScheduler:
    """Asynchronous successive halving on epoch milestones (reference:
    ASHAScheduler(metric='loss', mode='min'), main.py:209-214): at rung r
    a trial stops when its value is worse than the 1 / reduction_factor
    quantile of every value the rung has seen, itself included."""

    def __init__(self, max_t: int = 100, grace_period: int = 8,
                 reduction_factor: int = 2, mode: str = "min"):
        self.mode = mode
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.reduction_factor = reduction_factor
        self._rung_records: Dict[int, List[float]] = {r: []
                                                      for r in self.rungs}

    def should_stop(self, epoch: int, value: float) -> bool:
        if epoch not in self._rung_records:
            return False
        rec = self._rung_records[epoch]
        rec.append(value)
        if len(rec) < self.reduction_factor:
            return False  # too few peers yet: let it go on
        q = 1.0 / self.reduction_factor
        cutoff = np.quantile(np.asarray(rec), q if self.mode == "min"
                             else 1 - q)
        return value > cutoff if self.mode == "min" else value < cutoff


# --------------------------------------------------------------------------
# rows as CSV (pandas' layout, without pandas)
# --------------------------------------------------------------------------

def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_rows(path: str, rows: List[Dict[str, Any]]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)``: columns in order
    of first appearance, floats as their repr, NaN empty."""
    cols: List[str] = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([_cell(r[k]) if k in r else "" for k in cols])


def _parse(s: str):
    if s == "":
        return float("nan")
    for kind in (int, float):
        try:
            return kind(s)
        except ValueError:
            pass
    return s


def read_rows(path: str) -> List[Dict[str, Any]]:
    """The rows ``write_rows`` (or pandas) wrote, numbers parsed."""
    with open(path, newline="") as f:
        return [{k: _parse(v) for k, v in r.items()}
                for r in csv.DictReader(f)]


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

@dataclass
class TrialResult:
    config: Dict[str, Any]
    history: List[Dict[str, float]]
    stopped_epoch: int
    best_metric: float
    last10_mean_loss: float


def apply_trial_config(cfg, trial: Dict[str, Any]):
    """The experiment configuration with a trial's fields in place
    (reference: core_utils_tuning.py:99-111)."""
    model, train, bags = cfg.model, cfg.train, cfg.bags
    for k, v in trial.items():
        if k in ("lr", "reg", "bag_weight"):
            train = dataclasses.replace(train, **{k: float(v)})
        elif k == "drop_out":
            model = dataclasses.replace(model, drop_out=float(v))
        elif k == "model_size":
            model = dataclasses.replace(model, model_size=str(v))
        elif k == "B":
            model = dataclasses.replace(model, k_sample=int(v))
        elif k == "max_patches_per_slide":
            bags = dataclasses.replace(bags, max_patches_per_slide=int(v))
        else:
            raise KeyError(f"unknown tunable {k!r}")
    return dataclasses.replace(cfg, model=model, train=train, bags=bags)


def _last10(losses) -> float:
    return float(np.mean(losses[-10:]))


def run_tuning(
    base_cfg,
    fold_datasets: Tuple,
    class_counts: np.ndarray,
    *,
    space: Optional[Dict[str, Any]] = None,
    num_samples: int = 20,
    max_epochs: Optional[int] = None,
    grace_period: int = 8,
    reduction_factor: int = 2,
    use_plateau_stopper: bool = True,
    seed: int = 0,
    output_csv: Optional[str] = None,
    verbose: bool = True,
    checkpoint_trials: bool = False,
    max_ckpts_to_keep: int = 2,
    resume: bool = False,
    device="cuda",
) -> Tuple[Dict[str, Any], List[Dict[str, Any]], List[TrialResult]]:
    """Search ``space`` with ``train_fold`` on fold 0's datasets, on
    ``device``; returns (best config, result rows, trials).

    The best configuration has the lowest mean validation loss over its
    last 10 epochs (reference: main.py:256-268). With ``checkpoint_trials``
    every trial keeps per-epoch train states under ``<trial_dir>/ckpts``
    (``TrainStateCheckpointer``, the newest ``max_ckpts_to_keep``), as the
    reference saves under Ray's checkpoint dir (core_utils_tuning.py:
    235-240). ``resume`` is Tuner.restore's analogue (main.py:259-263):
    the trials already in ``output_csv`` are read back (sampling is
    prefix-stable in the seed) and only the rest run; ASHA's rung records
    of the earlier process are not replayed."""
    from hipt_abmil_atec23_tpu_torch.engine.checkpoint import (
        TrainStateCheckpointer)
    from hipt_abmil_atec23_tpu_torch.engine.train import train_fold

    space = space or DEFAULT_SEARCH_SPACE
    configs = sample_configs(space, num_samples, seed)
    max_t = max_epochs or base_cfg.train.max_epochs
    asha = ASHAScheduler(max_t=max_t, grace_period=grace_period,
                         reduction_factor=reduction_factor)
    train_ds, val_ds, test_ds = fold_datasets

    trials: List[TrialResult] = []
    rows: List[Dict[str, Any]] = []
    done = 0
    if resume and output_csv and os.path.exists(output_csv):
        rows = read_rows(output_csv)
        done = len(rows)
        if verbose and done:
            print(f"[tune] resume: {done} completed trials from {output_csv}")
    for ti, trial in enumerate(configs):
        if ti < done:
            continue
        cfg = apply_trial_config(base_cfg, trial)
        cfg = dataclasses.replace(
            cfg, exp_code=f"{base_cfg.exp_code}_t{ti}",
            results_dir=os.path.join(base_cfg.results_dir, f"trial_{ti}"),
            train=dataclasses.replace(cfg.train, max_epochs=max_t,
                                      early_stopping=False))
        plateau = TrialPlateauStopper() if use_plateau_stopper else None

        def cb(epoch, rec, _plateau=plateau):
            val = rec["val_loss"]
            # True ends the trial's epoch loop (an ASHA kill or a plateau)
            return asha.should_stop(epoch, val) or \
                bool(_plateau and _plateau(val))

        ckptr = TrainStateCheckpointer(
            os.path.join(cfg.results_dir, "ckpts"),
            max_to_keep=max_ckpts_to_keep) if checkpoint_trials else None
        try:
            res = train_fold(cfg, 0, train_ds, val_ds, test_ds, class_counts,
                             verbose=False, log_cb=cb,
                             state_cb=ckptr.save if ckptr else None,
                             device=device)
        finally:
            if ckptr is not None:
                ckptr.close()
        hist = res.history
        losses = [h["val_loss"] for h in hist]
        last10 = _last10(losses)
        trials.append(TrialResult(config=trial, history=hist,
                                  stopped_epoch=len(hist) - 1,
                                  best_metric=float(np.min(losses)),
                                  last10_mean_loss=last10))
        rows.append({**trial, "epochs": len(hist),
                     "best_val_loss": float(np.min(losses)),
                     "last10_val_loss": last10,
                     "final_val_auc": hist[-1]["val_auc"]})
        if verbose:
            print(f"[tune] trial {ti}: {trial} -> last10 {last10:.4f} "
                  f"({len(hist)} epochs)")
        if output_csv:
            write_rows(output_csv, rows)

    # select over every row, resumed ones included; rows follow the
    # configs, but a resumed CSV may hold more rows than this call samples,
    # and then the CSV's own columns give the configuration
    best_idx = int(np.argmin([r["last10_val_loss"] for r in rows]))
    if best_idx < len(configs):
        best = configs[best_idx]
    else:
        best = {k: rows[best_idx][k] for k in space if k in rows[best_idx]}
    return best, rows, trials


# --------------------------------------------------------------------------
# the sampling-parameter search at evaluation (reference: eval.py:172-227
# tunes DRAS parameters with Ray at evaluation time)
# --------------------------------------------------------------------------

SAMPLING_SEARCH_SPACE: Dict[str, Any] = {
    "weight_smoothing": LogUniform(1e-4, 0.5),
    "resampling_iterations": Choice([2, 4, 6, 8, 10, 12, 16]),
    "sampling_neighbors": Choice([4, 8, 16, 32, 64]),
    "sampling_random": Uniform(0.25, 0.95),
    "sampling_random_delta": LogUniform(1e-4, 0.5),
}
_INT_SAMPLING_KEYS = ("resampling_iterations", "sampling_neighbors")


def sampling_config_of(trial: Dict[str, Any], base=None):
    """A SamplingConfig with ``trial``'s fields in place (over ``base``,
    else the defaults), the integer fields as ints."""
    from hipt_abmil_atec23_tpu_torch.engine.sampling import SamplingConfig
    fields = {k: int(v) if k in _INT_SAMPLING_KEYS else float(v)
              for k, v in trial.items()}
    return SamplingConfig(**fields) if base is None \
        else dataclasses.replace(base, **fields)


def tune_sampling_params(
    cfg, ds, model, *, coords_lookup,
    space: Optional[Dict[str, Any]] = None,
    num_samples: int = 20, seed: int = 0,
    output_csv: Optional[str] = None, verbose: bool = True,
    device="cuda",
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Search DRAS sampling parameters for the eval AUC of the head
    ``model`` on ``ds`` (as a rule a validation split), trial ``ti`` through
    ``eval_sampling`` with seed ``seed + ti`` on ``device`` (the pool kernel
    on the card). Returns (best parameters, rows)."""
    from hipt_abmil_atec23_tpu_torch.engine import metrics as M
    from hipt_abmil_atec23_tpu_torch.engine.sampling import eval_sampling

    space = space or SAMPLING_SEARCH_SPACE
    configs = sample_configs(space, num_samples, seed)
    rows: List[Dict[str, Any]] = []
    best, best_auc = None, -1.0
    for ti, trial in enumerate(configs):
        probs, counts = eval_sampling(cfg, sampling_config_of(trial), ds,
                                      model, coords_lookup=coords_lookup,
                                      seed=seed + ti, device=device)
        auc = M.auc_score(ds.labels, probs, cfg.task.n_classes)
        rows.append({**trial, "auc": auc,
                     "mean_patches": float(counts.mean())})
        if auc > best_auc:
            best, best_auc = trial, auc
        if verbose:
            print(f"[tune-sampling] {ti}: auc {auc:.4f} {trial}")
        if output_csv:
            write_rows(output_csv, rows)
    return best, rows
