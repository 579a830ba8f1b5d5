"""Observability: metrics logging and profiling helpers.

Counterpart of hipt_abmil_atec23_tpu/utils/logging.py. The reference logs
scalars to tensorboardX behind --log_data (reference: utils/
core_utils.py:126-128, 365-371) and profiles with cProfile (main.py:
514-521). Here:

- ``MetricsLogger`` writes JSONL (always greppable) and mirrors to
  tensorboardX where it imports;
- ``trace()`` wraps a block in ``torch.profiler`` (CPU and, on a card,
  CUDA activity) and writes a Chrome trace;
- ``StageTimer`` keeps per-stage wall times and items-per-hour counts
  (create_patches_fp.py:211-227, extract_features_fp.py:247).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._fh = None
        self._tb = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir, flush_secs=15)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step),
                                   "time": time.time()}) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a block; writes ``log_dir/trace.json`` (a
    Chrome trace of the host and, where a card is visible, the device
    timeline)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Named wall-clock accumulators with an items-per-hour readout."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, stage: str, items: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] = self.totals.get(stage, 0.0) + \
                (time.perf_counter() - t0)
            self.counts[stage] = self.counts.get(stage, 0) + items

    def per_item(self, stage: str) -> float:
        return self.totals.get(stage, 0.0) / max(1, self.counts.get(stage, 0))

    def items_per_hour(self, stage: str) -> float:
        t = self.totals.get(stage, 0.0)
        return self.counts.get(stage, 0) / t * 3600.0 if t > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {s: {"total_s": self.totals[s], "count": self.counts[s],
                    "per_item_s": self.per_item(s),
                    "per_hour": self.items_per_hour(s)}
                for s in self.totals}
