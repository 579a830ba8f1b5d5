"""Observability: metrics logging and profiling helpers.

Counterpart of hipt_abmil_atec23_tpu/utils/logging.py. The reference logs
scalars to tensorboardX behind --log_data (reference: utils/
core_utils.py:126-128, 365-371) and profiles with cProfile (main.py:
514-521). Here:

- ``MetricsLogger`` writes JSONL (always greppable) and mirrors to
  tensorboardX where it imports;
- ``trace()`` wraps a block in ``torch.profiler`` (CPU and, on a card,
  CUDA activity) and writes a Chrome trace and the program's spans;
- ``span_start()`` / ``span_end()`` record a span at a layer boundary of
  the slide stream and of scoring (engine/encode.py, engine/serve.py,
  models/longnet.py), only while a ``torch.profiler`` runs;
- ``count_event()`` records a program counter (a tuple of numbers, such
  as a forward's attention pairs by branch) the same way.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Sequence, Tuple

from torch.autograd import profiler as _profiler


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


class Span(NamedTuple):
    """One stretch of host work at a layer boundary. ``start_ns`` and
    ``end_ns`` are on ``time.time_ns()``, the clock torch.profiler stamps
    device events with, so a span can be laid against the device's idle
    gaps. ``slide`` (the job index in a stream) and ``batch`` (the
    stream's batch index, shared by a batch's worker and main-loop spans)
    tie it to its cause, -1 where there is none; ``rows`` are the items or
    bag rows it handled and ``px`` their pixels (0 where none apply)."""
    name: str
    start_ns: int
    end_ns: int
    thread: str
    slide: int
    batch: int
    rows: int
    px: int


# The spans of the running profiler. The profiler is one per process, and
# so is this list: the stream's worker thread appends to it too (a list's
# append needs no lock).
_SPANS: List[Span] = []


def span_start() -> int:
    """The start of a span: the clock while a torch.profiler runs, else 0
    (no clock is read)."""
    return time.time_ns() if _profiler._is_profiler_enabled else 0


def span_end(t0: int, name: str, slide: int = -1, batch: int = -1,
             rows: int = 0, item_px: int = 0) -> int:
    """Record the span ``name`` begun at ``t0`` (``span_start()``'s value;
    0 records nothing), ``px = rows * item_px``. Returns the end, the start
    of a span that follows on at once, or 0 once the profiler has
    stopped."""
    if not t0:
        return 0
    t1 = time.time_ns()
    _SPANS.append(Span(name, t0, t1, threading.current_thread().name, slide,
                       batch, rows, rows * item_px))
    return t1 if _profiler._is_profiler_enabled else 0


class Count(NamedTuple):
    """One program counter: ``values`` at ``time_ns`` (``time.time_ns()``,
    the spans' clock)."""
    name: str
    time_ns: int
    values: Tuple[float, ...]


_COUNTS: List[Count] = []


def recording() -> bool:
    """True while a torch.profiler runs, when spans and counters are
    recorded: a caller computes a counter's values only then."""
    return _profiler._is_profiler_enabled


def count_event(name: str, values: Sequence[float]) -> None:
    """Record the counter ``name`` while a torch.profiler runs; nothing
    otherwise."""
    if _profiler._is_profiler_enabled:
        _COUNTS.append(Count(name, time.time_ns(), tuple(values)))


def recorded_counts() -> List[Count]:
    """Every counter recorded since the last ``clear_spans()``."""
    return _COUNTS


def recorded_spans() -> List[Span]:
    """Every span recorded since the last ``clear_spans()``, in the order
    they ended."""
    return _SPANS


def clear_spans() -> None:
    _SPANS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a block; writes ``log_dir/trace.json`` (a
    Chrome trace of the host and, where a card is visible, the device
    timeline) and ``log_dir/spans.jsonl`` (the spans the block recorded,
    on the same clock), and ``log_dir/counts.jsonl`` where it recorded
    program counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for s in _SPANS:
            f.write(json.dumps(s._asdict()) + "\n")
    if _COUNTS:
        with open(os.path.join(log_dir, "counts.jsonl"), "w") as f:
            for c in _COUNTS:
                f.write(json.dumps(c._asdict()) + "\n")
