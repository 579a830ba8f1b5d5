"""Host spans and the device trace of a ``--trace 1`` run.

Host spans are the benchmark's own, around its calls into each layer of the
port (``stream``, ``score``, ...) and the store's reads (``read``): name,
start and end on ``time.time_ns``, the clock that torch.profiler stamps its
events with, so the device's idle gaps can be laid against them. The
device side is torch.profiler with CUDA activity only: every kernel,
memcpy and memset on the card, read back as raw events.
"""
from __future__ import annotations

import contextlib
import re
import time
from bisect import bisect_right
from typing import Dict, List, Tuple

Interval = Tuple[int, int]


class Spans:
    """Host spans, kept in memory: (name, start_ns, end_ns)."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation that ran on the card."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def _union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """The device events of a traced window [t0_ns, t1_ns], clipped to it,
    with the sums the per-layer readers take."""

    def __init__(self, events: List[Tuple[str, int, int]], t0: int,
                 t1: int):
        self.t0, self.t1 = t0, t1
        inside = [(n, max(s, t0), min(e, t1)) for n, s, e in events
                  if e > t0 and s < t1]
        if events and len(inside) < 0.5 * len(events):
            raise RuntimeError(
                f"only {len(inside)} of {len(events)} device events lie in "
                "the traced window: the profiler's clock and the host's "
                "disagree")
        self.events = inside
        self.busy = _union([(s, e) for _, s, e in inside])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.events if rx.search(n)) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for n, s, e in self.events:
            by[n] = by.get(n, 0) + e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in top]

    def idle_gaps(self) -> List[Interval]:
        gaps, at = [], self.t0
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def idle_by_host(self, spans: List[Tuple[str, int, int]],
                     k: int = 10) -> List[List]:
        """Idle device seconds by what the host was doing: each stretch of
        a gap is named by the host spans open over it (names joined by
        '+', sorted), or 'host' where none was."""
        cuts = {self.t0, self.t1}
        for _, s, e in spans:
            cuts.update((min(max(s, self.t0), self.t1),
                         min(max(e, self.t0), self.t1)))
        for s, e in self.idle_gaps():
            cuts.update((s, e))
        edges = sorted(cuts)
        # open span names over each elementary stretch [edges[i], edges[i+1])
        delta: Dict[int, List[Tuple[str, int]]] = {}
        for name, s, e in spans:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                delta.setdefault(s, []).append((name, 1))
                delta.setdefault(e, []).append((name, -1))
        gaps = self.idle_gaps()
        starts = [s for s, _ in gaps]
        live: Dict[str, int] = {}
        out: Dict[str, int] = {}
        for a, b in zip(edges, edges[1:]):
            for name, d in delta.get(a, ()):
                live[name] = live.get(name, 0) + d
            g = bisect_right(starts, a) - 1
            if g < 0 or gaps[g][1] < b:
                continue  # the device is busy over [a, b)
            label = "+".join(sorted(n for n, c in live.items() if c > 0)) \
                or "host"
            out[label] = out.get(label, 0) + b - a
        top = sorted(out.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in top]

