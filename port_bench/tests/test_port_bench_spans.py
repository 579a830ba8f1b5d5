"""The readers of the port's program spans (metrics/stream_read_ms_per_mpx,
stream_pin_ms_per_mpx, idle_wait_read, idle_dispatch, idle_score) on a
synthetic device trace and synthetic spans: each value by hand, the three
idle shares disjoint and within ``device_idle``, and None where no span
fell in the window or the program records none."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hipt_abmil_atec23_tpu_torch.utils import logging as obs  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.trace import DeviceTrace  # noqa: E402

IDLE = ("idle_wait_read", "idle_dispatch", "idle_score")
PER_MPX = ("stream_read_ms_per_mpx", "stream_pin_ms_per_mpx")


def reader(base):
    return harness.load_module(harness.metric_path(base + ".hipt4k"),
                               "m_" + base)


def span(name, s, e, px=0, thread="MainThread"):
    return obs.Span(name, s, e, thread, 0, 0, 0, px)


# window [0, 1000] ns; the card busy over [100, 300] and [500, 900], idle
# over [0, 100], [300, 500] and [900, 1000]
TRACE = DeviceTrace([("k", 100, 300), ("k", 500, 900)], 0, 1000)
SPANS = [
    span("encode.read", 0, 400, px=10 ** 6, thread="w"),
    span("encode.read", 2000, 3000, px=10 ** 6, thread="w"),  # outside
    span("encode.pin", 400, 500, px=10 ** 6, thread="w"),
    span("encode.pin", 500, 600, px=10 ** 6, thread="w"),
    span("encode.wait", 50, 150),           # idle 50
    span("encode.h2d", 150, 200),           # busy
    span("encode.dispatch", 200, 350),      # idle 50
    span("encode.collect", 350, 400),       # idle 50
    span("serve.pad", 400, 450),            # idle 50
    span("serve.h2d", 450, 480),            # idle 30
    span("serve.pool", 480, 520),           # idle 20
]


@pytest.fixture
def spans(monkeypatch):
    got = []
    monkeypatch.setattr(obs, "recorded_spans", lambda: got)
    return got


def ctx(trace=TRACE):
    return SimpleNamespace(trace=trace, window_s=trace.window_s)


def test_values_by_hand(spans):
    spans.extend(SPANS)
    # 400 ns of reads over 1 Mpx (the read past the window left out);
    # 200 ns of pins over 2 Mpx
    assert reader("stream_read_ms_per_mpx").read(ctx()) == pytest.approx(
        4e-4, rel=1e-12)
    assert reader("stream_pin_ms_per_mpx").read(ctx()) == pytest.approx(
        1e-4, rel=1e-12)
    want = {"idle_wait_read": 5.0, "idle_dispatch": 10.0, "idle_score": 10.0}
    for base, v in want.items():
        assert reader(base).read(ctx()) == pytest.approx(v, rel=1e-12), base
    dev = harness.load_module(harness.metric_path("device_idle.hipt4k"),
                              "m_device_idle").read(ctx())
    assert dev == pytest.approx(40.0, rel=1e-12)


def test_idle_shares_are_disjoint(spans):
    """Back-to-back main-loop spans, as the stream and scoring record
    them, over a random device timeline: the three shares add up to the
    idle under any of their spans, and to no more than device_idle."""
    rng = np.random.default_rng(5)
    names = ["encode.wait", "encode.h2d", "encode.dispatch",
             "encode.collect", "serve.pad", "serve.h2d", "serve.pool"]
    at = 0
    for name in rng.choice(names, 400):
        d = int(rng.integers(1, 50))
        spans.append(span(str(name), at, at + d))
        at += d + int(rng.integers(0, 5))
    starts = np.sort(rng.integers(0, at, 300))
    events = [("k", int(s), int(s + rng.integers(1, 40))) for s in starts]
    trace = DeviceTrace(events, 0, at)
    shares = [reader(b).read(ctx(trace)) for b in IDLE]
    union = dict(trace.idle_by_host(
        [("open", s.start_ns, s.end_ns) for s in spans])).get("open", 0.0)
    assert sum(shares) == pytest.approx(100 * union / trace.window_s,
                                        rel=1e-9)
    device_idle = 100 * (1 - trace.busy_s / trace.window_s)
    assert sum(shares) <= device_idle + 1e-9
    assert all(v > 0 for v in shares)


def test_nothing_in_the_window(spans):
    spans.extend([span(s.name, s.start_ns + 5000, s.end_ns + 5000, s.px)
                  for s in SPANS])
    for base in IDLE + PER_MPX:
        assert reader(base).read(ctx()) is None, base
    spans.clear()
    for base in IDLE + PER_MPX:
        assert reader(base).read(ctx()) is None, base


def test_a_program_without_spans(monkeypatch):
    """A parent without the recorder: every reader returns None."""
    monkeypatch.delattr(obs, "recorded_spans")
    for base in IDLE + PER_MPX:
        assert reader(base).read(ctx()) is None, base
