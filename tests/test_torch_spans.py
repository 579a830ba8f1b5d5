"""The port's program spans (utils/logging.py span_start / span_end) in
engine/encode.encode_stream and engine/serve._mil_bucketed: one span of
each kind per batch (per bag in scoring), their ids across the worker and
the main loop, main-loop spans that never overlap, nothing recorded and
bit-equal features without a profiler, and trace()'s spans.jsonl.

The module imports neither jax nor the JAX package, so its card case runs
on a machine without jax as

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""
import json
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from hipt_abmil_atec23_tpu_torch.engine.encode import Encoder, encode_stream
from hipt_abmil_atec23_tpu_torch.engine.serve import ServeState, _mil_bucketed
from hipt_abmil_atec23_tpu_torch.models.abmil import build_mil_model
from hipt_abmil_atec23_tpu_torch.slideio.reader import BaseSlide
from hipt_abmil_atec23_tpu_torch.utils import logging as obs

SIZE = 16       # item side, px
BATCH = 4
MAIN = ("encode.wait", "encode.h2d", "encode.dispatch", "encode.collect")


class ArraySlide(BaseSlide):
    """An in-memory RGB slide with one level (RGB reads only)."""

    def __init__(self, img):
        self.img = img
        self.level_dimensions = [(img.shape[1], img.shape[0])]

    def read_region(self, location, level, size):
        x, y = location
        return self.img[y:y + size[1], x:x + size[0]].copy()


class TinyNet(nn.Module):
    input_dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(SIZE * SIZE * 3, 8)

    def forward(self, x):
        return self.fc(x.flatten(1))


def jobs_and_encoder(device, sizes=(6, 3, 9)):
    """Slides of ``sizes`` items (tail batches included) and a tiny encoder
    on ``device``."""
    rng = np.random.default_rng(0)
    jobs = []
    for i, n in enumerate(sizes):
        img = rng.integers(0, 256, (SIZE, n * SIZE, 3), dtype=np.uint8)
        coords = np.stack([np.arange(n) * SIZE, np.zeros(n, int)], 1)
        jobs.append((f"s{i}", ArraySlide(img), coords))
    torch.manual_seed(0)
    enc = Encoder(model=TinyNet().to(device).eval(), batch_size=BATCH,
                  input_size=SIZE, feat_dim=8, device=torch.device(device),
                  dct_rung=False, plane_rung=False)
    return jobs, enc


def n_batches(jobs):
    return sum(-(-len(c) // BATCH) for _, _, c in jobs)


def run_stream(jobs, enc, stage, activities=None):
    """(features by slide id, spans recorded, the profiler): the stream
    under a profiler of ``activities``, or none."""
    obs.clear_spans()
    prof = None
    if activities is None:
        out = dict(encode_stream(jobs, enc, stage=stage,
                                 adaptive_rungs=False))
    else:
        with profile(activities=activities) as prof:
            out = dict(encode_stream(jobs, enc, stage=stage,
                                     adaptive_rungs=False))
    return out, list(obs.recorded_spans()), prof


def by_name(spans, name):
    return sorted((s for s in spans if s.name == name),
                  key=lambda s: s.batch)


@pytest.mark.parametrize("stage", [False, True], ids=["overlapped",
                                                      "staged"])
def test_stream_spans_one_per_batch(stage):
    """Each batch records one encode.read, wait, h2d, dispatch and collect
    (no pin on the CPU), with its batch index, job index, real items and
    their pixels; a batch's read ends before its wait ends."""
    jobs, enc = jobs_and_encoder("cpu")
    _, spans, _ = run_stream(jobs, enc, stage, [ProfilerActivity.CPU])
    nb = n_batches(jobs)
    assert Counter(s.name for s in spans) == Counter(
        {n: nb for n in ("encode.read",) + MAIN})
    want = [(ji, len(c[i:i + BATCH])) for ji, (_, _, c) in enumerate(jobs)
            for i in range(0, len(c), BATCH)]
    for name in ("encode.read",) + MAIN:
        got = by_name(spans, name)
        assert [s.batch for s in got] == list(range(nb)), name
        assert [(s.slide, s.rows) for s in got] == want, name
        assert all(s.px == s.rows * SIZE * SIZE for s in got), name
        assert all(s.start_ns <= s.end_ns for s in got), name
    reads, waits = by_name(spans, "encode.read"), by_name(spans,
                                                          "encode.wait")
    assert {s.thread for s in reads}.isdisjoint({s.thread for s in waits})
    for r, w in zip(reads, waits):
        assert r.end_ns <= w.end_ns


@pytest.mark.parametrize("stage", [False, True], ids=["overlapped",
                                                      "staged"])
def test_main_loop_spans_never_overlap(stage):
    jobs, enc = jobs_and_encoder("cpu")
    _, spans, _ = run_stream(jobs, enc, stage, [ProfilerActivity.CPU])
    main = sorted(((s.start_ns, s.end_ns) for s in spans if s.name in MAIN))
    assert len(main) == 4 * n_batches(jobs)
    for (_, e), (s, _) in zip(main, main[1:]):
        assert e <= s


@pytest.mark.parametrize("stage", [False, True], ids=["overlapped",
                                                      "staged"])
def test_no_profiler_no_spans_same_features(stage):
    """Without a profiler nothing is recorded, and the features are
    bit-equal to the traced run's."""
    jobs, enc = jobs_and_encoder("cpu")
    traced, spans, _ = run_stream(jobs, enc, stage, [ProfilerActivity.CPU])
    plain, none, _ = run_stream(jobs, enc, stage)
    assert spans and none == []
    assert traced.keys() == plain.keys()
    for sid in plain:
        np.testing.assert_array_equal(plain[sid], traced[sid])
    assert obs.span_start() == 0
    assert obs.span_end(0, "encode.read", 0, 0, 4, 256) == 0
    assert obs.recorded_spans() == []


def test_mil_bucketed_spans():
    """One serve.pad, serve.h2d and serve.pool per bag, in that order,
    each with the bag's rows and no pixels; none without a profiler."""
    head = build_mil_model("clam_sb", size_arg="hipt_smaller")
    state = ServeState(device=torch.device("cpu"), model=head.eval())
    feats = np.random.default_rng(1).normal(size=(37, 192)).astype(
        np.float32)
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _mil_bucketed(state, feats)
    spans = list(obs.recorded_spans())
    assert [s.name for s in spans] == ["serve.pad", "serve.h2d",
                                       "serve.pool"]
    assert all(s.rows == 37 and s.px == 0 and s.slide == -1
               and s.batch == -1 for s in spans)
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns <= b.start_ns
    obs.clear_spans()
    plain = _mil_bucketed(state, feats)
    assert obs.recorded_spans() == []
    torch.testing.assert_close(plain.logits, traced.logits, rtol=0, atol=0)


def test_trace_writes_the_spans(tmp_path):
    """trace(dir) clears what came before, and writes trace.json and a
    spans.jsonl that parses back to the spans recorded."""
    jobs, enc = jobs_and_encoder("cpu", sizes=(5,))
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        obs.span_end(obs.span_start(), "stale")
    with obs.trace(str(tmp_path)):
        dict(encode_stream(jobs, enc, adaptive_rungs=False))
    spans = list(obs.recorded_spans())
    assert spans and "stale" not in {s.name for s in spans}
    assert (tmp_path / "trace.json").exists()
    with open(tmp_path / "spans.jsonl") as f:
        back = [obs.Span(**json.loads(line)) for line in f]
    assert back == spans


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pin copy and the device trace "
                    "exist only on a card")
    return torch.device("cuda")


def device_events(prof):
    """(name, start_ns, end_ns) of every operation on the card, on the
    host's time.time_ns clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda e: e[1])


@pytest.mark.cuda
def test_stream_spans_on_the_card(cuda_device):
    """On a card: one encode.pin per batch on the worker, and on the shared
    clock each batch's encode.h2d starts before its H2D copy and its
    encode.dispatch before its first kernel. A batch's kernels are those
    between the previous batch's D2H and its own (one compute stream)."""
    jobs, enc = jobs_and_encoder(cuda_device, sizes=(6, 3, 9))
    _, spans, prof = run_stream(jobs, enc, False, [ProfilerActivity.CUDA])
    nb = n_batches(jobs)
    pins = by_name(spans, "encode.pin")
    assert [s.batch for s in pins] == list(range(nb))
    reads = by_name(spans, "encode.read")
    assert all(p.thread == r.thread and r.end_ns <= p.start_ns
               for p, r in zip(pins, reads))
    ev = device_events(prof)
    h2d = [e for e in ev if "HtoD" in e[0]]
    d2h = [e for e in ev if "DtoH" in e[0]]
    kernels = [e for e in ev if "Memcpy" not in e[0]
               and "Memset" not in e[0]]
    assert len(h2d) == len(d2h) == nb
    for s, e in zip(by_name(spans, "encode.h2d"), h2d):
        assert s.start_ns <= e[1], (s.batch, e[1] - s.start_ns)
    bounds = [0] + [e[1] for e in d2h]
    for i, s in enumerate(by_name(spans, "encode.dispatch")):
        mine = [k for k in kernels if bounds[i] < k[1] < bounds[i + 1]]
        assert mine, i
        assert s.start_ns <= mine[0][1], (i, mine[0][1] - s.start_ns)
