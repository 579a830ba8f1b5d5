"""The Prov-GigaPath cell's parts on the CPU: the work counted from the
shapes against a brute-force count, each new reader on a synthetic trace,
a whole run of the cell at a tiny schedule, and the comparison that
decides ``correct`` failing on planted faults of the dilated attention.

    python3 -m pytest port_bench/tests/test_port_bench_longnet.py -q
"""
import copy
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import counts, counts_longnet, harness  # noqa: E402
from port_bench.trace import DeviceTrace  # noqa: E402

CELL = "gigapath.score.bags"


@pytest.fixture(scope="module")
def files():
    return harness.cell_files(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), ROOT, CELL)


def brute_pairs(n, w, r, heads):
    """Walk every segment and head group as LongNet lays them out, and
    count the pairs among its tokens (the pads past the bag's end and the
    segment's own padding to a multiple of r left out)."""
    wp = min(w, n)
    total = 0
    for seg in range(-(-n // wp)):
        padded = -(-wp // r) * r
        for h in range(heads):
            j = h // (heads // r)
            total += sum(seg * wp + p < n and p < wp
                         for p in range(j, padded, r)) ** 2
    return total


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1025, 2049, 11081])
def test_branch_pairs_against_a_walk(n, files):
    m = files.config["model"]
    for w, r in counts_longnet.schedule(m) + [(8, 1), (16, 2), (96, 4)]:
        assert counts_longnet.branch_pairs(n, w, r, 16) == \
            brute_pairs(n, w, r, 16)
    d = m["embed_dim"] // m["num_heads"]
    assert counts_longnet.attention_flops(n, m) == 4 * d * sum(
        brute_pairs(n, w, r, 16) for w, r in counts_longnet.schedule(m))


def test_the_issue_tables_work(files):
    """Per slide at N 2,049, 11,081, 32,769: linears 0.35 / 1.91 / 5.64
    TFLOP over 12 layers, as the issue's table; attention 0.13 / 1.35 /
    6.16, below its 0.17 / 1.42 / 8.85, which counted the pads' pairs."""
    m = files.config["model"]
    for n, att, lin in ((2049, 0.13, 0.35), (11081, 1.35, 1.91),
                        (32769, 6.16, 5.64)):
        assert 12 * counts_longnet.attention_flops(n, m) / 1e12 == \
            pytest.approx(att, abs=0.01)
        assert counts_longnet.linear_flops(n - 1, m) / 1e12 == \
            pytest.approx(lin, abs=0.01)


def _reader(name):
    return harness.load_module(harness.metric_path(name), "m_" + name)


def test_roofline_reads_both_kernels(files):
    m = files.config["model"]
    trace = DeviceTrace([("dilated_attention_kernel", 0, 3 * 10 ** 8),
                         ("dilated_merge_kernel_0d1d2d", 3 * 10 ** 8,
                          4 * 10 ** 8),
                         ("gemm_kernel", 0, 10 ** 9)], 0, 10 ** 9)
    ctx = SimpleNamespace(trace=trace, config=files.config,
                          counts={"slide_tiles": [2048, 11080]})
    want = 12 * (counts_longnet.attention_least_seconds(2049, m)
                 + counts_longnet.attention_least_seconds(11081, m))
    assert _reader("dilated_attn_roofline.gigapath").read(ctx) == \
        pytest.approx(100 * want / 0.4, rel=1e-12)
    ctx.trace = DeviceTrace([("gemm_kernel", 0, 10)], 0, 100)
    assert _reader("dilated_attn_roofline.gigapath").read(ctx) is None


def test_mfu_counts_every_slide(files):
    m = files.config["model"]
    ctx = SimpleNamespace(config=files.config, window_s=2.0,
                          counts={"slide_tiles": [2048, 4096]})
    want = counts_longnet.slide_flops(2048, m) + \
        counts_longnet.slide_flops(4096, m)
    assert _reader("mfu.gigapath").read(ctx) == pytest.approx(
        100 * want / (2.0 * counts.BF16_FLOP_S), rel=1e-12)


def test_idle_bag_h2d_reads_its_spans(monkeypatch):
    from hipt_abmil_atec23_tpu_torch.utils import logging as lg
    trace = DeviceTrace([("k", 0, 40), ("k", 60, 100)], 0, 100)
    ctx = SimpleNamespace(trace=trace)
    monkeypatch.setattr(lg, "_SPANS", [])
    assert _reader("idle_bag_h2d.gigapath").read(ctx) is None
    monkeypatch.setattr(lg, "_SPANS", [
        lg.Span("longnet.h2d", 30, 55, "t", -1, -1, 8, 0),
        lg.Span("longnet.embed", 55, 70, "t", -1, -1, 8, 0)])
    assert _reader("idle_bag_h2d.gigapath").read(ctx) == pytest.approx(15.0)
    assert _reader("device_idle.gigapath").read(ctx) == pytest.approx(20.0)


TINY_MODEL = dict(in_chans=32, embed_dim=64, depth=2, num_heads=4,
                  mlp_ratio=4.0, segment_length=[64, 96, 256],
                  dilated_ratio=[1, 2, 4], dtype="float32")
TINY_TRAFFIC = dict(region_size=1024, regions_per_slide=[1, 4], sizes=4,
                    grid=[3, 3], pool_rows=2048, run_rows=16,
                    check_slides=3)


def tiny_files(files):
    f = copy.deepcopy(files)
    f.config["model"].update(TINY_MODEL)
    f.traffic.update(TINY_TRAFFIC)
    return f


def tiny_build(m):
    """The configuration's architecture built directly: the port's
    ``build_mil_model`` builds only the published one."""
    from hipt_abmil_atec23_tpu_torch.models.longnet import GigaPathSlide
    return GigaPathSlide(
        n_classes=m["n_classes"], in_dim=m["in_chans"], dim=m["embed_dim"],
        depth=m["depth"], heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
        schedule=list(zip(m["segment_length"], m["dilated_ratio"])),
        tile_size=m["tile_size"], ngrids=m["slide_ngrids"],
        eps=m["ln_eps"], norm_eps=m["norm_eps"])


@pytest.fixture
def tiny_model(monkeypatch):
    from port_bench.drivers import score_bags
    monkeypatch.setattr(score_bags, "build_model", tiny_build)


def test_build_model_refuses_another_architecture(files):
    from port_bench.drivers import score_bags
    with pytest.raises(ValueError, match="another architecture"):
        score_bags.build_model(tiny_files(files).config["model"])


def test_run_cell_on_the_cpu_at_a_tiny_schedule(files, monkeypatch,
                                                tiny_model):
    """The whole run: set-up, window, check and the result line; the
    program in f32 on the CPU stays near the reference."""
    from port_bench.drivers import score_bags
    monkeypatch.setattr(score_bags, "MAX_MPX_PER_S", 20000.0)
    f = tiny_files(files)
    res = harness.run_cell(f, 2 ** 33 + 5, 0.5, False, "cpu", 0.0)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["checks"]) == {"feat_err", "logit_err", "token_err"}
    assert max(c["value"] for c in res["checks"].values()) < 1e-5
    assert set(res["metrics"]) == {"slide_mpx_per_s.resnet50", "setup_s"}


def test_job_list_that_runs_out_fails(files, monkeypatch, tiny_model):
    from port_bench.drivers import score_bags
    monkeypatch.setattr(score_bags, "MAX_MPX_PER_S", 1e-3)
    f = tiny_files(files)
    with pytest.raises(RuntimeError, match="ran out"):
        harness.run_cell(f, 7, 0.5, False, "cpu", 0.0)


@pytest.mark.parametrize("tokens", [1, 5, 64, 65, 2049, 32769])
def test_token_rows_hold_the_tail_and_the_cls(tokens):
    from port_bench.drivers.score_bags import token_rows
    rows = token_rows(tokens)
    assert rows[0] == 0 and rows[-1] == tokens - 1
    assert (np.diff(rows) > 0).all() and len(rows) <= 128
    assert set(range(max(0, tokens - 64), tokens)) <= set(rows.tolist())
