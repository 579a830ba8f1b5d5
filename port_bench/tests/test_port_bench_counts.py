"""The yardstick's operation and byte counts against hand counts at the
cells' shapes, written out product by product."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import counts  # noqa: E402


def config(name):
    with open(os.path.join(ROOT, "port_bench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def gemm(m, n, k):
    return 2 * m * n * k


def test_hipt_region_flops_by_hand():
    enc = config("hipt4k_clam_sb_hipt_smaller")["encoder"]
    t, d, h = 257, 384, 1536          # ViT-256 tokens, width, MLP hidden
    block256 = (gemm(t, 3 * d, d) + gemm(t, d, d) + gemm(t, h, d)
                + gemm(t, d, h) + gemm(t, t, 64) * 6 + gemm(t, 64, t) * 6)
    embed = gemm(256, d, 16 * 16 * 3)
    vit256 = 256 * (embed + 12 * block256)
    g, e = 257, 192                   # ViT-4K tokens and width
    block4k = (gemm(g, 3 * e, e) + gemm(g, e, e) + gemm(g, 4 * e, e)
               + gemm(g, e, 4 * e) + gemm(g, g, 32) * 6 + gemm(g, 32, g) * 6)
    vit4k = gemm(256, e, 384) + 6 * block4k
    assert counts.hipt_region_flops(enc) == vit256 + vit4k
    assert 3.14e12 < vit256 + vit4k < 3.15e12


def test_hipt_block_least_time_by_hand():
    enc = config("hipt4k_clam_sb_hipt_smaller")["encoder"]
    calls = counts.hipt_block_calls(enc, 2)
    assert calls.count((512, 257, 264, 384, 4.0)) == 12
    assert calls.count((2, 257, 264, 192, 4.0)) == 6 and len(calls) == 18
    big = 512 * counts.vit_block_flops(257, 384, 4.0) / 989e12
    small = max(2 * 2 * 264 * 192 * 2 / 3.35e12 + 2 * 192 * 2304 / 3.35e12,
                2 * counts.vit_block_flops(257, 192, 4.0) / 989e12)
    assert counts.hipt_blocks_least_seconds(enc, 2) == pytest.approx(
        12 * big + 6 * small, rel=1e-12)
    # PERF.md's B.1 bound: 518 GFLOP, 0.523 ms per [512, 264, 384] call
    assert big == pytest.approx(0.523e-3, rel=2e-3)


def test_resnet_patch_flops_by_hand():
    enc = config("resnet50trunc_clam_sb_small")["encoder"]

    def conv(cin, cout, k, hw):
        return 2 * cin * cout * k * k * hw * hw

    stem = conv(3, 64, 7, 128)
    l1 = (conv(64, 64, 1, 64) + conv(64, 64, 3, 64) + conv(64, 256, 1, 64)
          + conv(64, 256, 1, 64)
          + 2 * (conv(256, 64, 1, 64) + conv(64, 64, 3, 64)
                 + conv(64, 256, 1, 64)))
    l2 = (conv(256, 128, 1, 64) + conv(128, 128, 3, 32)
          + conv(128, 512, 1, 32) + conv(256, 512, 1, 32)
          + 3 * (conv(512, 128, 1, 32) + conv(128, 128, 3, 32)
                 + conv(128, 512, 1, 32)))
    l3 = (conv(512, 256, 1, 32) + conv(256, 256, 3, 16)
          + conv(256, 1024, 1, 16) + conv(512, 1024, 1, 16)
          + 5 * (conv(1024, 256, 1, 16) + conv(256, 256, 3, 16)
                 + conv(256, 1024, 1, 16)))
    assert counts.resnet_patch_flops(enc) == stem + l1 + l2 + l3


def test_clam_flops_by_hand():
    size, n = [1024, 512, 256], 100_000
    flops = n * (gemm(1, 512, 1024) + 2 * gemm(1, 256, 512) + gemm(1, 1, 256)
                 + gemm(1, 512, 1)) + gemm(1, 2, 512)
    assert counts.clam_flops(size, 2, n) == flops
