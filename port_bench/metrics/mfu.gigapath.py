"""The whole slide encoder's share of the card's bf16 peak over the
traced window: the counted operations of every slide scored (its
linears, each layer's attention pairs and the head; port_bench/
counts_longnet.slide_flops) over the window's length on the host clock at
989 TFLOP/s. The profiler slows a traced window a little, and this share
with it."""
from port_bench.counts import BF16_FLOP_S
from port_bench.counts_longnet import slide_flops


def read(ctx):
    m = ctx.config["model"]
    flops = sum(slide_flops(n, m) for n in ctx.counts["slide_tiles"])
    return 100.0 * flops / (ctx.window_s * BF16_FLOP_S)
