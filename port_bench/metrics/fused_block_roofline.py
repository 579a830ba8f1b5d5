"""B.1's share of its roofline: the least time of every ViT block the
traced window ran (each block call's operations at the bf16 peak, or its
bytes at the memory rate, whichever is longer), over the device time of
B.1's kernels (kernels/csrc/fused_block.cu: its LayerNorm, GEMM and
attention launches). The blocks are counted from the real regions of each
batch dispatched: a tail batch at its real size, its padding left out."""
from collections import Counter

from port_bench.counts import hipt_blocks_least_seconds

B1_KERNELS = r"(^|[^A-Za-z0-9_])(layernorm_kernel|gemm_kernel|attention_kernel)<"


def read(ctx):
    spent = ctx.trace.seconds(B1_KERNELS)
    if spent <= 0:
        return None
    enc = ctx.config["encoder"]
    least = sum(k * hipt_blocks_least_seconds(enc, n)
                for n, k in Counter(ctx.counts["batch_items"]).items())
    return 100.0 * least / spent
