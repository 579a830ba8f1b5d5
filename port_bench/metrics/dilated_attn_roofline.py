"""The dilated-attention kernels' share of their roofline: the least time
of the attention of every layer of every slide scored in the traced
window (each layer's pairs of tokens at the bf16 peak or its q, k, v,
output and lse bytes at the memory rate, whichever is longer; port_bench/
counts_longnet.py, zero pads counting nothing) over the device time of
the kernels' launches: ``dilated_attention_kernel`` (every branch's
attention) and ``dilated_merge_kernel`` (the branch merge), the CUDA
kernels of the port's kernels/csrc/dilated_attention.cu (their names
matched anywhere in the trace's kernel names, template arguments and all).
None where no such kernel ran."""
from port_bench.counts_longnet import attention_least_seconds

KERNELS = r"dilated_(attention|merge)_kernel"


def read(ctx):
    spent = ctx.trace.seconds(KERNELS)
    if spent <= 0:
        return None
    m = ctx.config["model"]
    least = sum(m["depth"] * attention_least_seconds(n + 1, m)
                for n in ctx.counts["slide_tiles"])
    return 100.0 * least / spent
