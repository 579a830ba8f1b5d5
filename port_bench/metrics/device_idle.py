"""The share of the traced window in which no operation ran on the card
(the union of every kernel, memcpy and memset the profiler saw)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
