"""The slide store's read time per megapixel read, over the window: the
benchmark's span around each batch read (store.PlanePool.gather, standing
in for the port's slideio/ reader), summed, over the pixels those reads
returned. Beside the window's wall time per megapixel it says whether the
store paces the cell."""


def read(ctx):
    c = ctx.counts
    if not c["read_px"]:
        return None
    return (c["read_ns"] / 1e6) / (c["read_px"] / 1e6)
