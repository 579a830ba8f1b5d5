"""The stream's pin copy per megapixel, over the traced window: the
program's ``encode.pin`` spans (engine/encode.encode_stream's
``pin_memory`` of each decoded batch on its worker, the second host copy
of every batch), summed, over the real pixels of those batches. None
where the program records no such span."""
NAME = "encode.pin"


def read(ctx):
    try:
        from hipt_abmil_atec23_tpu_torch.utils.logging import recorded_spans
    except ImportError:
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    spans = [s for s in recorded_spans()
             if s.name == NAME and s.end_ns > t0 and s.start_ns < t1]
    px = sum(s.px for s in spans)
    if not px:
        return None
    return (sum(s.end_ns - s.start_ns for s in spans) / 1e6) / (px / 1e6)
