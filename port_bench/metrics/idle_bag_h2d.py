"""The share of the traced window in which the card is idle while a
slide's bag and coordinates are copied to it: the device's idle gaps
under the program's ``longnet.h2d`` spans (engine/serve.score_with_coords,
utils/logging.py), on the clock both share. None where the program
records no such span."""
NAMES = ("longnet.h2d",)


def read(ctx):
    try:
        from hipt_abmil_atec23_tpu_torch.utils.logging import recorded_spans
    except ImportError:
        return None
    tr = ctx.trace
    spans = [("open", s.start_ns, s.end_ns) for s in recorded_spans()
             if s.name in NAMES and s.end_ns > tr.t0 and s.start_ns < tr.t1]
    if not spans:
        return None
    idle = dict(tr.idle_by_host(spans)).get("open", 0.0)
    return 100.0 * idle / tr.window_s
