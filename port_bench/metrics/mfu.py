"""The whole step's share of the card's bf16 peak over the traced window
(``mfu.<cell>``): the encoder's operations for every real item dispatched
(padding left out; a HIPT_4K region or a ResNet50-trunc patch, by the
configuration's ``encoder.kind``) and the head's for every slide scored,
over the window's length on the host clock at 989 TFLOP/s. The profiler
slows a traced window by some 3%, and this share with it."""
from port_bench.counts import (BF16_FLOP_S, clam_flops, hipt_region_flops,
                               resnet_patch_flops)

ITEM_FLOPS = {"hipt4k": hipt_region_flops, "resnet": resnet_patch_flops}


def read(ctx):
    c, cfg = ctx.counts, ctx.config
    head = cfg["head"]
    flops = c["items_dispatched"] * ITEM_FLOPS[cfg["encoder"]["kind"]](
        cfg["encoder"])
    flops += sum(clam_flops(head["size"], head["n_classes"], n)
                 for n in c["slide_items"])
    return 100.0 * flops / (ctx.window_s * BF16_FLOP_S)
