"""The device milliseconds of the ResNet trunk's elementwise work per real
megapixel dispatched, over the traced window: PyTorch's eager elementwise
kernels (``elementwise_kernel``, ``vectorized_elementwise_kernel``; on a
program without the epilogue, the convolutions' bias adds, the ReLUs'
clamps and the residual adds) and the port's convolution epilogue
(kernels/csrc/conv_epilogue.cu, ``conv_epilogue_kernel``), summed, over
the pixels of the real items dispatched (``items_dispatched`` x the item's
side squared; a tail batch's padding left out). The head's few
elementwise launches per scored slide fall in it too, on both sides
alike. The colour kernel (``ycc_kernel``), the max pool, the convolutions
and B.1's kernels are not counted. None where no such kernel ran."""
KERNELS = (r"(^|[^A-Za-z0-9_])(elementwise_kernel|"
           r"vectorized_elementwise_kernel|conv_epilogue_kernel)<")


def read(ctx):
    spent = ctx.trace.seconds(KERNELS)
    mpx = ctx.counts["items_dispatched"] * \
        ctx.config["encoder"]["input_size"] ** 2 / 1e6
    if spent <= 0 or mpx <= 0:
        return None
    return spent * 1e3 / mpx
