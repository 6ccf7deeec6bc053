"""Frame and pyramid layer: device ms a pair of the kernels, copies and
fills that ``flowbench/layers`` give the layer (K3, F1-F3, the copies
and fills), in the traced window."""

LAYER = "frame and pyramid"


def read(ctx):
    return ctx.layer_ms_per_pair(LAYER)
