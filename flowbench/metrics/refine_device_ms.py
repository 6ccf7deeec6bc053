"""Refinement layer: device ms a pair of R0-R3 and their modes, in the
traced window; nothing where the configuration does not refine."""

LAYER = "refinement"


def read(ctx):
    return ctx.layer_ms_per_pair(LAYER)
