"""Per-scale search layer: device ms a pair of S1, K2/K2b/K2c, K1/K1b, S3
and S4, in the traced window."""

LAYER = "per-scale search"


def read(ctx):
    return ctx.layer_ms_per_pair(LAYER)
