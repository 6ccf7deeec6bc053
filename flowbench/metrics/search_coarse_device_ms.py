"""Per-scale search layer: device ms a pair of S1, K2/K2b/K2c, K1/K1b, S3
and S4 at the scales coarser than the configuration's finest, in the
traced window: each replay's kernels matched to the program's launch
manifest, which gives their scales (``flowbench/replays.py``).  Nothing
where the run matched no replays."""

LAYER = "per-scale search"


def read(ctx):
    replays = getattr(ctx, "replays", None)
    if replays is None:
        return None
    return replays.layer_ms_per_pair(LAYER, ctx.pairs_traced, ctx.prm.finest_scale)
