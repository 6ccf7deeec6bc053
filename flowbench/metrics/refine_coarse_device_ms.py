"""Refinement layer: device ms a pair of R0-R3 and their modes at the
scales coarser than the configuration's finest, in the traced window,
from the replays matched to the launch manifest (``flowbench/replays.py``);
nothing where the run matched no replays or the configuration does not
refine."""

LAYER = "refinement"


def read(ctx):
    replays = getattr(ctx, "replays", None)
    if replays is None:
        return None
    return replays.layer_ms_per_pair(LAYER, ctx.pairs_traced, ctx.prm.finest_scale)
