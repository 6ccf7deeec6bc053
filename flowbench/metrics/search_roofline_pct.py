"""Per-scale search layer: the least time of its work at the layer's
boundary (``flowbench/roofline/search.py``, with the reference's trips on
the traced pairs) over its device time, in %."""

from ..roofline import search

LAYER = "per-scale search"


def read(ctx):
    return ctx.roofline_pct(LAYER, lambda prm, h, w, trips: search.count(prm, h, w, trips))
