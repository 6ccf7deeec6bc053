"""Refinement layer: the least time of its work at the layer's boundary
(``flowbench/roofline/refine.py``) over its device time, in %; nothing
where the configuration does not refine."""

from ..roofline import refine

LAYER = "refinement"


def read(ctx):
    return ctx.roofline_pct(LAYER, lambda prm, h, w, trips: refine.count(prm, h, w))
