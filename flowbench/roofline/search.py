"""The per-scale search's work for one pair, counted at the layer's
boundary (the yardstick of ``search_roofline_pct``).

Bytes: at each scale the level planes the search reads (I1's image,
d/dx and d/dy and I2's image, each padded by ``img_padding``), the
coarser scale's dense flow it reads (none at the coarsest) and the dense
flow it writes, each once, in float32.  What an implementation keeps
between its steps (regions, templates, patch flows, weights) is not
counted: a fusion that removes such traffic leaves the count unchanged.

Operations, from shapes and the trips the reference takes on the same
pair (``reference.dis.Trips``), with ``P = ps * ps``:

- templates, once a patch: the three Hessian sums (6P), the template's
  mean and its subtraction (2P), the solve's guard (4);
- the start and each trip's resample: 4 bilinear weights (8) and 7
  operations a tap (7P), the mean subtraction (2P) where patches are
  normalized;
- each trip: the residual (P, fixed mode), the two sums of products
  (4P), the 2x2 solve (10), the update, the policing test and the
  convergence test (14);
- fixed mode's weights, once a patch: a resample (as above), the
  squared residual's sum (3P), the weight (2);
- densification: 5 operations a tap (2 products, 3 sums) and 2 divisions
  a pixel.
"""

from __future__ import annotations

from typing import Tuple


def count(prm, height: int, width: int, trips) -> Tuple[float, float]:
    """(operations, bytes) of one pair [height, width] under ``prm``
    (``reference.dis.Params``), given the reference's ``trips`` on it."""
    ps, pad = prm.patch_size, prm.img_padding
    P = ps * ps
    fixed = prm.mode == "fixed"
    sample = 8 + 7 * P + (2 * P if prm.patch_normalization else 0)
    flops = 0.0
    nbytes = 0.0
    for scale, n, n_trips, (h, w) in trips.scales:
        flops += n * (6 * P + 2 * P + 4)                  # templates, Hessians
        flops += n * sample                               # the start
        flops += n_trips * ((P if fixed else 0) + 4 * P + 10 + 14 + sample)
        if fixed:
            flops += n * (sample + 3 * P + 2)
        flops += n * 5 * P + 2 * h * w                    # densification
        nbytes += 4 * 4 * (h + 2 * pad) * (w + 2 * pad)   # four level planes
        if scale != prm.coarsest_scale:
            nbytes += 4 * 2 * (h // 2) * (w // 2)         # the coarser flow
        nbytes += 4 * 2 * h * w                           # the dense flow
    return flops, nbytes
