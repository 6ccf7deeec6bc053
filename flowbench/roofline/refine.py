"""The variational refinement's work for one pair, counted at the
layer's boundary (the yardstick of ``refine_roofline_pct``).

Bytes: at each refined level, the two planes it reads (the intensity
levels, or the Q1 levels' interiors), the flow it reads and the flow it
writes, each once, in float32.  Coefficient planes, warped planes and
increments kept between sweeps are not counted.

Operations a pixel of a level, per outer warp (the sweeps are fixed by
the preset):

- ``planes6``: seven Sobels (5 each), the bilinear weights (8) and six
  warped planes (7 each), three differences: 88;
- ``warp1``: I1's two Sobels (10), the weights and one warped plane
  (15), its two Sobels (10), two means (4), three differences (3), three
  second Sobels (15): 57;
- each inner update: the robust weights of the data, gradient and
  smoothness terms (40), the four edge weights and their sum (11), the
  2x2 system's entries and right-hand sides (45): 96;
- each SOR sweep, every pixel updated once: the neighbour sums of u and
  v (22), the right-hand sides (6), the solve (8), the over-relaxation
  (6): 42.
"""

from __future__ import annotations

from typing import Tuple

OUTER = {"planes6": 88, "warp1": 57}
INNER = 96
SWEEP = 42


def count(prm, height: int, width: int) -> Tuple[float, float]:
    """(operations, bytes) of one pair whose divisibility-padded frame is
    [height, width]; (0, 0) where the configuration does not refine."""
    if prm.refinement_iters == 0:
        return 0.0, 0.0
    per_px = prm.refinement_iters * (
        OUTER[prm.refinement_scheme]
        + prm.refinement_inner_sweeps * (INNER + prm.refinement_sor_sweeps * SWEEP))
    scales = (range(prm.coarsest_scale, prm.finest_scale - 1, -1) if prm.refine_per_level
              else [prm.finest_scale])
    flops = nbytes = 0.0
    for s in scales:
        px = (height >> s) * (width >> s)
        flops += per_px * px
        nbytes += 4 * px * (2 + 2 + 2)
    return flops, nbytes
