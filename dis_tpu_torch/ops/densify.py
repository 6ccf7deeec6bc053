"""Densification: patch displacements -> dense flow field; counterpart of
``dis_tpu/ops/densify.py``.

The reference scatter-adds each patch's ``u`` over its ps x ps footprint,
then normalizes by the accumulated weight (patch_grid.cpp:121-182;
quirks Q2-intent/Q6/Q7).  Here it is a gather: the footprint is
separable, so each output row sums the (at most ``ceil(ps/s)``) grid
rows covering it, then each output column sums the grid columns
covering it, each in increasing grid order -- the order of the JAX
package's phase stencil.  Deterministic, with no atomics and no cuDNN.
The cover indices and the uniform weight plane come from the scale's
plan (``ops/grid.py::scale_plan``), already on the device.  A plan made
for a window of output rows (exact tiling) densifies only those rows
from its row-ranged grid, each row summing the same grid rows in the
same order as the untiled run, so the window is bitwise those rows of
the untiled flow (``dis_tpu/ops/densify.py`` ``out_row0``).  A leading
pair axis passes through every step, so a batch of pairs sums in the
same order as one pair.
"""

from __future__ import annotations

from typing import Optional

import torch

from .grid import ScalePlan


def _stencil(x: torch.Tensor, plan: ScalePlan) -> torch.Tensor:
    """Footprint sum of grid values x [..., nh, nw, c] -> [..., height, width, c]."""
    xz = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))      # zero grid row
    acc = None
    for k in range(plan.cover_rows.shape[1]):
        t = xz.index_select(-3, plan.cover_rows[:, k])
        acc = t if acc is None else acc + t                  # [..., H, nw, c]
    az = torch.nn.functional.pad(acc, (0, 0, 0, 1))          # zero grid col
    out = None
    for k in range(plan.cover_cols.shape[1]):
        t = az.index_select(-2, plan.cover_cols[:, k])
        out = t if out is None else out + t                  # [..., H, W, c]
    return out


def densify(u: torch.Tensor, plan: ScalePlan,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense flow [..., out_h, width, 2] over the plan's output window
    from per-patch ``u`` [..., N, 2].

    ``weights`` is an optional per-patch weight [..., N] (fixed mode:
    ``1/max(1, ||r||^2)``); None is the reference's uniform weight (Q6),
    whose weight plane is the plan's coverage count.
    """
    geom = plan.geom
    lead = u.shape[:-2]
    # u is x-outer (index = ix * num_h + iy): [num_w, num_h] then swap.
    ug = u.reshape(*lead, geom.num_w, geom.num_h, 2).transpose(-3, -2)
    if weights is None:
        vg = ug
        wsum = plan.uniform_wsum
    else:
        wg = weights.reshape(*lead, geom.num_w, geom.num_h).transpose(-2, -1)[..., None]
        vg = ug * wg
        wsum = _stencil(wg, plan)
    fsum = _stencil(vg, plan)
    pos = wsum > 0
    return torch.where(pos, fsum / torch.where(pos, wsum, torch.ones_like(wsum)),
                       torch.zeros_like(fsum))
