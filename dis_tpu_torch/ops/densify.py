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
plan (``ops/grid.py::scale_plan``), already on the device.  On CUDA
tensors the whole of it is one launch of kernel S4, and fixed mode's
weights one launch of kernel S3 (``ops/cuda/scale_kernel.py``); this
module holds their plain versions, :func:`densify_plain` and
:func:`fixed_weights_plain`.  A plan made
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
from .iclk import pairwise_sum


def _stencil(x: torch.Tensor, cover_rows: torch.Tensor,
             cover_cols: torch.Tensor) -> torch.Tensor:
    """Footprint sum of grid values x [..., nh, nw, c] -> [..., height, width, c]."""
    xz = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))      # zero grid row
    acc = None
    for k in range(cover_rows.shape[1]):
        t = xz.index_select(-3, cover_rows[:, k])
        acc = t if acc is None else acc + t                  # [..., H, nw, c]
    az = torch.nn.functional.pad(acc, (0, 0, 0, 1))          # zero grid col
    out = None
    for k in range(cover_cols.shape[1]):
        t = az.index_select(-2, cover_cols[:, k])
        out = t if out is None else out + t                  # [..., H, W, c]
    return out


def densify_plain(u: torch.Tensor, weights: Optional[torch.Tensor],
                  cover_rows: torch.Tensor, cover_cols: torch.Tensor,
                  uniform_wsum: Optional[torch.Tensor], num_w: int,
                  num_h: int) -> torch.Tensor:
    """Plain version of kernel S4: dense flow [..., out_h, width, 2] from
    per-patch ``u`` [..., N, 2] (x-outer, N = ``num_w * num_h``) with the
    plan's cover indices ``cover_rows`` [out_h, K] and ``cover_cols``
    [width, K] and, for the uniform weight (``weights`` None), its
    coverage counts ``uniform_wsum`` [out_h, width, 1], which weights make
    unneeded (None)."""
    lead = u.shape[:-2]
    # u is x-outer (index = ix * num_h + iy): [num_w, num_h] then swap.
    ug = u.reshape(*lead, num_w, num_h, 2).transpose(-3, -2)
    if weights is None:
        vg = ug
        wsum = uniform_wsum
    else:
        wg = weights.reshape(*lead, num_w, num_h).transpose(-2, -1)[..., None]
        vg = ug * wg
        wsum = _stencil(wg, cover_rows, cover_cols)
    fsum = _stencil(vg, cover_rows, cover_cols)
    pos = wsum > 0
    return torch.where(pos, fsum / torch.where(pos, wsum, torch.ones_like(wsum)),
                       torch.zeros_like(fsum))


def densify(u: torch.Tensor, plan: ScalePlan,
            weights: Optional[torch.Tensor] = None, plain: bool = False) -> torch.Tensor:
    """Dense flow [..., out_h, width, 2] over the plan's output window
    from per-patch ``u`` [..., N, 2]: one launch of kernel S4 on CUDA
    tensors, its plain version on CPU tensors or with ``plain=True``.

    ``weights`` is an optional per-patch weight [..., N] (fixed mode:
    :func:`fixed_weights`); None is the reference's uniform weight (Q6),
    whose weight plane is the plan's coverage count.
    """
    from .cuda.scale_kernel import densify as kernel

    fn = densify_plain if plain else kernel
    return fn(u, weights, plan.cover_rows, plan.cover_cols,
              plan.uniform_wsum if weights is None else None, plan.geom.num_w,
              plan.geom.num_h)


def fixed_weights_plain(Q: torch.Tensor, T: torch.Tensor, start_oob: torch.Tensor,
                        ps: int, normalize: bool) -> torch.Tensor:
    """Plain version of kernel S3: residual-adaptive densification weights
    (DIS paper eq. 4) ``1 / max(1, ||Q - Tn||^2)`` [..., N] from the
    search's final patches ``Q`` and the raw templates ``T`` [..., N,
    ps^2], with the template mean-normalized where ``normalize``.
    Patches frozen at start (``start_oob``) never resampled (their ``Q``
    is the raw template) and get the constant weight 1.0.  The mean
    divides by ``ps^2`` as a tensor, so that CPU and card round it as a
    true division (a CUDA tensor divided by a Python scalar is multiplied
    by its reciprocal), as the JAX package does."""
    ps2 = ps * ps
    Tn = T
    if normalize:
        s = pairwise_sum(Tn)[..., None]
        Tn = Tn - s / torch.full_like(s, ps2)
    r2 = pairwise_sum((Q - Tn) ** 2)
    return torch.where(start_oob, torch.ones_like(r2),
                       1.0 / torch.clamp(r2, min=1.0))


def fixed_weights(Q: torch.Tensor, T: torch.Tensor, start_oob: torch.Tensor, ps: int,
                  normalize: bool, plain: bool = False) -> torch.Tensor:
    """Fixed mode's densification weights [..., N]: one launch of kernel
    S3 on CUDA tensors, :func:`fixed_weights_plain` on CPU tensors or with
    ``plain=True``."""
    from .cuda.scale_kernel import fixed_weights as kernel

    fn = fixed_weights_plain if plain else kernel
    return fn(Q, T, start_oob, ps, normalize)
