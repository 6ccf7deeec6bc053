"""Densification: patch displacements -> dense flow field; counterpart of
``dis_tpu/ops/densify.py``.

The reference scatter-adds each patch's ``u`` over its ps x ps footprint,
then normalizes by the accumulated weight (patch_grid.cpp:121-182;
quirks Q2-intent/Q6/Q7).  Here it is a gather: the footprint is
separable, so each output row sums the (at most ``ceil(ps/s)``) grid
rows covering it, then each output column sums the grid columns
covering it, each in increasing grid order -- the order of the JAX
package's phase stencil.  Deterministic, with no atomics and no cuDNN.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .grid import GridGeometry


def _cover(n_out: int, n_grid: int, off: int, s: int, ps: int):
    """Grid indices covering each output index: [n_out, K] indices into a
    zero-extended grid (index ``n_grid`` is the zero), increasing along K.
    A patch at ``g*s + off`` covers ``[g*s + off - ps/2, g*s + off + ps/2 - 1]``."""
    half = ps // 2
    y = np.arange(n_out)
    lo = -((-(y - off - half + 1)) // s)          # ceil
    k = -(-ps // s) + 1
    g = lo[:, None] + np.arange(k)[None, :]
    ok = (g >= 0) & (g < n_grid) & (g * s + off - half <= y[:, None]) \
        & (y[:, None] <= g * s + off + half - 1)
    return np.where(ok, g, n_grid)


def _stencil(x: torch.Tensor, geom: GridGeometry, width: int, height: int,
             ps: int) -> torch.Tensor:
    """Footprint sum of grid values x [nh, nw, c] -> [height, width, c]."""
    dev = x.device
    rows = torch.from_numpy(_cover(height, geom.num_h, geom.offset_h,
                                   geom.steps, ps)).to(dev)
    cols = torch.from_numpy(_cover(width, geom.num_w, geom.offset_w,
                                   geom.steps, ps)).to(dev)
    xz = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))      # zero grid row
    acc = None
    for k in range(rows.shape[1]):
        t = xz.index_select(0, rows[:, k])
        acc = t if acc is None else acc + t                  # [H, nw, c]
    az = torch.nn.functional.pad(acc, (0, 0, 0, 1))          # zero grid col
    out = None
    for k in range(cols.shape[1]):
        t = az.index_select(1, cols[:, k])
        out = t if out is None else out + t                  # [H, W, c]
    return out


@functools.lru_cache(maxsize=64)
def _uniform_wsum(geom_key, width: int, height: int, ps: int,
                  out_row0: int) -> np.ndarray:
    """[height, width, 1] float32 patch-coverage counts for a uniform-
    weight grid (copy of the JAX package's NumPy helper; exact small
    integers, so equal to any summation order of the weight stencil)."""
    num_w, num_h, off_w, off_h, s, iy0 = geom_key
    half = ps // 2
    ys = (np.arange(iy0, iy0 + num_h) * s + off_h) - out_row0
    xs = np.arange(num_w) * s + off_w
    cov_y = np.zeros(height, np.float32)
    for cy in ys:
        lo = max(0, cy - half)
        hi = max(lo, min(height, cy + half))
        cov_y[lo:hi] += 1.0
    cov_x = np.zeros(width, np.float32)
    for cx in xs:
        lo = max(0, cx - half)
        hi = max(lo, min(width, cx + half))
        cov_x[lo:hi] += 1.0
    cnt = np.outer(cov_y, cov_x)
    return cnt[..., None].astype(np.float32)


def densify(u: torch.Tensor, geom: GridGeometry, width: int, height: int,
            ps: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense flow [height, width, 2] from per-patch ``u`` [N, 2].

    ``weights`` is an optional per-patch weight [N] (fixed mode:
    ``1/max(1, ||r||^2)``); None is the reference's uniform weight (Q6),
    whose weight plane is the precomputed coverage count.
    """
    # u is x-outer (index = ix * num_h + iy): [num_w, num_h] then swap.
    ug = u.reshape(geom.num_w, geom.num_h, 2).transpose(0, 1)
    if weights is None:
        vg = ug
        wsum = torch.from_numpy(_uniform_wsum(
            (geom.num_w, geom.num_h, geom.offset_w, geom.offset_h,
             geom.steps, 0), width, height, ps, 0)).to(u.device)
    else:
        wg = weights.reshape(geom.num_w, geom.num_h).transpose(0, 1)[..., None]
        vg = ug * wg
        wsum = _stencil(wg, geom, width, height, ps)
    fsum = _stencil(vg, geom, width, height, ps)
    pos = wsum > 0
    return torch.where(pos, fsum / torch.where(pos, wsum, torch.ones_like(wsum)),
                       torch.zeros_like(fsum))
