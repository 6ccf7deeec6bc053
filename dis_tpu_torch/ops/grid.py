"""Patch-grid geometry (patch_grid.cpp:17-51) and the per-scale plan;
counterpart of ``dis_tpu/ops/grid.py``.

Patch centers at ``i * steps + offset`` with centered offsets; grid size
``ceil(dim / steps)`` per axis.  The geometry is NumPy, computed on the
host per (shape, config).  ``make_grid`` is a copy of the JAX package's
framework-free function restricted to the full grid (the port has no
row-ranged stripes yet); ``tests/test_torch_iclk.py`` holds the copy equal.

Every constant a scale needs (centers, the NN-init picks, densify's cover
indices and uniform weight plane) is made once per (shape, stride, patch
size, device) by :func:`scale_plan` and kept on the device, so a frame
makes no host-to-device copy after the first one of its shape (a CUDA
graph cannot capture such a copy).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch


class GridGeometry(NamedTuple):
    num_w: int          # patches along x
    num_h: int          # patches along y
    offset_w: int       # x offset of patch centers
    offset_h: int       # y offset of patch centers
    steps: int
    centers: np.ndarray  # [N, 2] float32 (x, y), x-outer order


def make_grid(width: int, height: int, steps: int) -> GridGeometry:
    """Grid over a [height, width] image."""
    num_w = int(math.ceil(width / steps))
    num_h = int(math.ceil(height / steps))
    off_w = int(math.floor((width - (num_w - 1) * steps) / 2))
    off_h = int(math.floor((height - (num_h - 1) * steps) / 2))
    xs = np.arange(num_w) * steps + off_w
    ys = np.arange(num_h) * steps + off_h
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel()], -1).astype(np.float32)
    return GridGeometry(num_w, num_h, off_w, off_h, steps, centers)


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


class ScalePlan(NamedTuple):
    """The constants of one scale, on one device."""
    geom: GridGeometry
    centers: torch.Tensor       # [N, 2] float32, x-outer order
    nn_rows: torch.Tensor       # [num_h] int64: coarser-flow row per patch row
    nn_cols: torch.Tensor       # [num_w] int64: coarser-flow column per patch column
    cover_rows: torch.Tensor    # [height, K] int64 grid rows covering each row
    cover_cols: torch.Tensor    # [width, K] int64 grid columns covering each column
    uniform_wsum: torch.Tensor  # [height, width, 1] float32 coverage counts


@functools.cache
def scale_plan(width: int, height: int, steps: int, ps: int,
               device: torch.device) -> ScalePlan:
    """The plan of a [height, width] level with patch stride ``steps`` and
    patch size ``ps`` on ``device``, made at its first use and kept for
    the life of the process (a few MB at the 1080p finest scale, one plan
    per level shape the process meets).  Plans are never evicted: a CUDA
    graph captured over them reads their memory at every replay."""
    geom = make_grid(width, height, steps)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cxs = (np.arange(geom.num_w) * steps + geom.offset_w) // 2
    cys = (np.arange(geom.num_h) * steps + geom.offset_h) // 2
    key = (geom.num_w, geom.num_h, geom.offset_w, geom.offset_h, steps, 0)
    return ScalePlan(
        geom=geom, centers=put(geom.centers), nn_rows=put(cys), nn_cols=put(cxs),
        cover_rows=put(_cover(height, geom.num_h, geom.offset_h, steps, ps)),
        cover_cols=put(_cover(width, geom.num_w, geom.offset_w, steps, ps)),
        uniform_wsum=put(_uniform_wsum(key, width, height, ps, 0)))


def init_from_coarser_flow(plan: ScalePlan,
                           flow_coarse: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor init from the coarser scale's dense flow
    [..., hc, wc, 2], x2 (patch_grid.cpp:108-119, quirk Q8): one row pick
    and one column pick (the centers form a regular lattice), then the
    x-outer flatten to [..., N, 2].  Pure copies and an exact x2; a
    leading pair axis passes through."""
    rows = flow_coarse.index_select(-3, plan.nn_rows)
    sub = rows.index_select(-2, plan.nn_cols)              # [..., nh, nw, 2]
    n = plan.geom.num_w * plan.geom.num_h
    return sub.transpose(-3, -2).reshape(*sub.shape[:-3], n, 2) * 2.0
