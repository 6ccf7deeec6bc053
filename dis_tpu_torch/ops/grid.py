"""Patch-grid geometry (patch_grid.cpp:17-51); counterpart of
``dis_tpu/ops/grid.py``.

Patch centers at ``i * steps + offset`` with centered offsets; grid size
``ceil(dim / steps)`` per axis.  The geometry is NumPy, computed on the
host per (shape, config).  ``make_grid`` is a copy of the JAX package's
framework-free function restricted to the full grid (the port has no
row-ranged stripes yet); ``tests/test_torch_iclk.py`` holds the copy equal.
"""

from __future__ import annotations

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


def init_from_coarser_flow(geom: GridGeometry,
                           flow_coarse: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor init from the coarser scale's dense flow
    [hc, wc, 2], x2 (patch_grid.cpp:108-119, quirk Q8): one row pick and
    one column pick (the centers form a regular lattice), then the
    x-outer flatten.  Pure copies and an exact x2."""
    dev = flow_coarse.device
    cxs = (np.arange(geom.num_w) * geom.steps + geom.offset_w) // 2
    cys = (np.arange(geom.num_h) * geom.steps + geom.offset_h) // 2
    rows = flow_coarse.index_select(0, torch.from_numpy(cys).to(dev))
    sub = rows.index_select(1, torch.from_numpy(cxs).to(dev))   # [nh, nw, 2]
    n = geom.num_w * geom.num_h
    return sub.transpose(0, 1).reshape(n, 2) * 2.0
