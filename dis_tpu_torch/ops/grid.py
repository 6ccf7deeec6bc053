"""Patch-grid geometry (patch_grid.cpp:17-51) and the per-scale plan;
counterpart of ``dis_tpu/ops/grid.py``.

Patch centers at ``i * steps + offset`` with centered offsets; grid size
``ceil(dim / steps)`` per axis.  The geometry is NumPy, computed on the
host per (shape, config).  ``make_grid`` is a copy of the JAX package's
framework-free function; ``tests/test_torch_iclk.py`` holds the copy
equal.

For exact tiling a grid can be restricted to a contiguous range of
GLOBAL patch rows (``iy_range``): centers stay in global coordinates,
and densification writes a window of output rows starting at global row
``out_row0``, so a stripe or a window computes exactly the patches and
rows the untiled run would.

Every constant a scale needs (centers, the NN-init picks, densify's cover
indices and uniform weight plane) is made once per (shape, stride, patch
size, row range, output window, device) by :func:`scale_plan` and kept on
the device, so a frame makes no host-to-device copy after the first one
of its shape (a CUDA graph cannot capture such a copy).  The cache never
evicts; :func:`plan_cache_bytes` says how much it holds.  A plan is made
from real tensors only: under a trace's fake tensors (``torch.export``)
it raises rather than cache a fake plan, so an export builds its plans
first (``models/dis.py::flow_plans``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake


class GridGeometry(NamedTuple):
    num_w: int          # patches along x
    num_h: int          # patches along y (local count when row-ranged)
    offset_w: int       # global x offset of patch centers
    offset_h: int       # global y offset of patch centers
    steps: int
    centers: np.ndarray  # [N, 2] float32 (x, y) GLOBAL coords, x-outer order
    iy0: int = 0        # first global patch-row index in this grid
    global_num_h: int = -1  # full grid rows (== num_h when untiled)


def make_grid(width: int, height: int, steps: int,
              iy_range: Optional[Tuple[int, int]] = None) -> GridGeometry:
    """Grid over a [height, width] image; optionally only global patch
    rows [iy0, iy1)."""
    num_w = int(math.ceil(width / steps))
    gnum_h = int(math.ceil(height / steps))
    off_w = int(math.floor((width - (num_w - 1) * steps) / 2))
    off_h = int(math.floor((height - (gnum_h - 1) * steps) / 2))
    iy0, iy1 = (0, gnum_h) if iy_range is None else iy_range
    iy0 = max(0, iy0)
    iy1 = min(gnum_h, iy1)
    xs = np.arange(num_w) * steps + off_w
    ys = np.arange(iy0, iy1) * steps + off_h
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel()], -1).astype(np.float32)
    return GridGeometry(num_w, iy1 - iy0, off_w, off_h, steps, centers,
                        iy0=iy0, global_num_h=gnum_h)


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
    """The constants of one scale (or one row window of it), on one device."""
    geom: GridGeometry
    centers: torch.Tensor       # [N, 2] float32, x-outer order
    nn_rows: torch.Tensor       # [num_h] int64: global coarser-flow row per patch row
    nn_cols: torch.Tensor       # [num_w] int64: coarser-flow column per patch column
    cover_rows: torch.Tensor    # [out_h, K] int64 local grid rows covering each row
    cover_cols: torch.Tensor    # [width, K] int64 grid columns covering each column
    uniform_wsum: torch.Tensor  # [out_h, width, 1] float32 coverage counts


def scale_plan(width: int, height: int, steps: int, ps: int,
               device: torch.device,
               iy_range: Optional[Tuple[int, int]] = None,
               out_window: Optional[Tuple[int, int]] = None) -> ScalePlan:
    """The plan of a level of global size [height, width] with patch
    stride ``steps`` and patch size ``ps`` on ``device``: the grid's
    global patch rows ``iy_range`` (default all) and densify's output
    rows ``out_window = (lo, hi)`` (default all).  Made at its first use
    and kept for the life of the process (a few MB at the 1080p finest
    scale, one plan per level shape and window the process meets).  Plans
    are never evicted: a CUDA graph captured over them reads their memory
    at every replay.  The arguments are normalized first, so the full
    grid and window give the same object however they are spelled."""
    gnum_h = int(math.ceil(height / steps))
    iy0, iy1 = (0, gnum_h) if iy_range is None else iy_range
    iy0, iy1 = max(0, iy0), min(gnum_h, iy1)
    lo, hi = (0, height) if out_window is None else out_window
    return _plan(width, height, steps, ps, torch.device(device), iy0,
                 max(iy0, iy1), lo, hi)


_PLANS: Dict[tuple, ScalePlan] = {}


def _plan(*key) -> ScalePlan:
    """The cached plan of ``key`` (:func:`_make_plan`'s arguments), made at
    its first use.  Raises, caching nothing, where the plan would hold a
    fake tensor: a plan first made inside a trace would break every later
    eager call of its shape."""
    plan = _PLANS.get(key)
    if plan is None:
        plan = _make_plan(*key)
        if any(is_fake(t) for t in plan[1:]):
            raise RuntimeError(
                f"the scale plan {key} was first asked for under fake tensors (a "
                "trace such as torch.export): build the plans eagerly first "
                "(models.dis.flow_plans)")
        plan = _PLANS.setdefault(key, plan)
    return plan


def plan_cache_bytes(device: torch.device) -> Tuple[int, int]:
    """(plans, bytes) the process-wide plan cache holds on ``device``."""
    plans = [p for key, p in list(_PLANS.items()) if key[4] == torch.device(device)]
    return len(plans), sum(t.nbytes for p in plans for t in p[1:])


def _make_plan(width: int, height: int, steps: int, ps: int, device: torch.device,
               iy0: int, iy1: int, out_lo: int, out_hi: int) -> ScalePlan:
    geom = make_grid(width, height, steps, iy_range=(iy0, iy1))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cxs = (np.arange(geom.num_w) * steps + geom.offset_w) // 2
    cys = (np.arange(iy0, iy1) * steps + geom.offset_h) // 2
    out_h = out_hi - out_lo
    key = (geom.num_w, geom.num_h, geom.offset_w, geom.offset_h, steps, iy0)
    # Densify's output row y (local to the window) is covered by local
    # grid row g at global center (iy0 + g) * s + off_h, so the row
    # offset the cover sees is iy0 * s + off_h - out_lo.
    return ScalePlan(
        geom=geom, centers=put(geom.centers), nn_rows=put(cys), nn_cols=put(cxs),
        cover_rows=put(_cover(out_h, geom.num_h, iy0 * steps + geom.offset_h - out_lo,
                              steps, ps)),
        cover_cols=put(_cover(width, geom.num_w, geom.offset_w, steps, ps)),
        uniform_wsum=put(_uniform_wsum(key, width, out_h, ps, out_lo)))


def init_from_coarser_flow(plan: ScalePlan, flow_coarse: torch.Tensor,
                           coarse_row_offset: int = 0) -> torch.Tensor:
    """Nearest-neighbor init from the coarser scale's dense flow
    [..., hc, wc, 2], x2 (patch_grid.cpp:108-119, quirk Q8), with the
    plan's picks (:func:`nn_init_plain`).  When ``flow_coarse`` is a
    window of rows, ``coarse_row_offset`` is its first global row."""
    return nn_init_plain(flow_coarse, plan.nn_rows, plan.nn_cols, coarse_row_offset)


def nn_init_plain(flow_coarse: torch.Tensor, nn_rows: torch.Tensor,
                  nn_cols: torch.Tensor, coarse_row_offset: int = 0) -> torch.Tensor:
    """The NN init of the search start (``ops/iclk.py::
    search_start_plain``, the plain version of S1's start, holds it): one
    row pick ``nn_rows`` and one column pick ``nn_cols`` (the
    centers form a regular lattice), then the x-outer flatten to [..., N,
    2].  Pure copies and an exact x2; a leading pair axis passes through."""
    rows_idx = nn_rows if coarse_row_offset == 0 else nn_rows - coarse_row_offset
    rows = flow_coarse.index_select(-3, rows_idx)
    sub = rows.index_select(-2, nn_cols)                   # [..., nh, nw, 2]
    n = nn_cols.shape[0] * nn_rows.shape[0]
    return sub.transpose(-3, -2).reshape(*sub.shape[:-3], n, 2) * 2.0
