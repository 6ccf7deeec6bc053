"""K2c: per-patch sampling regions, column-banded
(``csrc/extract_banded.cu``).

Replaces ``dis_tpu/ops/pallas/extract_kernel.py::extract_regions_banded``
(kernel body ``kern``), which the TPU takes where the padded plane
overflows VMEM: the 4K finest scale and the stripes of a tiled 4K frame
(``ops/iclk.py::extraction_route``).  It computes K2's function: the
plain version is ``ops/iclk.py::extract_regions_plain``, equal bitwise.

A block takes ``PATCHES_PER_BLOCK`` consecutive patches of one grid
column (the grid is x-outer, so they are contiguous), stages their
bounding box of the plane in shared memory, and copies each window out
of it.  The shared memory is sized from the static bound on ``|init_u|``
that the route checks; a window outside the staged box (none under the
Q9 policing chain) is copied from device memory, so the result never
depends on the bound.  A batch of pairs is one launch (``blockIdx.y``).
Memory-bound on the H100, as K2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ... import _build
from ..iclk import extract_regions_plain, region_size
from . import all_on_cpu, check_input

PATCHES_PER_BLOCK = 16
MAX_SHARED_BYTES = 232_448   # a Hopper block's dynamic shared memory (227 KB)
MAX_PAIRS = 65_535           # gridDim.y


def staged_box(ps: int, steps: int, init_bound: float):
    """(rows, cols) of plane a block stages: a group's bases spread by
    ``(group - 1) * steps`` rows and, under ``|init_u| <= init_bound``, by
    at most ``2 * ceil(init_bound) + 1`` more in each axis; one row and
    column of slack cover float32 rounding of ``center + init``."""
    rc = region_size(ps)
    spread = 2 * int(math.ceil(init_bound)) + rc + 2
    return (PATCHES_PER_BLOCK - 1) * steps + spread, spread


def shared_bytes(ps: int, steps: int, init_bound: float) -> int:
    rows, cols = staged_box(ps, steps, init_bound)
    return (2 * PATCHES_PER_BLOCK + 4) * 4 + rows * cols * 4


def extract_regions_banded(img2: torch.Tensor, pos0: torch.Tensor, ps: int,
                           pad: int, geom, init_bound: float, row0: int = 0,
                           outside: Optional[torch.Tensor] = None):
    """(regions [(B,) N, rc, rc], base_y [(B,) N] int32, base_x [(B,) N]
    int32) for the padded level plane ``img2`` [(B,) th, tw], whose first
    row is global row ``row0``, and the start positions ``pos0`` [(B,) N,
    2] of the x-outer grid ``geom`` (N = num_w * num_h), with ``|init_u|
    <= init_bound``.  ``outside``, a one-element int32 CUDA tensor, gets
    the count of patches copied from device memory instead of the staged
    box (a check; the main path passes none)."""
    n = pos0.shape[-2]
    if n != geom.num_w * geom.num_h:
        raise ValueError(f"pos0 holds {n} patches, the grid {geom.num_w} x "
                         f"{geom.num_h}: K2c takes the x-outer grid's patches")
    if all_on_cpu(img2, pos0):
        return extract_regions_plain(img2, pos0, ps, pad, row0)
    dev = img2.device
    if img2.ndim not in (2, 3) or pos0.ndim != img2.ndim:
        raise ValueError(f"img2 {tuple(img2.shape)} and pos0 {tuple(pos0.shape)}: "
                         "expected [th, tw] and [N, 2], or [B, th, tw] and [B, N, 2]")
    lead = tuple(img2.shape[:-2])
    nb = lead[0] if lead else 1
    if nb > MAX_PAIRS:
        raise ValueError(f"{nb} pairs: K2c takes at most {MAX_PAIRS}")
    th, tw = img2.shape[-2:]
    rc = region_size(ps)
    if th < rc or tw < rc:
        raise ValueError(f"plane {th}x{tw} is smaller than a {rc}x{rc} region")
    nbytes = shared_bytes(ps, geom.steps, init_bound)
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"K2c would stage {nbytes} bytes of shared memory per block (ps {ps}, "
            f"stride {geom.steps}, init bound {init_bound}), over the "
            f"{MAX_SHARED_BYTES} a Hopper block has")
    check_input(img2, "img2", dev, torch.float32, lead + (th, tw))
    check_input(pos0, "pos0", dev, torch.float32, lead + (n, 2))
    if outside is not None:
        check_input(outside, "outside", dev, torch.int32, (1,))
    regions = torch.empty(lead + (n, rc, rc), dtype=torch.float32, device=dev)
    base_y = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    base_x = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    if nb * n == 0:
        return regions, base_y, base_x
    rows, cols = staged_box(ps, geom.steps, init_bound)
    _build.launch("dis_extract_banded", dev, img2.data_ptr(), nb, th, tw,
                  pos0.data_ptr(), geom.num_w, geom.num_h, PATCHES_PER_BLOCK, ps,
                  pad, row0, rows, cols, regions.data_ptr(), base_y.data_ptr(),
                  base_x.data_ptr(), None if outside is None else outside.data_ptr())
    extract_regions_banded.launches += 1
    return regions, base_y, base_x


extract_regions_banded.launches = 0
