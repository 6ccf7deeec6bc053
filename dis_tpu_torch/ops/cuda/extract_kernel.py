"""K2: per-patch sampling regions (``csrc/extract_regions.cu``).

Replaces ``dis_tpu/ops/pallas/extract_kernel.py::extract_regions_pallas``.
Memory-bound on the H100 (about 120 MB of regions written at the 1080p
finest scale); one warp per patch computes its base and copies its window
with contiguous stores.  Plain version:
``ops/iclk.py::extract_regions_plain``, equal bitwise.
"""

from __future__ import annotations

import torch

from ... import _build
from ..iclk import extract_regions_plain, region_size
from . import all_on_cpu, check_input


def extract_regions(img2: torch.Tensor, pos0: torch.Tensor, ps: int, pad: int):
    """(regions [N, rc, rc], base_y [N] int32, base_x [N] int32) for the
    padded level plane ``img2`` and start positions ``pos0`` [N, 2]."""
    if all_on_cpu(img2, pos0):
        return extract_regions_plain(img2, pos0, ps, pad)
    dev = img2.device
    th, tw = img2.shape
    n = pos0.shape[0]
    rc = region_size(ps)
    if th < rc or tw < rc:
        raise ValueError(f"plane {th}x{tw} is smaller than a {rc}x{rc} region")
    check_input(img2, "img2", dev, torch.float32, (th, tw))
    check_input(pos0, "pos0", dev, torch.float32, (n, 2))
    regions = torch.empty((n, rc, rc), dtype=torch.float32, device=dev)
    base_y = torch.empty((n,), dtype=torch.int32, device=dev)
    base_x = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return regions, base_y, base_x
    _build.launch("dis_extract_regions", dev, img2.data_ptr(), th, tw,
                  pos0.data_ptr(), n, ps, pad, regions.data_ptr(),
                  base_y.data_ptr(), base_x.data_ptr())
    extract_regions.launches += 1
    return regions, base_y, base_x


extract_regions.launches = 0
