"""K2 and K2b: per-patch sampling regions (``csrc/extract_regions.cu``).

Replaces ``dis_tpu/ops/pallas/extract_kernel.py::extract_regions_pallas``
(K2) and its batched rule ``_run_vmap`` with body ``kern_batched`` (K2b):
a batch of pairs is one launch over every (pair, patch).  Memory-bound on
the H100 (about 120 MB of regions written per pair at the 1080p finest
scale); one warp per (pair, patch) computes its base and copies its
window with contiguous stores.  Plain version:
``ops/iclk.py::extract_regions_plain``, equal bitwise.
"""

from __future__ import annotations

import torch

from ... import _build
from ..iclk import extract_regions_plain, region_size
from . import all_on_cpu, check_input


def extract_regions(img2: torch.Tensor, pos0: torch.Tensor, ps: int, pad: int,
                    row0: int = 0):
    """(regions [(B,) N, rc, rc], base_y [(B,) N] int32, base_x [(B,) N]
    int32) for the padded level plane ``img2`` [(B,) th, tw], whose first
    row is global row ``row0``, and start positions ``pos0`` [(B,) N, 2]."""
    if all_on_cpu(img2, pos0):
        return extract_regions_plain(img2, pos0, ps, pad, row0)
    dev = img2.device
    if img2.ndim not in (2, 3) or pos0.ndim != img2.ndim:
        raise ValueError(f"img2 {tuple(img2.shape)} and pos0 {tuple(pos0.shape)}: "
                         "expected [th, tw] and [N, 2], or [B, th, tw] and [B, N, 2]")
    lead = tuple(img2.shape[:-2])
    nb = lead[0] if lead else 1
    th, tw = img2.shape[-2:]
    n = pos0.shape[-2]
    rc = region_size(ps)
    if th < rc or tw < rc:
        raise ValueError(f"plane {th}x{tw} is smaller than a {rc}x{rc} region")
    check_input(img2, "img2", dev, torch.float32, lead + (th, tw))
    check_input(pos0, "pos0", dev, torch.float32, lead + (n, 2))
    regions = torch.empty(lead + (n, rc, rc), dtype=torch.float32, device=dev)
    base_y = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    base_x = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    if nb * n == 0:
        return regions, base_y, base_x
    _build.launch("dis_extract_regions", dev, img2.data_ptr(), nb, th, tw,
                  pos0.data_ptr(), n, ps, pad, row0, regions.data_ptr(),
                  base_y.data_ptr(), base_x.data_ptr())
    extract_regions.launches += 1
    return regions, base_y, base_x


extract_regions.launches = 0
