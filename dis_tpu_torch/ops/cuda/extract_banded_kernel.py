"""K2c: per-patch sampling regions, column-banded
(``csrc/extract_banded.cu``).

Replaces ``dis_tpu/ops/pallas/extract_kernel.py::extract_regions_banded``
(kernel body ``kern``), which the TPU takes where the padded plane
overflows VMEM: the 4K finest scale and the stripes of a tiled 4K frame
(the JAX package's choice of extraction, ``dis_tpu/ops/iclk.py``).  It
computes K2's function: the plain version is
``ops/iclk.py::extract_regions_plain``, equal bitwise.  The port's search
launches no K2c (K1's plane mode copies the same windows from the
plane); it is a standalone kernel that tests hold bitwise against K2,
the plane mode and the plain version.

Bound by bytes on the H100, as K2, whose device code it shares
(``csrc/extract_group.cuh``; constants and launch arithmetic in
``extract_kernel.py``): a block takes groups of up to
``PATCHES_PER_GROUP`` patches of one grid column of ``geom`` (the grid
is x-outer, so they are contiguous), stages their bounding box in a
stage of fixed size, and writes their regions as one span of float4
streaming stores.  The shared memory no longer follows the static bound
on ``|init_u|``: a window outside the staged box is copied from device
memory, so the result never depends on the bound or the cap.  A batch of
pairs is one launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from ..iclk import extract_regions_plain, region_size
from . import all_on_cpu, check_input, dispatch, launched, register
from .extract_kernel import check_patch_size, empty_regions

MAX_PAIRS = 65_535


def extract_regions_banded(img2: torch.Tensor, pos0: torch.Tensor, ps: int,
                           pad: int, geom, init_bound: float, row0: int = 0,
                           outside: Optional[torch.Tensor] = None):
    """(regions [(B,) N, rc, rc], base_y [(B,) N] int32, base_x [(B,) N]
    int32) for the padded level plane ``img2`` [(B,) th, tw], whose first
    row is global row ``row0``, and the start positions ``pos0`` [(B,) N,
    2] of the x-outer grid ``geom`` (N = num_w * num_h).  ``init_bound``,
    the TPU kernel's static bound on ``|init_u|``, does not size this
    one (kept as the TPU kernel's signature has it).  ``outside``, a
    one-element int32 CUDA tensor, gets the count of windows copied from
    device memory instead of the staged box (a check)."""
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
    check_patch_size(ps)
    lead = tuple(img2.shape[:-2])
    nb = lead[0] if lead else 1
    if nb > MAX_PAIRS:
        raise ValueError(f"{nb} pairs: K2c takes at most {MAX_PAIRS}")
    th, tw = img2.shape[-2:]
    rc = region_size(ps)
    if th < rc or tw < rc:
        raise ValueError(f"plane {th}x{tw} is smaller than a {rc}x{rc} region")
    check_input(img2, "img2", dev, torch.float32, lead + (th, tw))
    check_input(pos0, "pos0", dev, torch.float32, lead + (n, 2))
    if outside is not None:
        check_input(outside, "outside", dev, torch.int32, (1,))
    return dispatch(extract_regions_banded_op, _banded_cuda, dev, img2, pos0, ps, pad,
                    row0, geom.num_w, geom.num_h, outside)


def _banded_cuda(img2: torch.Tensor, pos0: torch.Tensor, ps: int, pad: int, row0: int,
                 num_w: int, num_h: int, outside: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2c on checked inputs; adds to ``outside`` where given."""
    regions, base_y, base_x = empty_regions(img2, pos0, ps)
    nb = img2.shape[0] if img2.ndim == 3 else 1
    th, tw = img2.shape[-2:]
    if nb * num_w * num_h == 0:
        return regions, base_y, base_x
    _build.launch("dis_extract_banded", img2.device, img2.data_ptr(), nb, th, tw,
                  pos0.data_ptr(), num_w, num_h, ps, pad, row0,
                  regions.data_ptr(), base_y.data_ptr(), base_x.data_ptr(),
                  None if outside is None else outside.data_ptr())
    launched("extract_regions_banded", "K2c", extract_regions_banded)
    return regions, base_y, base_x


def _banded_fake(img2, pos0, ps, pad, row0, num_w, num_h, outside):
    return empty_regions(img2, pos0, ps)


def _banded_cpu(img2, pos0, ps, pad, row0, num_w, num_h, outside):
    """The plain version (it counts no windows: ``outside`` is left as it
    is)."""
    return extract_regions_plain(img2, pos0, ps, pad, row0)


extract_regions_banded.launches = 0
extract_regions_banded_op = register("extract_regions_banded", _banded_cuda, _banded_fake,
                                     _banded_cpu, mutates_args=("outside",))
