"""K2 and K2b: per-patch sampling regions (``csrc/extract_regions.cu``).

Replaces ``dis_tpu/ops/pallas/extract_kernel.py::extract_regions_pallas``
(K2) and its batched rule ``_run_vmap`` with body ``kern_batched`` (K2b):
a batch of pairs is one launch.  Plain version:
``ops/iclk.py::extract_regions_plain``, equal bitwise.

Bound by bytes on the H100 (about 120 MB of regions written per pair at
the 1080p finest scale).  The device code, ``csrc/extract_group.cuh``, is
shared with K2c: a persistent block of ``THREADS`` threads takes groups
of up to ``PATCHES_PER_GROUP`` patches of one grid column (a column's
groups of one size, ``group_layout``), stages each group's bounding box
of the plane (at most ``STAGE_FLOATS`` floats, two stages in flight,
cp.async) and writes the group's regions as one span of float4
streaming stores through a table built once per block.  A window outside
the staged part is copied from device memory, so the result never
depends on the cap.  ``num_h``, the grid's column length, makes the
groups follow the columns (``inverse_search`` passes it); without it a
group may straddle two columns and take that fallback for some windows.
A plane of fewer than ``rc`` rows or columns (a coarse level of a small
frame) takes a simple kernel of the same source, one thread per region
float, each window index clipped to the plane as the plain version clips
it.

The constants below are the kernel's (``dis_extract_layout`` returns
them on the card); ``shared_bytes``, ``blocks_per_sm`` and
``group_layout`` are the launch arithmetic that
``tests/test_torch_extract_layout.py`` checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from ..iclk import extract_regions_plain, region_size
from . import all_on_cpu, check_input, dispatch, register

THREADS = 256
PATCHES_PER_GROUP = 48
STAGES = 2
STAGE_FLOATS = 9216          # floats of plane a stage holds (36 KB)
MIN_BLOCKS_PER_SM = 2        # the kernel's __launch_bounds__
HEADER_INTS = 1              # per stage: the tile's pitch
MAX_REGION = 63              # rc: a table field keeps row and col in 6 bits
SM_SHARED_BYTES = 233_472    # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the runtime keeps per block
SM_THREADS = 2048


def shared_bytes(ps: int) -> int:
    """Dynamic shared memory of a block: the stages, the table (8 bytes an
    entry, rc^2 entries), and per stage the header, each patch's tile and
    plane offsets and the warps' partial boxes."""
    rc = region_size(ps)
    per_stage_ints = HEADER_INTS + 2 * PATCHES_PER_GROUP + 4 * (THREADS // 32)
    return STAGES * STAGE_FLOATS * 4 + rc * rc * 8 + STAGES * per_stage_ints * 4


def blocks_per_sm(ps: int) -> int:
    """Blocks an H100 SM holds by shared memory and threads (registers
    are capped by ``MIN_BLOCKS_PER_SM``)."""
    by_shared = SM_SHARED_BYTES // (shared_bytes(ps) + BLOCK_RESERVED_BYTES)
    return min(by_shared, SM_THREADS // THREADS)


def group_layout(num_h: int):
    """(groups, size) of a column of ``num_h`` patches: ceil(num_h /
    ``PATCHES_PER_GROUP``) groups of ``size`` patches, the column's share
    rounded up to a multiple of 4; the last group takes the rest."""
    groups = -(-num_h // PATCHES_PER_GROUP)
    return groups, (-(-num_h // groups) + 3) & ~3


def check_patch_size(ps: int) -> None:
    if ps < 1 or region_size(ps) > MAX_REGION:
        raise ValueError(f"patch_size {ps}: the extraction kernels take regions of at "
                         f"most {MAX_REGION} px (ps <= {(MAX_REGION - 3) // 2})")


def extract_regions(img2: torch.Tensor, pos0: torch.Tensor, ps: int, pad: int,
                    row0: int = 0, num_h: Optional[int] = None):
    """(regions [(B,) N, rc, rc], base_y [(B,) N] int32, base_x [(B,) N]
    int32) for the padded level plane ``img2`` [(B,) th, tw], whose first
    row is global row ``row0``, and start positions ``pos0`` [(B,) N, 2].
    ``num_h``: the column length of the x-outer grid the patches form (N
    a multiple of it), which lets the kernel's groups follow the columns;
    it does not change the result."""
    if all_on_cpu(img2, pos0):
        return extract_regions_plain(img2, pos0, ps, pad, row0)
    dev = img2.device
    if img2.ndim not in (2, 3) or pos0.ndim != img2.ndim:
        raise ValueError(f"img2 {tuple(img2.shape)} and pos0 {tuple(pos0.shape)}: "
                         "expected [th, tw] and [N, 2], or [B, th, tw] and [B, N, 2]")
    check_patch_size(ps)
    lead = tuple(img2.shape[:-2])
    th, tw = img2.shape[-2:]
    n = pos0.shape[-2]
    if num_h is None:
        num_h = n
    elif (num_h == 0 and n) or (num_h and n % num_h):
        raise ValueError(f"{n} patches do not form columns of num_h = {num_h}")
    if th < 1 or tw < 1:
        raise ValueError(f"plane {th}x{tw} is empty")
    check_input(img2, "img2", dev, torch.float32, lead + (th, tw))
    check_input(pos0, "pos0", dev, torch.float32, lead + (n, 2))
    return dispatch(extract_regions_op, _extract_cuda, dev, img2, pos0, ps, pad, row0,
                    num_h)


def empty_regions(img2: torch.Tensor, pos0: torch.Tensor, ps: int):
    """Uninitialised (regions, base_y, base_x) for ``pos0``'s patches."""
    lead = tuple(pos0.shape[:-1])
    rc = region_size(ps)
    return (torch.empty(lead + (rc, rc), dtype=torch.float32, device=img2.device),
            torch.empty(lead, dtype=torch.int32, device=img2.device),
            torch.empty(lead, dtype=torch.int32, device=img2.device))


def _extract_cuda(img2: torch.Tensor, pos0: torch.Tensor, ps: int, pad: int, row0: int,
                  num_h: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2/K2b on checked inputs."""
    regions, base_y, base_x = empty_regions(img2, pos0, ps)
    nb = img2.shape[0] if img2.ndim == 3 else 1
    th, tw = img2.shape[-2:]
    n = pos0.shape[-2]
    if nb * n == 0:
        return regions, base_y, base_x
    _build.launch("dis_extract_regions", img2.device, img2.data_ptr(), nb, th, tw,
                  pos0.data_ptr(), n, num_h, ps, pad, row0, regions.data_ptr(),
                  base_y.data_ptr(), base_x.data_ptr())
    extract_regions.launches += 1
    return regions, base_y, base_x


def _extract_fake(img2, pos0, ps, pad, row0, num_h):
    return empty_regions(img2, pos0, ps)


def _extract_cpu(img2, pos0, ps, pad, row0, num_h):
    return extract_regions_plain(img2, pos0, ps, pad, row0)


extract_regions.launches = 0
extract_regions_op = register("extract_regions", _extract_cuda, _extract_fake, _extract_cpu)
