"""K3: one pyramid level (``csrc/pyramid_level.cu``).

Replaces ``dis_tpu/ops/pallas/pyramid_kernel.py::pyramid_level_pallas``
(kernel body ``_level_kernel``).  Memory-bound on the H100 (one plane
read, three written); the kernel stages level values with a halo in
shared memory and fuses the x0.5 decimation of coarser levels.  Plain
version: ``ops/pyramid.py::pyramid_level_plain``, equal bitwise.  A
batch of planes [B, ...] is one launch (``blockIdx.z`` is the plane).
"""

from __future__ import annotations

import torch

from ... import _build
from ..pyramid import pyramid_level_plain
from . import all_on_cpu, check_input


MAX_PLANES = 65535   # gridDim.z


def pyramid_level(src: torch.Tensor, p: int, base: bool):
    """(img_pad, dx_pad, dy_pad) [(B,) h + 2p, w + 2p] of one level.

    ``base=True``: ``src`` is the raw [(B,) h, w] image (the level image
    is its Sobel magnitude).  ``base=False``: ``src`` is the finer level's
    padded image plane [(B,) 2h + 2p, 2w + 2p] (the level image is its
    decimation).
    """
    if all_on_cpu(src):
        return pyramid_level_plain(src, p, base)
    if src.ndim not in (2, 3):
        raise ValueError(f"src must be [H, W] or [B, H, W], got shape {tuple(src.shape)}")
    lead = tuple(src.shape[:-2])
    nplanes = lead[0] if lead else 1
    if not 1 <= nplanes <= MAX_PLANES:
        raise ValueError(f"{nplanes} planes: the kernel takes 1 to {MAX_PLANES}")
    sh, sw = src.shape[-2:]
    if base:
        h, w = sh, sw
    else:
        if (sh - 2 * p) % 2 or (sw - 2 * p) % 2:
            raise ValueError(f"decimation needs an even interior, got "
                             f"{sh - 2 * p}x{sw - 2 * p}")
        h, w = (sh - 2 * p) // 2, (sw - 2 * p) // 2
    if h < 2 or w < 2:
        raise ValueError(f"level of {h}x{w} is too small for the 3x3 stencil")
    check_input(src, "src", src.device, torch.float32, lead + (sh, sw))
    img, dx, dy = (torch.empty(lead + (h + 2 * p, w + 2 * p), dtype=torch.float32,
                               device=src.device) for _ in range(3))
    _build.launch("dis_pyramid_level", src.device, src.data_ptr(), sh, sw,
                  img.data_ptr(), dx.data_ptr(), dy.data_ptr(), nplanes, h, w,
                  p, int(base))
    pyramid_level.launches += 1
    return img, dx, dy


pyramid_level.launches = 0
