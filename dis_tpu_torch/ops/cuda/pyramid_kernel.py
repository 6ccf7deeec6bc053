"""K3: the pyramid, every level in one launch (``csrc/pyramid_level.cu``).

Replaces ``dis_tpu/ops/pallas/pyramid_kernel.py::pyramid_level_pallas``
(kernel body ``_level_kernel``), which the TPU calls once per level.
Memory-bound on the H100: a block owns a 64 x 64 tile of the first level
and the tiles beneath it at the coarser ones, stages the raw image with
its halo in shared memory, and builds each level's magnitude or box mean
there, so the raw image is read once and every plane written once.  Up to
``MAX_LEVELS`` levels per launch; a deeper pyramid chains a launch that
decimates the last level's image plane.  Plain version: the chain of
``ops/pyramid.py::pyramid_level_plain``, equal bitwise.  A batch of planes
[B, ...] is one launch (``blockIdx.z`` is the plane).
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ... import _build
from ..pyramid import pyramid_plain
from . import all_on_cpu, check_input, dispatch, launched, register

MAX_PLANES = 65535   # gridDim.z
MAX_LEVELS = 4       # per launch: the shared memory of a 64 x 64 base tile


def pyramid_levels(src: torch.Tensor, p: int, levels: int, base: bool = True):
    """[(img_pad, dx_pad, dy_pad)] for ``levels`` levels, finest first, each
    plane [(B,) h_s + 2p, w_s + 2p] with h_s = h >> s.

    ``base=True``: ``src`` is the raw [(B,) h, w] image (the first level
    image is its Sobel magnitude).  ``base=False``: ``src`` is the finer
    level's padded image plane [(B,) 2h + 2p, 2w + 2p] (the first level
    image is its decimation).  One launch (one call of the op
    ``dis_tpu_torch::pyramid_levels``) per ``MAX_LEVELS`` levels.
    """
    if all_on_cpu(src):
        return pyramid_plain(src, p, levels, base)
    out = []
    while levels > 0:
        n = min(levels, MAX_LEVELS)
        _check(src, p, n, base)
        flat = dispatch(pyramid_levels_op, _pyramid_cuda, src.device, src, p, n, base)
        out += [tuple(flat[3 * s:3 * s + 3]) for s in range(n)]
        src, base, levels = out[-1][0], False, levels - n
    return out


def pyramid_level(src: torch.Tensor, p: int, base: bool):
    """(img_pad, dx_pad, dy_pad) of one level: :func:`pyramid_levels` with
    one level."""
    return pyramid_levels(src, p, 1, base)[0]


def first_level_dims(src: torch.Tensor, p: int, base: bool):
    """(h, w) of the first level built from ``src``."""
    sh, sw = src.shape[-2:]
    return (sh, sw) if base else ((sh - 2 * p) // 2, (sw - 2 * p) // 2)


def _check(src: torch.Tensor, p: int, n: int, base: bool) -> None:
    if src.ndim not in (2, 3):
        raise ValueError(f"src must be [H, W] or [B, H, W], got shape {tuple(src.shape)}")
    lead = tuple(src.shape[:-2])
    nplanes = lead[0] if lead else 1
    if not 1 <= nplanes <= MAX_PLANES:
        raise ValueError(f"{nplanes} planes: the kernel takes 1 to {MAX_PLANES}")
    sh, sw = src.shape[-2:]
    if not base and ((sh - 2 * p) % 2 or (sw - 2 * p) % 2):
        raise ValueError(f"decimation needs an even interior, got "
                         f"{sh - 2 * p}x{sw - 2 * p}")
    h, w = first_level_dims(src, p, base)
    f = 1 << (n - 1)
    if h % f or w % f:
        raise ValueError(f"{n} levels need dims divisible by {f}, got {h}x{w}")
    if h // f < 1 or w // f < 1:
        raise ValueError(f"a level of {h // f}x{w // f}: the kernel takes 1 or more rows "
                         "and columns")
    check_input(src, "src", src.device, torch.float32, lead + (sh, sw))


def _empty_planes(src: torch.Tensor, p: int, levels: int, base: bool):
    h, w = first_level_dims(src, p, base)
    lead = tuple(src.shape[:-2])
    return [torch.empty(lead + (h // (1 << s) + 2 * p, w // (1 << s) + 2 * p),
                        dtype=torch.float32, device=src.device)
            for s in range(levels) for _ in range(3)]


def _pyramid_cuda(src: torch.Tensor, p: int, levels: int, base: bool) -> List[torch.Tensor]:
    """K3 on checked inputs: the planes (img, dx, dy) of ``levels`` levels,
    finest first, flat."""
    planes = _empty_planes(src, p, levels, base)
    h, w = first_level_dims(src, p, base)
    sh, sw = src.shape[-2:]
    nplanes = src.shape[0] if src.ndim == 3 else 1
    outs = (ctypes.c_void_p * (3 * levels))(*(t.data_ptr() for t in planes))
    _build.launch("dis_pyramid", src.device, src.data_ptr(), sh, sw, outs, nplanes,
                  levels, h, w, p, int(base))
    launched("pyramid_levels", "K3", pyramid_levels)
    return planes


def _pyramid_cpu(src: torch.Tensor, p: int, levels: int, base: bool) -> List[torch.Tensor]:
    return [t for level in pyramid_plain(src, p, levels, base) for t in level]


pyramid_levels.launches = 0
pyramid_levels_op = register("pyramid_levels", _pyramid_cuda, _empty_planes, _pyramid_cpu)
