"""Gradient-magnitude pyramid construction (main.cpp:12-50); counterpart
of ``dis_tpu/ops/pyramid.py``.

Level 0 is the Sobel gradient magnitude of the input (quirk Q1); each
coarser level is a 0.5x INTER_LINEAR decimation of the previous level.
Every level carries its own Sobel dx/dy of the magnitude image and is
padded by ``img_padding``: replicate for the image, zeros for the
gradients (main.cpp:41-49).

One level is one call of ``ops/cuda/pyramid_kernel.py::pyramid_level``
(kernel K3 on CUDA tensors, :func:`pyramid_level_plain` on CPU tensors).
A batch of images ``[B, H, W]`` gives levels ``[B, h + 2p, w + 2p]``,
still one call (one K3 launch) per level.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import image as im


class PyramidLevel(NamedTuple):
    img: torch.Tensor   # [(B,) h + 2p, w + 2p] replicate-padded magnitude image
    dx: torch.Tensor    # [(B,) h + 2p, w + 2p] zero-padded Sobel d/dx
    dy: torch.Tensor    # [(B,) h + 2p, w + 2p] zero-padded Sobel d/dy
    width: int          # unpadded w at this level
    height: int         # unpadded h at this level


def pyramid_level_plain(src: torch.Tensor, p: int, base: bool):
    """(img_pad, dx_pad, dy_pad) of one level, in plain PyTorch.

    ``base=True``: ``src`` is the raw [(B,) h, w] image and the level
    image is its Sobel magnitude.  ``base=False``: ``src`` is the finer
    level's padded image plane [(B,) 2h + 2p, 2w + 2p] and the level image
    is the x0.5 decimation of its interior.
    """
    if base:
        cur = im.gradient_magnitude(src)
    else:
        cur = im.resize_half(src[..., p:src.shape[-2] - p, p:src.shape[-1] - p])
    dx = im.sobel3(cur, "x")
    dy = im.sobel3(cur, "y")
    return (im.replicate_pad(cur, p, p, p, p),
            im.constant_pad(dx, p, p, p, p),
            im.constant_pad(dy, p, p, p, p))


def construct_pyramid(img: torch.Tensor, coarsest_scale: int,
                      img_padding: int, plain: bool = False
                      ) -> List[PyramidLevel]:
    """Returns levels[0..coarsest], finest first (level index == scale),
    of ``img`` [H, W] or a batch [B, H, W].

    ``plain=True`` runs :func:`pyramid_level_plain` on any device (the
    reference the kernel is checked against on the card).
    """
    from .cuda.pyramid_kernel import pyramid_level

    level = pyramid_level_plain if plain else pyramid_level
    p = img_padding
    levels: List[PyramidLevel] = []
    src = img
    for s in range(coarsest_scale + 1):
        ip, dx, dy = level(src, p, base=(s == 0))
        levels.append(PyramidLevel(img=ip, dx=dx, dy=dy,
                                   width=ip.shape[-1] - 2 * p,
                                   height=ip.shape[-2] - 2 * p))
        src = ip
    return levels
