"""Gradient-magnitude pyramid construction (main.cpp:12-50); counterpart
of ``dis_tpu/ops/pyramid.py``.

Level 0 is the Sobel gradient magnitude of the input (quirk Q1); each
coarser level is a 0.5x INTER_LINEAR decimation of the previous level.
Every level carries its own Sobel dx/dy of the magnitude image and is
padded by ``img_padding``: replicate for the image, zeros for the
gradients (main.cpp:41-49).

The whole pyramid is one call of
``ops/cuda/pyramid_kernel.py::pyramid_levels``: kernel K3 on CUDA tensors,
one launch for up to four levels; :func:`pyramid_plain`, the chain of
:func:`pyramid_level_plain`, on CPU tensors.  A batch of images
``[B, H, W]`` gives levels ``[B, h + 2p, w + 2p]``, still one launch.
The refinement's raw-intensity chain of both images
(:func:`intensity_levels_plain`) is kernel F2 on CUDA tensors
(``ops/cuda/frame_kernel.py::intensity_levels``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

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


def pyramid_plain(src: torch.Tensor, p: int, levels: int, base: bool = True):
    """[(img_pad, dx_pad, dy_pad)] for ``levels`` levels, finest first:
    :func:`pyramid_level_plain` chained level by level (the plain version
    of kernel K3, which builds them all in one launch)."""
    out = []
    for s in range(levels):
        out.append(pyramid_level_plain(src, p, base and s == 0))
        src = out[-1][0]
    return out


def construct_pyramid(img: torch.Tensor, coarsest_scale: int,
                      img_padding: int, plain: bool = False
                      ) -> List[PyramidLevel]:
    """Returns levels[0..coarsest], finest first (level index == scale),
    of ``img`` [H, W] or a batch [B, H, W].

    ``plain=True`` runs :func:`pyramid_plain` on any device (the
    reference the kernel is checked against on the card).
    """
    from .cuda.pyramid_kernel import pyramid_levels

    p = img_padding
    build = pyramid_plain if plain else pyramid_levels
    return [PyramidLevel(img=ip, dx=dx, dy=dy, width=ip.shape[-1] - 2 * p,
                         height=ip.shape[-2] - 2 * p)
            for ip, dx, dy in build(img, p, coarsest_scale + 1)]


def intensity_pyramid(img: torch.Tensor, coarsest_scale: int) -> List[torch.Tensor]:
    """The raw-intensity resize chain ``[img, img/2, ...]`` (unpadded
    planes [(B,) h, w], one per scale, finest first) that the refinement
    reads under ``refinement_planes="intensity"``: the DIS paper's data
    term, where the pyramid levels above are gradient-magnitude planes
    (quirk Q1).  The same x0.5 decimation as the Q1 levels
    (:func:`image.resize_half`), on the device of ``img``."""
    out = [img]
    for _ in range(coarsest_scale):
        out.append(im.resize_half(out[-1]))
    return out


def intensity_levels_plain(img1: torch.Tensor, img2: torch.Tensor, coarsest_scale: int
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`intensity_pyramid` of both images of a pair: the plain
    version of kernel F2, which builds levels ``1..coarsest_scale`` of both
    in one launch (level 0 is each image itself)."""
    return (intensity_pyramid(img1, coarsest_scale),
            intensity_pyramid(img2, coarsest_scale))
