"""F1-F3: the frame's device glue around the pipeline (``csrc/frame_glue.cu``).

No Pallas kernel backs them: the JAX package writes them as ``jnp`` code
that XLA fuses.  They replace, once per ``dis_flow`` call:

- F1 :func:`frame_pad`, the divisibility padding of both images
  (``dis_tpu/ops/image.py::pad_divisible``), where the frame pads;
- F2 :func:`intensity_levels`, levels ``1..coarsest_scale`` of both
  images' raw-intensity chain (``dis_tpu/ops/pyramid.py::
  intensity_pyramid``), where the refinement reads intensity planes;
- F3 :func:`frame_finish`, the finest-scale flow scaled by
  ``2**finest_scale``, upsampled bilinearly and cropped
  (``dis_tpu/models/dis.py:468-472``), where ``finest_scale > 0``.

Each is bound by bytes on the H100.  F1 launches one thread per output
pixel, a block per output row.  F2 gives a block of four warps a 16 x 128
tile of level 1, each thread four pixels of four rows from float4 loads,
levels 2 and 3 in its registers and across a lane pair, levels 4 and 5 in
shared memory.  F3 gives a warp an output row and each lane runs of
``2**finest_scale`` columns that share their float2 taps, stored as
float4 pairs.  Their plain versions are ``ops/image.py::
frame_pad_plain``, ``ops/pyramid.py::intensity_levels_plain`` and
``ops/image.py::frame_finish_plain``; each kernel keeps their float32
operations in order, so it equals them bitwise.  Where the frame needs
no padding, F1 returns its inputs; where ``finest_scale == 0``, F3
returns the crop as a view; where ``coarsest_scale == 0``, F2 returns
the images: none launches.

The ops return new tensors: F1 the padded pair [2, (B,) H, W], F2 each
level of both images [2, (B,) h >> s, w >> s], F3 the cropped flow
[(B,) H, W, 2].
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from ... import _build
from ..image import frame_finish_plain, frame_pad_plain, replicate_pad
from ..pyramid import intensity_levels_plain
from . import all_on_cpu, check_input, dispatch, launched, register

MAX_GRID = 65535             # gridDim.y (F1: a block per output row; F3 keeps its limit) and .z
MAX_LEVELS = 5               # F2's levels a launch: its tile's 16 level-1 rows down to 1
T = torch.Tensor             # the ops' schemas come from these annotations


# -- F1: the frame's divisibility padding ------------------------------------------

def frame_pad(img1: torch.Tensor, img2: torch.Tensor, coarsest_scale: int
              ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """(padded img1, padded img2, (padw, padh)): both images [(B,) H, W]
    replicate-padded so that their dims divide by ``2**coarsest_scale``
    (``ops/image.py::pad_divisible``); the inputs themselves where nothing
    pads.  One launch of F1 where the frame pads."""
    if all_on_cpu(img1, img2):
        return frame_pad_plain(img1, img2, coarsest_scale)
    h, w = img1.shape[-2:]
    f = 2 ** coarsest_scale
    padw, padh = (f - w % f) % f, (f - h % f) % f
    if not (padw or padh):
        return img1, img2, (padw, padh)
    _check_pad_inputs(img1, img2)
    nb = img1.shape[0] if img1.ndim == 3 else 1
    if 2 * nb > MAX_GRID or h + padh > MAX_GRID:
        raise ValueError(f"{nb} pairs of {h + padh} rows: the kernel takes at most "
                         f"{MAX_GRID // 2} pairs of {MAX_GRID} rows")
    out = dispatch(frame_pad_op, _pad_cuda, img1.device, img1, img2, padh // 2,
                   padh - padh // 2, padw // 2, padw - padw // 2)
    return out[0], out[1], (padw, padh)


def _check_pad_inputs(img1: torch.Tensor, img2: torch.Tensor) -> None:
    """F1's inputs: float32 [H, W] or [B, H, W] of one shape on one CUDA
    device (or on the CPU within ``ops_on_cpu``), of any strides."""
    if img1.ndim not in (2, 3) or img1.shape != img2.shape or img1.numel() == 0:
        raise ValueError(f"images must be one non-empty shape, [H, W] or [B, H, W]: got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    for t, name in ((img1, "img1"), (img2, "img2")):
        check_input(t, name, img1.device, torch.float32, img1.shape, contiguous=False)


def _pad_empty(img1: torch.Tensor, img2: torch.Tensor, top: int, bottom: int, left: int,
               right: int) -> torch.Tensor:
    h, w = img1.shape[-2:]
    return img1.new_empty((2,) + tuple(img1.shape[:-2]) + (h + top + bottom, w + left + right))


def _strides(t: torch.Tensor) -> ctypes.Array:
    s = t.stride()
    return (ctypes.c_int64 * 3)(*((s[0] if t.ndim == 3 else 0,) + tuple(s[-2:])))


def _pad_cuda(img1: T, img2: T, top: int, bottom: int, left: int, right: int) -> T:
    """F1 on checked inputs: the padded pair [2, (B,) H, W]."""
    out = _pad_empty(img1, img2, top, bottom, left, right)
    nb = img1.shape[0] if img1.ndim == 3 else 1
    _build.launch("dis_frame_pad", img1.device, img1.data_ptr(), img2.data_ptr(),
                  _strides(img1), _strides(img2), nb, *img1.shape[-2:], *out.shape[-2:],
                  top, left, out.data_ptr())
    launched("frame_pad", "F1", frame_pad)
    return out


def _pad_cpu(img1, img2, top, bottom, left, right):
    return torch.stack([replicate_pad(t, top, bottom, left, right) for t in (img1, img2)])


# -- F2: the refinement's intensity levels -----------------------------------------

def intensity_levels(img1: torch.Tensor, img2: torch.Tensor, coarsest_scale: int
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(levels of img1, levels of img2): each ``[img, img/2, ...]``, the
    raw-intensity chain of ``ops/pyramid.py::intensity_pyramid`` to
    ``coarsest_scale``, planes [(B,) h >> s, w >> s].  Level 0 is the image
    itself.  One launch of F2 builds levels 1..coarsest_scale of both
    images (one more launch per ``MAX_LEVELS`` past five)."""
    if coarsest_scale == 0 or all_on_cpu(img1, img2):
        return intensity_levels_plain(img1, img2, coarsest_scale)
    if img1.ndim not in (2, 3) or img1.shape != img2.shape:
        raise ValueError(f"images must be one shape, [H, W] or [B, H, W]: got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    h, w = img1.shape[-2:]
    f = 2 ** coarsest_scale
    if h % f or w % f or h == 0 or w == 0:
        raise ValueError(f"{coarsest_scale} levels need dims divisible by {f}, got {h}x{w}: "
                         "the pipeline passes 2^coarsest-divisible planes (pad_divisible)")
    nb = img1.shape[0] if img1.ndim == 3 else 1
    if not 1 <= 2 * nb <= MAX_GRID:
        raise ValueError(f"{nb} planes: the kernel takes 1 to {MAX_GRID // 2}")
    dev = img1.device
    for t, name in ((img1, "img1"), (img2, "img2")):
        check_input(t, name, dev, torch.float32, img1.shape)
    levels1, levels2 = [img1], [img2]
    left = coarsest_scale
    while left > 0:
        n = min(left, MAX_LEVELS)
        outs = dispatch(intensity_levels_op, _levels_cuda, dev, levels1[-1], levels2[-1], n)
        levels1 += [o[0] for o in outs]
        levels2 += [o[1] for o in outs]
        left -= n
    return levels1, levels2


def _levels_empty(img1: torch.Tensor, img2: torch.Tensor, levels: int) -> List[torch.Tensor]:
    lead, (h, w) = tuple(img1.shape[:-2]), img1.shape[-2:]
    return [img1.new_empty((2,) + lead + (h >> s, w >> s)) for s in range(1, levels + 1)]


def _levels_cuda(img1: T, img2: T, levels: int) -> List[T]:
    """F2 on checked inputs: levels 1..``levels`` of both images, each
    [2, (B,) h >> s, w >> s]."""
    outs = _levels_empty(img1, img2, levels)
    nb = img1.shape[0] if img1.ndim == 3 else 1
    ptrs = (ctypes.c_void_p * levels)(*(t.data_ptr() for t in outs))
    _build.launch("dis_intensity_levels", img1.device, img1.data_ptr(), img2.data_ptr(), nb,
                  *img1.shape[-2:], levels, ptrs)
    launched("intensity_levels", "F2", intensity_levels)
    return outs


def _levels_cpu(img1, img2, levels):
    levels1, levels2 = intensity_levels_plain(img1, img2, levels)
    return [torch.stack([a, b]) for a, b in zip(levels1[1:], levels2[1:])]


# -- F3: the finest-scale flow at input resolution ---------------------------------

def frame_finish(flow: torch.Tensor, finest_scale: int, padw: int, padh: int, w_org: int,
                 h_org: int) -> torch.Tensor:
    """The flow [(B,) h_org, w_org, 2] at input resolution from the finest
    scale's flow [(B,) h, w, 2] of a frame padded by (``padw``, ``padh``):
    ``ops/image.py::frame_finish_plain``.  One launch of F3 where
    ``finest_scale > 0``; else the crop, a view."""
    if finest_scale == 0 or all_on_cpu(flow):
        return frame_finish_plain(flow, finest_scale, padw, padh, w_org, h_org)
    if flow.ndim not in (3, 4) or flow.shape[-1] != 2:
        raise ValueError(f"flow must be [h, w, 2] or [B, h, w, 2], got {tuple(flow.shape)}")
    fh, fw = flow.shape[-3:-1]
    top, left = padh // 2, padw // 2
    if (min(fh, fw, h_org, w_org) < 1 or top + h_org > fh << finest_scale
            or left + w_org > fw << finest_scale):
        raise ValueError(f"no crop [{h_org}, {w_org}] at ({top}, {left}) of the frame "
                         f"[{fh << finest_scale}, {fw << finest_scale}]")
    nb = flow.shape[0] if flow.ndim == 4 else 1
    if nb > MAX_GRID or h_org > MAX_GRID:
        raise ValueError(f"{nb} flows of {h_org} rows: the kernel takes at most "
                         f"{MAX_GRID} flows of {MAX_GRID} rows")
    check_input(flow, "flow", flow.device, torch.float32, flow.shape)
    return dispatch(frame_finish_op, _finish_cuda, flow.device, flow, finest_scale, top, left,
                    h_org, w_org)


def _finish_empty(flow: torch.Tensor, finest_scale: int, top: int, left: int, height: int,
                  width: int) -> torch.Tensor:
    return flow.new_empty(tuple(flow.shape[:-3]) + (height, width, 2))


def _finish_cuda(flow: T, finest_scale: int, top: int, left: int, height: int,
                 width: int) -> T:
    """F3 on checked inputs: the cropped flow [(B,) height, width, 2]."""
    out = _finish_empty(flow, finest_scale, top, left, height, width)
    nb = flow.shape[0] if flow.ndim == 4 else 1
    f = 1 << finest_scale
    _build.launch("dis_frame_finish", flow.device, flow.data_ptr(), nb, *flow.shape[-3:-1],
                  height, width, top, left, float(f), 1.0 / f, out.data_ptr())
    launched("frame_finish", "F3", frame_finish)
    return out


def _finish_cpu(flow, finest_scale, top, left, height, width):
    return frame_finish_plain(flow, finest_scale, 2 * left, 2 * top, width,
                              height).contiguous()


frame_pad.launches = 0
intensity_levels.launches = 0
frame_finish.launches = 0
frame_pad_op = register("frame_pad", _pad_cuda, _pad_empty, _pad_cpu)
intensity_levels_op = register("intensity_levels", _levels_cuda, _levels_empty, _levels_cpu)
frame_finish_op = register("frame_finish", _finish_cuda, _finish_empty, _finish_cpu)
