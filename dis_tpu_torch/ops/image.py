"""OpenCV-exact image primitives in PyTorch (counterpart of
``dis_tpu/ops/image.py``).

3x3 Sobel (scale 1/8, reflect-101 border), the x0.5 INTER_LINEAR
decimation (exact 2x2 box mean for even dims), general INTER_LINEAR
resize and the two ``copyMakeBorder`` modes.  Every function takes and
returns float32 planes ``[H, W]`` or a batch of them ``[B, H, W]`` (the
plane is always the last two axes; ``resize_bilinear`` and
``crop_padding`` take flows ``[H, W, C]`` or ``[B, H, W, C]``) on the
device of its input; each elementwise step is its own op, so no
multiply-add is ever contracted, a batch gives each plane the bits it
gets alone, and the results are those of the JAX package's written
operation order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pad(img: torch.Tensor, lrtb, mode: str) -> torch.Tensor:
    # F.pad's reflect and replicate modes want a channel axis: [1, (B,) H, W].
    return F.pad(img[None], lrtb, mode=mode)[0]


def reflect101_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect-101 border (``cv::BORDER_DEFAULT``: the edge pixel is not
    repeated), which is PyTorch's ``reflect`` mode."""
    return _pad(img, (r, r, r, r), "reflect")


def replicate_pad(img: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    return _pad(img, (l, r, t, b), "replicate")


def constant_pad(img: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    return F.pad(img, (l, r, t, b))


def sobel3(img: torch.Tensor, axis: str) -> torch.Tensor:
    """3x3 Sobel, scale 1/8, reflect-101 border (``cv::Sobel``;
    main.cpp:19-20,34-35): ``d = p[c+1] - p[c-1]`` across the axis, then
    ``(d[r-1] + 2 d[r]) + d[r+1]`` along the other, then ``* 0.125``."""
    p = reflect101_pad(img, 1)
    if axis == "x":
        d = p[..., 2:] - p[..., :-2]
        out = d[..., :-2, :] + 2.0 * d[..., 1:-1, :] + d[..., 2:, :]
    elif axis == "y":
        d = p[..., 2:, :] - p[..., :-2, :]
        out = d[..., :-2] + 2.0 * d[..., 1:-1] + d[..., 2:]
    else:
        raise ValueError(axis)
    return out * 0.125


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as ``sqrtf`` in the kernels.

    PyTorch's vectorized CPU ``sqrt`` is not correctly rounded, in
    float32 (about 1 value in 160 off by 1 ulp) nor in float64, and which
    values it misses depends on how the work is split across threads, so
    even the float64 root rounded to float32 differs from run to run in
    rare values.  Here that rounded root ``y`` is within 1 ulp of the
    correct one, and an exact float64 test picks it or a neighbour: the
    midpoint ``m`` between ``y`` and a neighbour has 25 significant bits,
    so ``m * m`` is exact in float64, and ``x`` is never equal to it."""
    y = torch.sqrt(x.double()).float()
    xd, yd = x.double(), y.double()
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.zeros_like(y))
    m_up = (yd + up.double()) * 0.5
    m_down = (yd + down.double()) * 0.5
    return torch.where(xd > m_up * m_up, up,
                       torch.where(xd < m_down * m_down, down, y))


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude, the pyramid's base image (Q1,
    main.cpp:18-26)."""
    dx = sobel3(img, "x")
    dy = sobel3(img, "y")
    return sqrt_f32(dx * dx + dy * dy)


def resize_half(img: torch.Tensor) -> torch.Tensor:
    """``cv::resize(x0.5, INTER_LINEAR)`` == exact 2x2 box mean for even
    dims (main.cpp:29), with the association ``((a + c) + (b + d)) *
    0.25`` (row pairs first) of the JAX package's ``window2`` route."""
    h, w = img.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(
            f"resize_half requires even dims, got {h}x{w}: the pipeline "
            "always passes 2^coarsest-divisible planes (pad_divisible)")
    s = img[..., 0::2, :] + img[..., 1::2, :]
    return (s[..., 0::2] + s[..., 1::2]) * 0.25


def resize_bilinear(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """General ``cv::resize(..., INTER_LINEAR)`` with pixel-center
    alignment ``src = (dst + 0.5) * scale - 0.5`` and edge clamping
    (main.cpp:195).  ``img`` is [H, W], [H, W, C] or, with a leading
    pair axis, [B, H, W, C]."""
    ya = 1 if img.ndim == 4 else 0          # the row axis
    in_h, in_w = img.shape[ya:ya + 2]
    dev = img.device
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (in_w / out_w) - 0.5
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (in_h / out_h) - 0.5
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    ax = torch.where(x0 < 0, torch.zeros_like(xs), xs - x0)
    ay = torch.where(y0 < 0, torch.zeros_like(ys), ys - y0)
    x0c = x0.clamp(0, in_w - 1)
    x1c = (x0 + 1).clamp(0, in_w - 1)
    rows0 = img.index_select(ya, y0.clamp(0, in_h - 1))
    rows1 = img.index_select(ya, (y0 + 1).clamp(0, in_h - 1))
    lead, extra = (1,) * ya, (1,) * (img.ndim - ya - 2)
    axb = ax.view(*lead, 1, out_w, *extra)
    ayb = ay.view(*lead, out_h, 1, *extra)
    xa = ya + 1
    top = rows0.index_select(xa, x0c) * (1 - axb) + rows0.index_select(xa, x1c) * axb
    bot = rows1.index_select(xa, x0c) * (1 - axb) + rows1.index_select(xa, x1c) * axb
    return top * (1 - ayb) + bot * ayb


def pad_divisible(img: torch.Tensor, coarsest_scale: int
                  ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Replicate-pad so dims are divisible by 2**coarsest (main.cpp:140-155).
    ``img`` is [H, W] or [B, H, W]."""
    h, w = img.shape[-2:]
    f = 2 ** coarsest_scale
    padw = (f - w % f) % f
    padh = (f - h % f) % f
    if padw or padh:
        img = replicate_pad(img, padh // 2, padh - padh // 2,
                            padw // 2, padw - padw // 2)
    return img, (padw, padh)


def crop_padding(flow: torch.Tensor, padw: int, padh: int, w_org: int,
                 h_org: int) -> torch.Tensor:
    """Undo :func:`pad_divisible` on ``flow`` [H, W(, C)] or [B, H, W, C]."""
    t = padh // 2
    l = padw // 2
    if flow.ndim == 4:
        return flow[:, t:t + h_org, l:l + w_org]
    return flow[t:t + h_org, l:l + w_org]
