"""Middlebury flow colorization (color_coding.cpp:8-117); a copy of
``dis_tpu/utils/color.py`` (NumPy only), held equal by
``tests/test_torch_utils.py``.

55-entry color wheel (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6), angle
``atan2(-fy, -fx) / pi``, saturation increasing with radius; invalid
flow (NaN or |.| >= 1e9) renders black.  Default per-frame auto
normalization by the max radius (quirk Q12: colors are then not
comparable across frames), matching ``draw_optical_flow``'s
``maxmotion=-1`` default (color_coding.hpp:7).

Vectorized NumPy; output is BGR uint8 like the reference (it writes
``pix[2 - b]``, color_coding.cpp:77).
"""

from __future__ import annotations

import numpy as np

_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
NCOLS = _RY + _YG + _GC + _CB + _BM + _MR  # 55


def make_color_wheel() -> np.ndarray:
    """[NCOLS, 3] int RGB wheel (color_coding.cpp:21-53)."""
    wheel = np.zeros((NCOLS, 3), dtype=np.int64)
    k = 0
    for i in range(_RY):
        wheel[k] = (255, 255 * i // _RY, 0); k += 1
    for i in range(_YG):
        wheel[k] = (255 - 255 * i // _YG, 255, 0); k += 1
    for i in range(_GC):
        wheel[k] = (0, 255, 255 * i // _GC); k += 1
    for i in range(_CB):
        wheel[k] = (0, 255 - 255 * i // _CB, 255); k += 1
    for i in range(_BM):
        wheel[k] = (255 * i // _BM, 0, 255); k += 1
    for i in range(_MR):
        wheel[k] = (255, 0, 255 - 255 * i // _MR); k += 1
    return wheel


_WHEEL = make_color_wheel()


def is_flow_correct(flow: np.ndarray) -> np.ndarray:
    """[H, W] validity mask (color_coding.cpp:8-11)."""
    fx, fy = flow[..., 0], flow[..., 1]
    return (np.isfinite(fx) & np.isfinite(fy)
            & (np.abs(fx) < 1e9) & (np.abs(fy) < 1e9))


def compute_color(fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Per-pixel BGR uint8 for *normalized* flow (color_coding.cpp:13-81)."""
    fx = np.asarray(fx, np.float32)
    fy = np.asarray(fy, np.float32)
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.float32(np.pi)
    fk = (a + 1.0) / 2.0 * (NCOLS - 1)
    k0 = fk.astype(np.int32)
    k1 = (k0 + 1) % NCOLS
    f = (fk - k0).astype(np.float32)

    col0 = _WHEEL[k0] / 255.0  # [..., 3] RGB
    col1 = _WHEEL[k1] / 255.0
    col = (1 - f[..., None]) * col0 + f[..., None] * col1
    small = rad <= 1
    col = np.where(small[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    rgb = (255.0 * col).astype(np.uint8)
    return rgb[..., ::-1]  # BGR like the reference


def draw_optical_flow(flow: np.ndarray, maxmotion: float = -1.0) -> np.ndarray:
    """Colorize a [H, W, 2] flow field -> [H, W, 3] BGR uint8
    (color_coding.cpp:83-117).  Uses the native rasterizer when built."""
    from . import native

    if native.available():
        out = native.flow_to_bgr(np.asarray(flow, np.float32), maxmotion)
        if out is not None:
            return out
    valid = is_flow_correct(flow)
    fx = np.where(valid, flow[..., 0], 0.0)
    fy = np.where(valid, flow[..., 1], 0.0)
    if maxmotion <= 0:
        rad = np.sqrt(fx * fx + fy * fy)
        maxrad = max(1.0, float(rad[valid].max()) if valid.any() else 1.0)
    else:
        maxrad = float(maxmotion)
    img = compute_color(fx / maxrad, fy / maxrad)
    img[~valid] = 0
    return img
