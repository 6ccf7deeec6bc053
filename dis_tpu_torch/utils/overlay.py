"""Debug grid overlay (C12): patch rectangles + displacement vectors; a
copy of ``dis_tpu/utils/overlay.py`` (NumPy only), held equal by
``tests/test_torch_utils.py``.

Reference: ``draw_patch_borders`` and the draw_grid block
(optical_flow.cpp:92-145) — red patch borders at ``center ± ps/2`` and
green lines from each patch center to its displaced position, drawn on
the upscaled level image.  Pure NumPy rasterization (no OpenCV).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
               color) -> None:
    """Simple DDA line draw in-place on [H, W, 3] uint8."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2 + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    xi = np.round(xs).astype(int)
    yi = np.round(ys).astype(int)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[ok], xi[ok]] = color


def draw_grid_overlay(level_img: np.ndarray, centers: np.ndarray,
                      u: np.ndarray, scale: int, patch_size: int = 8,
                      max_patches: Optional[int] = 4000) -> np.ndarray:
    """Render the patch grid and per-patch flows on a level image.

    ``level_img``: unpadded [h, w] float level image; ``centers``/``u``:
    [N, 2] patch centers and displacements at that scale.  Output is
    upscaled by ``2**scale`` (nearest) like the reference
    (optical_flow.cpp:103) with red borders and green displacement
    vectors (optical_flow.cpp:117,141-144); BGR uint8.
    """
    sc = float(2 ** scale)
    im = np.clip(level_img, 0, 255).astype(np.uint8)
    im = np.repeat(np.repeat(im, int(sc), axis=0), int(sc), axis=1)
    out = np.stack([im, im, im], axis=-1)

    red = np.array([0, 0, 255], np.uint8)    # BGR
    green = np.array([0, 255, 0], np.uint8)
    lb = -patch_size / 2
    ub = patch_size / 2 - 1

    n = centers.shape[0]
    step = 1 if max_patches is None or n <= max_patches else n // max_patches
    for i in range(0, n, step):
        cx, cy = centers[i]
        x0 = (cx + lb + 0.5) * sc
        x1 = (cx + ub + 0.5) * sc
        y0 = (cy + lb + 0.5) * sc
        y1 = (cy + ub + 0.5) * sc
        _draw_line(out, x0, y0, x1, y0, red)
        _draw_line(out, x1, y0, x1, y1, red)
        _draw_line(out, x1, y1, x0, y1, red)
        _draw_line(out, x0, y1, x0, y0, red)
    for i in range(0, n, step):
        cx, cy = centers[i]
        qx, qy = centers[i] + u[i]
        _draw_line(out, (cx + 0.5) * sc, (cy + 0.5) * sc,
                   (qx + 0.5) * sc, (qy + 0.5) * sc, green)
    return out
