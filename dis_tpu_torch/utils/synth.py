"""Synthetic motion-family fixtures with analytic ground truth; a copy
of ``dis_tpu/utils/synth.py`` (NumPy and SciPy only), held equal by
``tests/test_torch_synth.py``.

Seven motion families: translation, rotation, zoom, shear/affine,
discontinuous (occluding foreground), a smooth nonrigid warp, and the
nonrigid warp over a natural-statistics texture, all with exact ground
truth and a validity mask.

Flow convention (matches the pipeline and the reference: a patch with
template at x in I1 searches position x+u in I2, patch_grid.cpp:43-49):

    I2(x + u(x)) = I1(x)

so for a warp W mapping I1 coordinates to I2 coordinates with
I2(W(x)) = I1(x):  u(x) = W(x) - x, and I2 is synthesized by backward
sampling I2(y) = I1(W^{-1}(y)) from an oversized texture.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
#      (img1 [H,W] f32, img2 [H,W] f32, gt_flow [H,W,2] f32, valid [H,W] bool)


def _texture(h: int, w: int, seed: int, smooth: int = 2) -> np.ndarray:
    """Smooth random texture in [0, 255] with informative gradients at
    patch scale (same recipe as the round-1 fixtures)."""
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    img = (r.random((h, w)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    for _ in range(smooth):
        img = convolve2d(img, k, mode="same", boundary="symm")
    return img.astype(np.float32)


def _sample(tex: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    from scipy.ndimage import map_coordinates

    return map_coordinates(tex, [ys, xs], order=3, mode="nearest"
                           ).astype(np.float32)


def _upsample(coarse: np.ndarray, h: int, w: int) -> np.ndarray:
    from scipy.ndimage import zoom as _zoom

    up = _zoom(coarse, ((h + 2) / coarse.shape[0],
                        (w + 2) / coarse.shape[1]),
               order=3, mode="nearest")
    return up[:h, :w]


def _natural_texture(h: int, w: int, seed: int) -> np.ndarray:
    """Natural-image-statistics texture: multi-octave 1/f noise blended
    with piecewise-flat regions (quantized coarse field).  Unlike
    ``_texture`` (uniform-frequency smoothed noise, gradients
    everywhere), this has sparse gradients, step edges, and
    aperture-problem surfaces — the failure modes realistic imagery
    exposes in a local method.  Intensity in [0, 255]."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    amp = 1.0
    for wavelength in (64, 32, 16, 8, 4):
        ch = max(2, -(-h // wavelength) + 1)
        cw = max(2, -(-w // wavelength) + 1)
        img += amp * _upsample(r.random((ch, cw)), h, w)
        amp *= 0.5
    img /= img.max()
    # Piecewise-flat overlay: a very coarse field quantized to 4 levels
    # (textureless interiors + strong step edges).
    flat = _upsample(r.random((max(2, h // 48) + 1,
                               max(2, w // 48) + 1)), h, w)
    flat = np.floor(np.clip(flat, 0.0, 0.999) * 4) / 3.0
    img = 0.55 * img + 0.45 * flat
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return (img * 255.0).astype(np.float32)


def _affine_pair(h: int, w: int, A: np.ndarray, t: np.ndarray,
                 seed: int) -> Pair:
    """Pair under the affine warp W(x) = c + A (x - c) + t (c = frame
    center); I2 sampled as I1(W^{-1}(y)) from an oversized texture."""
    margin = 32
    tex = _texture(h + 2 * margin, w + 2 * margin, seed)
    i1 = tex[margin:margin + h, margin:margin + w].copy()

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    px = xs - c[0]
    py = ys - c[1]
    wx = c[0] + A[0, 0] * px + A[0, 1] * py + t[0]
    wy = c[1] + A[1, 0] * px + A[1, 1] * py + t[1]
    flow = np.stack([wx - xs, wy - ys], -1).astype(np.float32)

    Ai = np.linalg.inv(A)
    qx = xs - c[0] - t[0]
    qy = ys - c[1] - t[1]
    sx = c[0] + Ai[0, 0] * qx + Ai[0, 1] * qy
    sy = c[1] + Ai[1, 0] * qx + Ai[1, 1] * qy
    i2 = _sample(tex, sy + margin, sx + margin)

    ok = (sx >= -margin + 2) & (sx <= w + margin - 3) \
        & (sy >= -margin + 2) & (sy <= h + margin - 3)
    return i1, i2, flow, ok


def translation(h: int, w: int, shift=(2.0, 1.0), seed: int = 0) -> Pair:
    return _affine_pair(h, w, np.eye(2), np.asarray(shift, float), seed)


def rotation(h: int, w: int, degrees: float = 1.5, seed: int = 1) -> Pair:
    th = np.deg2rad(degrees)
    A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return _affine_pair(h, w, A, np.zeros(2), seed)


def zoom(h: int, w: int, scale: float = 1.03, seed: int = 2) -> Pair:
    return _affine_pair(h, w, np.eye(2) * scale, np.zeros(2), seed)


def shear(h: int, w: int, kx: float = 0.02, ky: float = 0.01,
          seed: int = 3) -> Pair:
    A = np.array([[1.0, kx], [ky, 1.0]])
    return _affine_pair(h, w, A, np.array([1.0, -0.5]), seed)


def discontinuous(h: int, w: int, bg_shift=(1.0, 0.0), fg_shift=(-2.0, 2.0),
                  radius_frac: float = 0.22, seed: int = 4) -> Pair:
    """Occluding disk moving against the background: a motion
    discontinuity plus genuinely occluded pixels (masked invalid)."""
    margin = 32
    bg = _texture(h + 2 * margin, w + 2 * margin, seed)
    fg = _texture(h + 2 * margin, w + 2 * margin, seed + 1000, smooth=1)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rad = radius_frac * min(h, w)

    def disk(ox, oy):
        return (xs - cx - ox) ** 2 + (ys - cy - oy) ** 2 <= rad ** 2

    bgs, fgs = np.asarray(bg_shift, float), np.asarray(fg_shift, float)
    d1 = disk(0, 0)
    i1 = bg[margin:margin + h, margin:margin + w].copy()
    i1[d1] = fg[margin:margin + h, margin:margin + w][d1]

    # I2: background translated by bg_shift (I2 = B(x - bg_shift)), disk
    # texture translated by fg_shift, drawn on top.
    i2 = _sample(bg, ys + margin - bgs[1], xs + margin - bgs[0])
    d2 = disk(fgs[0], fgs[1])
    fg2 = _sample(fg, ys + margin - fgs[1], xs + margin - fgs[0])
    i2[d2] = fg2[d2]

    flow = np.empty((h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = bgs[0], bgs[1]
    flow[d1] = fgs.astype(np.float32)

    # Invalid: background pixels whose correspondence is covered by the
    # disk in I2 (occluded), plus a band around the discontinuity where
    # patch support straddles both motions.
    tgt_in_disk = (xs + flow[..., 0] - cx - fgs[0]) ** 2 \
        + (ys + flow[..., 1] - cy - fgs[1]) ** 2 <= rad ** 2
    occluded = (~d1) & tgt_in_disk
    band = np.abs(np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2) - rad) < 10.0
    return i1, i2, flow, ~(occluded | band)


def _warped_pair(tex: np.ndarray, h: int, w: int, amp: float,
                 periods: float, margin: int) -> Pair:
    """Nonrigid low-frequency sinusoidal flow over ``tex``.

    The forward flow u is prescribed analytically; I2 is built by
    inverting x + u(x) = y with a fixed-point iteration so that
    I2(x + u(x)) = I1(x) holds to high accuracy.
    """
    i1 = tex[margin:margin + h, margin:margin + w].copy()

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def u_of(x, y):
        fx = 2 * np.pi * periods / w
        fy = 2 * np.pi * periods / h
        ux = amp * np.sin(fx * x) * np.cos(fy * y)
        uy = amp * np.cos(fx * x) * np.sin(fy * y + 1.0)
        return ux, uy

    ux, uy = u_of(xs, ys)
    flow = np.stack([ux, uy], -1).astype(np.float32)

    # invert: find x(y) with x + u(x) = y
    sx, sy = xs.copy(), ys.copy()
    for _ in range(8):
        vx, vy = u_of(sx, sy)
        sx = xs - vx
        sy = ys - vy
    i2 = _sample(tex, sy + margin, sx + margin)
    ok = np.ones((h, w), bool)
    return i1, i2, flow, ok


def smooth_warp(h: int, w: int, amp: float = 2.0, periods: float = 1.5,
                seed: int = 5) -> Pair:
    margin = 32
    return _warped_pair(_texture(h + 2 * margin, w + 2 * margin, seed),
                        h, w, amp, periods, margin)


def natural_warp(h: int, w: int, amp: float = 2.0, periods: float = 1.5,
                 seed: int = 6) -> Pair:
    """The smooth nonrigid warp over a NATURAL-statistics texture (1/f
    octaves + piecewise-flat regions): sparse gradients, step edges and
    textureless interiors — the round-1 VERDICT's "textured
    natural-like generator" where local-method divergence actually
    shows (flat regions carry no constraint; densification and the
    coarse-to-fine prior must fill them)."""
    margin = 32
    return _warped_pair(
        _natural_texture(h + 2 * margin, w + 2 * margin, seed),
        h, w, amp, periods, margin)


FAMILIES: Dict[str, callable] = {
    "translation": translation,
    "rotation": rotation,
    "zoom": zoom,
    "shear": shear,
    "discontinuous": discontinuous,
    "smooth_warp": smooth_warp,
    "natural_warp": natural_warp,
}


def make_pair(family: str, h: int, w: int, **kw) -> Pair:
    return FAMILIES[family](h, w, **kw)


def masked_epe(flow: np.ndarray, gt: np.ndarray, valid: np.ndarray,
               border: int = 12) -> float:
    """EPE over valid pixels away from the frame border (border patches
    are unconstrained in any local method)."""
    m = np.zeros_like(valid)
    m[border:-border, border:-border] = True
    m &= valid
    d = flow - gt
    return float(np.sqrt((d ** 2).sum(-1))[m].mean())
