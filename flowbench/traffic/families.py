"""The seven synthetic motion families, with exact ground truth, in
PyTorch: a rewrite of the program's ``utils/synth.py`` (NumPy and SciPy)
that runs on the card, held to it by
``flowbench/tests/test_flowbench_traffic.py``.

Each family makes one pair from a texture drawn by ``rand(shape)``, a
callable returning uniform float64 draws in [0, 1) in the order that
``numpy.random.Generator.random`` would be called: the benchmark passes
a ``torch.Generator`` on the card, the test NumPy's, so the two agree to
rounding.  SciPy's pieces are restated: ``convolve2d(..., "same",
"symm")`` of a 7 x 7 box as a mean over a symmetric pad, and the cubic
spline of ``map_coordinates``/``zoom`` (``order=3, mode="nearest"``) as
its exact prefilter (the inverse of [1, 4, 1] / 6, an impulse response
``sqrt(3) * z**|k|``, ``z = sqrt(3) - 2``, truncated where it falls
under 1e-11) and the 16-tap B-spline sum.

A pair is (img1 [H, W] float32, img2 [H, W] float32, flow [H, W, 2]
float32, valid [H, W] bool), with ``img2(x + flow(x)) = img1(x)``.
Parameters default to ``synth``'s.  Beyond ``synth``, a mix may choose
each family's texture: ``"box"`` (``synth``'s smoothed uniform noise) or
``"natural"`` (``natural_warp``'s multi-octave noise, whose amplitude
halves with the wavelength: the 1/f spectrum of natural images), and an
affine family's ``margin``, the texture's border beyond the frame, which
a motion larger than it would fill with the border's smear.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Rand = Callable[[Tuple[int, ...]], torch.Tensor]
Pair = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_Z = math.sqrt(3.0) - 2.0
_TAPS = 20                      # |z|**20 * sqrt(3) < 1e-11
_NPAD = 12                      # SciPy's edge pad before its prefilter


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of [-r, n + r) reflected with the edge repeated."""
    i = torch.arange(-r, n + r, device=device)
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def _mirror_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of [-r, n + r) reflected without repeating the edge."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _box7(img: torch.Tensor) -> torch.Tensor:
    """``convolve2d(img, ones((7, 7)) / 49, "same", "symm")``."""
    h, w = img.shape
    ri, ci = _symmetric_index(h, 3, img.device), _symmetric_index(w, 3, img.device)
    p = img[ri][:, ci]
    return F.avg_pool2d(p[None, None], 7, stride=1)[0, 0]


def _texture(rand: Rand, h: int, w: int, smooth: int = 2) -> torch.Tensor:
    img = (rand((h, w)) * 255).to(torch.float32).to(torch.float64)
    for _ in range(smooth):
        img = _box7(img)
    return img.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _axis_prefilter(n: int, device: str = "cpu") -> torch.Tensor:
    """[n + 2 * _NPAD, n] float64 on ``device``: one axis's edge pad by
    ``_NPAD`` and SciPy's mirror-boundary prefilter, as one matrix, built
    on the CPU (an accumulation in a fixed order)."""
    m = n + 2 * _NPAD
    src = torch.arange(-_NPAD, n + _NPAD).clamp(0, n - 1)
    ext = _mirror_index(m, _TAPS, "cpu")
    k = torch.arange(2 * _TAPS + 1)
    taps = math.sqrt(3.0) * _Z ** (k - _TAPS).abs().to(torch.float64)
    rows = torch.arange(m).repeat_interleave(len(k))
    ks = k.repeat(m)
    mat = torch.zeros((m, n), dtype=torch.float64)
    mat.index_put_((rows, src[ext[rows + ks]]), taps[ks], accumulate=True)
    return mat.to(device)


def _prefilter(img: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficients of ``img`` edge-padded by ``_NPAD``,
    with mirror boundaries, as SciPy's ``spline_filter``; float64."""
    x = img.to(torch.float64)
    dev = str(x.device)
    return _axis_prefilter(x.shape[0], dev) @ x @ _axis_prefilter(x.shape[1], dev).T


def _bspline_weights(t: torch.Tensor):
    s = 1.0 - t
    return (s * s * s / 6.0, (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0,
            (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / 6.0, t * t * t / 6.0)


def _spline_eval(coef: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The cubic spline of coefficients ``coef`` (padded by ``_NPAD``) at
    coordinates (ys, xs), arrays of one shape, of the unpadded image;
    float64."""
    ys, xs = ys + _NPAD, xs + _NPAD
    fy, fx = torch.floor(ys), torch.floor(xs)
    wy, wx = _bspline_weights(ys - fy), _bspline_weights(xs - fx)
    iy, ix = fy.long() - 1, fx.long() - 1
    hmax, wmax = coef.shape[0] - 1, coef.shape[1] - 1
    out = torch.zeros_like(ys)
    for a in range(4):
        for b in range(4):
            out += wy[a] * wx[b] * coef[(iy + a).clamp(0, hmax), (ix + b).clamp(0, wmax)]
    return out


def _sample(tex: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(tex, [ys, xs], order=3, mode="nearest")``."""
    return _spline_eval(_prefilter(tex), ys, xs).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _axis_upsample(n: int, m: int, device: str = "cpu") -> torch.Tensor:
    """[m, n] float64 on ``device``: the spline of ``_upsample`` along one
    axis, from n samples to m (its prefilter included), as one matrix,
    built on the CPU."""
    pos = torch.arange(m, dtype=torch.float64) * ((n - 1) / (m + 1)) + _NPAD
    base = torch.floor(pos)
    weights = _bspline_weights(pos - base)
    idx = base.long() - 1
    mat = torch.zeros((m, n + 2 * _NPAD), dtype=torch.float64)
    rows = torch.arange(m)
    for a in range(4):
        mat.index_put_((rows, (idx + a).clamp(0, n + 2 * _NPAD - 1)), weights[a],
                       accumulate=True)
    return (mat @ _axis_prefilter(n)).to(device)


def _upsample(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``zoom(coarse, ((h + 2) / ch, (w + 2) / cw), order=3,
    mode="nearest")[:h, :w]``: output index o samples o * (n - 1) / (m - 1);
    float64.  The sample points form a grid, so the spline is separable:
    one matrix an axis."""
    ch, cw = coarse.shape
    dev = str(coarse.device)
    return _axis_upsample(ch, h, dev) @ coarse.to(torch.float64) @ _axis_upsample(cw, w, dev).T


def _natural_texture(rand: Rand, h: int, w: int) -> torch.Tensor:
    img = None
    amp = 1.0
    for wavelength in (64, 32, 16, 8, 4):
        ch, cw = max(2, -(-h // wavelength) + 1), max(2, -(-w // wavelength) + 1)
        up = amp * _upsample(rand((ch, cw)), h, w)
        img = up if img is None else img + up
        amp *= 0.5
    img = img / img.max()
    flat = _upsample(rand((max(2, h // 48) + 1, max(2, w // 48) + 1)), h, w)
    flat = torch.floor(flat.clamp(0.0, 0.999) * 4) / 3.0
    img = 0.55 * img + 0.45 * flat
    img = img - img.min()
    img = img / max(float(img.max()), 1e-9)
    return (img * 255.0).to(torch.float32)


def _grid(h: int, w: int, device):
    return torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")


def _make_texture(kind: str, rand: Rand, h: int, w: int, smooth: int = 2) -> torch.Tensor:
    if kind == "box":
        return _texture(rand, h, w, smooth)
    if kind == "natural":
        return _natural_texture(rand, h, w)
    raise ValueError(f"texture must be 'box' or 'natural', got {kind!r}")


def _affine_pair(rand: Rand, h: int, w: int, A, t, device, texture: str = "box",
                 margin: int = 32) -> Pair:
    tex = _make_texture(texture, rand, h + 2 * margin, w + 2 * margin)
    i1 = tex[margin:margin + h, margin:margin + w].clone()
    ys, xs = _grid(h, w, device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    px, py = xs - cx, ys - cy
    wx = cx + A[0][0] * px + A[0][1] * py + t[0]
    wy = cy + A[1][0] * px + A[1][1] * py + t[1]
    flow = torch.stack([wx - xs, wy - ys], -1).to(torch.float32)
    det = A[0][0] * A[1][1] - A[0][1] * A[1][0]
    Ai = ((A[1][1] / det, -A[0][1] / det), (-A[1][0] / det, A[0][0] / det))
    qx, qy = xs - cx - t[0], ys - cy - t[1]
    sx = cx + Ai[0][0] * qx + Ai[0][1] * qy
    sy = cy + Ai[1][0] * qx + Ai[1][1] * qy
    i2 = _sample(tex, sy + margin, sx + margin)
    ok = ((sx >= -margin + 2) & (sx <= w + margin - 3)
          & (sy >= -margin + 2) & (sy <= h + margin - 3))
    return i1, i2, flow, ok


def translation(rand, h, w, device, shift=(2.0, 1.0), **tex) -> Pair:
    return _affine_pair(rand, h, w, ((1.0, 0.0), (0.0, 1.0)), tuple(shift), device, **tex)


def rotation(rand, h, w, device, degrees=1.5, **tex) -> Pair:
    th = math.radians(degrees)
    A = ((math.cos(th), -math.sin(th)), (math.sin(th), math.cos(th)))
    return _affine_pair(rand, h, w, A, (0.0, 0.0), device, **tex)


def zoom(rand, h, w, device, scale=1.03, **tex) -> Pair:
    return _affine_pair(rand, h, w, ((scale, 0.0), (0.0, scale)), (0.0, 0.0), device, **tex)


def shear(rand, h, w, device, kx=0.02, ky=0.01, **tex) -> Pair:
    return _affine_pair(rand, h, w, ((1.0, kx), (ky, 1.0)), (1.0, -0.5), device, **tex)


def discontinuous(rand, h, w, device, fg_rand: Rand = None, bg_shift=(1.0, 0.0),
                  fg_shift=(-2.0, 2.0), radius_frac=0.22, texture: str = "box") -> Pair:
    """An occluding disk moving against the background; ``fg_rand`` draws
    the disk's texture (``synth``'s seed + 1000)."""
    margin = 32
    bg = _make_texture(texture, rand, h + 2 * margin, w + 2 * margin)
    fg = _make_texture(texture, fg_rand, h + 2 * margin, w + 2 * margin, smooth=1)
    ys, xs = _grid(h, w, device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rad = radius_frac * min(h, w)

    def disk(ox, oy):
        return (xs - cx - ox) ** 2 + (ys - cy - oy) ** 2 <= rad ** 2

    d1 = disk(0, 0)
    i1 = torch.where(d1, fg[margin:margin + h, margin:margin + w],
                     bg[margin:margin + h, margin:margin + w])
    i2 = _sample(bg, ys + margin - bg_shift[1], xs + margin - bg_shift[0])
    d2 = disk(fg_shift[0], fg_shift[1])
    fg2 = _sample(fg, ys + margin - fg_shift[1], xs + margin - fg_shift[0])
    i2 = torch.where(d2, fg2, i2)
    flow = torch.empty((h, w, 2), dtype=torch.float32, device=device)
    flow[..., 0] = torch.where(d1, float(fg_shift[0]), float(bg_shift[0]))
    flow[..., 1] = torch.where(d1, float(fg_shift[1]), float(bg_shift[1]))
    tgt = ((xs + flow[..., 0] - cx - fg_shift[0]) ** 2
           + (ys + flow[..., 1] - cy - fg_shift[1]) ** 2 <= rad ** 2)
    occluded = ~d1 & tgt
    band = torch.abs(torch.sqrt((xs - cx) ** 2 + (ys - cy) ** 2) - rad) < 10.0
    return i1, i2, flow, ~(occluded | band)


def _warped_pair(tex, h, w, amp, periods, margin, device) -> Pair:
    i1 = tex[margin:margin + h, margin:margin + w].clone()
    ys, xs = _grid(h, w, device)
    fx, fy = 2 * math.pi * periods / w, 2 * math.pi * periods / h

    def u_of(x, y):
        return (amp * torch.sin(fx * x) * torch.cos(fy * y),
                amp * torch.cos(fx * x) * torch.sin(fy * y + 1.0))

    ux, uy = u_of(xs, ys)
    flow = torch.stack([ux, uy], -1).to(torch.float32)
    sx, sy = xs.clone(), ys.clone()
    for _ in range(8):
        vx, vy = u_of(sx, sy)
        sx, sy = xs - vx, ys - vy
    i2 = _sample(tex, sy + margin, sx + margin)
    return i1, i2, flow, torch.ones((h, w), dtype=torch.bool, device=device)


def smooth_warp(rand, h, w, device, amp=2.0, periods=1.5, texture: str = "box") -> Pair:
    margin = 32
    return _warped_pair(_make_texture(texture, rand, h + 2 * margin, w + 2 * margin), h, w,
                        amp, periods, margin, device)


def natural_warp(rand, h, w, device, amp=2.0, periods=1.5) -> Pair:
    margin = 32
    return _warped_pair(_natural_texture(rand, h + 2 * margin, w + 2 * margin), h, w,
                        amp, periods, margin, device)


FAMILIES: Dict[str, Callable[..., Pair]] = {
    "translation": translation, "rotation": rotation, "zoom": zoom, "shear": shear,
    "discontinuous": discontinuous, "smooth_warp": smooth_warp,
    "natural_warp": natural_warp,
}
