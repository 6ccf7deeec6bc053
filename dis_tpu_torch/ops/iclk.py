"""Batched inverse-compositional Lucas-Kanade patch search; counterpart
of ``dis_tpu/ops/iclk.py``.

The reference runs one mutable state machine per patch, sequentially
(patch.cpp:119-203).  Here the whole grid is a struct-of-arrays batch;
frozen patches keep their state, which preserves the reference's
per-patch semantics (a frozen patch's ``u`` never changes again).

Quirk-compat details (SURVEY.md section 2):

- Q3: ``delta_u = H^-1 [sum(Tdx*Q); sum(Tdy*Q)]`` in compat mode; fixed
  mode uses the residual ``Q - Tn`` (Tn: the mean-normalized template
  when patch_normalization is on).
- Q5: the loop body runs ``iterations + 1`` times unless policing (or,
  in fixed mode, ``|delta_u| < conv_eps``) freezes the patch.
- Q9: policing resets ``u`` to the scale's init and freezes the patch
  when it moves more than ``patch_size/2`` from its start or leaves the
  valid region (patch.cpp:185-194).
- Q10: bilinear taps are addressed from ``ceil(pos + 1e-5)`` in float32.

The search reads each patch's (2ps+3)^2 sampling region, extracted once
per scale (kernel K2, ``ops/cuda/extract_kernel.py``); the iteration
loop is kernel K1 (``ops/cuda/iclk_kernel.py``).  This module holds both
kernels' plain PyTorch versions (:func:`extract_regions_plain`,
:func:`iclk_search_plain`), which the wrappers take for CPU tensors.

A batch of pairs adds a leading axis to every per-patch tensor
(``[B, N, ...]``; the centers ``[N, 2]`` stay shared).  Every step is an
elementwise op, an index pick or :func:`pairwise_sum`'s fixed tree, so
each pair of a batch gets the bits it gets alone.

Every sum over a patch's taps (Hessian, ``rhs``, the patch mean) uses
:func:`pairwise_sum`'s forced pair tree, which K1 reproduces with an
in-lane tree plus a warp butterfly, so kernel and plain version agree
bitwise.  (The JAX package's search sums ``rhs`` and the mean with a
compiler-chosen order; the port agrees with it to the equivalence class
of ``tests/test_pallas_iclk.py``, not bitwise.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DISConfig
from .image import sqrt_f32


class PatchTemplates(NamedTuple):
    T: torch.Tensor      # [(B,) N, ps*ps] raw template values
    Tdx: torch.Tensor    # [(B,) N, ps*ps] template d/dx
    Tdy: torch.Tensor    # [(B,) N, ps*ps] template d/dy
    Hinv: torch.Tensor   # [(B,) N, 2, 2] inverse 2x2 Hessian


class SearchResult(NamedTuple):
    u: torch.Tensor          # [(B,) N, 2] final displacement per patch
    Q: torch.Tensor          # [(B,) N, ps*ps] final warped query patch
    converged: torch.Tensor  # [(B,) N] bool
    start_oob: torch.Tensor  # [(B,) N] bool: start out of bounds, so the
    #                          patch froze at once and Q is the raw template


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis with the pair tree of the JAX package's
    ``pairwise_sum``: pairs (0,1)(2,3)... per level, odd lengths padded
    with one zero.  (Equal to zero-padding to a power of two first, since
    ``x + 0 == x``; that is the form K1 uses.)"""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def inv_taps(ps: int) -> float:
    """``float32(1 / ps^2)``, the patch-mean factor, as the JAX package
    rounds it."""
    return float(np.float32(1.0 / (ps * ps)))


def extract_templates_grid(img: torch.Tensor, dx: torch.Tensor,
                           dy: torch.Tensor, geom, ps: int,
                           pad: int) -> PatchTemplates:
    """Templates and inverse Hessians for a regular patch grid
    (patch.cpp:47-91) over padded level planes [(B,) th, tw].  Each tap
    is a strided view of the plane; patches come out in the reference's
    x-outer order."""
    s = geom.steps
    half = ps // 2
    nw, nh = geom.num_w, geom.num_h
    n = nw * nh
    y0 = geom.offset_h - half + pad
    x0 = geom.offset_w - half + pad

    def taps(plane):
        win = plane[..., y0:y0 + (nh - 1) * s + ps, x0:x0 + (nw - 1) * s + ps]
        t = win.unfold(-2, ps, s).unfold(-2, ps, s)  # [..., nh, nw, ps(j), ps(i)]
        return t.transpose(-4, -3).reshape(*plane.shape[:-2], n, ps * ps)

    T, Tdx, Tdy = taps(img), taps(dx), taps(dy)
    a = pairwise_sum(Tdx * Tdx)
    b = pairwise_sum(Tdx * Tdy)
    c = pairwise_sum(Tdy * Tdy)
    return templates_from_hessian(T, Tdx, Tdy, a, b, c)


def templates_from_hessian(T, Tdx, Tdy, a, b, c) -> PatchTemplates:
    """2x2 Gauss-Newton Hessian inverse with the ``det == 0`` guard of
    1e-10 (patch.cpp:75-91)."""
    det = a * c - b * b
    guard = torch.where(det == 0, torch.full_like(det, 1e-10),
                        torch.zeros_like(det))
    a = a + guard
    c = c + guard
    det = a * c - b * b
    inv_det = 1.0 / det
    Hinv = torch.stack(
        [torch.stack([c * inv_det, -b * inv_det], -1),
         torch.stack([-b * inv_det, a * inv_det], -1)], -2)
    return PatchTemplates(T=T, Tdx=Tdx, Tdy=Tdy, Hinv=Hinv)


def region_size(ps: int) -> int:
    """Side of a patch's sampling region: policing keeps every bilinear
    window within ``ps/2`` of the start, so all of a patch's windows lie
    in a (2ps+1)^2 neighborhood; two more rows/cols cover float32 slack
    at the policing boundary."""
    return 2 * ps + 3


def _ceil_coord(v: torch.Tensor, pad: int) -> torch.Tensor:
    """Q10 tap base ``ceil(v + 1e-5)`` in float32, clipped before the int
    cast so that far out-of-range (frozen) positions stay defined."""
    return torch.ceil(v + 1e-5).clamp(-1e6, 1e6).to(torch.int32) + pad


def extract_regions_plain(img2: torch.Tensor, pos0: torch.Tensor, ps: int,
                          pad: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels K2 and K2b: each patch's [rc, rc] window
    of the padded level plane [(B,) th, tw] at ``base = clip(ceil(pos0 +
    1e-5) + pad - ps - 2, 0, dim - rc)``, for start positions [(B,) N, 2].
    Returns (regions [(B,) N, rc, rc], base_y, base_x [(B,) N] int32)."""
    th, tw = img2.shape[-2:]
    lead = img2.shape[:-2]
    rc = region_size(ps)
    base_y = (_ceil_coord(pos0[..., 1], pad) - ps - 2).clamp(0, th - rc)
    base_x = (_ceil_coord(pos0[..., 0], pad) - ps - 2).clamp(0, tw - rc)
    ar = torch.arange(rc, device=img2.device)
    idx = ((base_y.long()[..., None, None] + ar[:, None]) * tw
           + base_x.long()[..., None, None] + ar)          # [..., N, rc, rc]
    flat = img2.reshape(*lead, th * tw)
    regions = flat.gather(-1, idx.reshape(*lead, -1)).reshape(idx.shape)
    return regions, base_y, base_x


def sample_from_regions(regions: torch.Tensor, base_y: torch.Tensor,
                        base_x: torch.Tensor, pos: torch.Tensor, ps: int,
                        pad: int, normalize: bool) -> torch.Tensor:
    """Bilinear warped query patches [(B,) N, ps*ps] from the regions
    (patch.cpp:207-267): a direct 4-tap bilinear, column blend
    ``(1-a) w[c] + a w[c+1]`` first, then row blend ``(1-b) r[j] + b
    r[j+1]``, with the Q10 tap base."""
    rc = regions.shape[-1]
    lead = regions.shape[:-2]                              # (B,) N
    half = ps // 2
    posx, posy = pos[..., 0], pos[..., 1]
    a = (posx - torch.floor(posx))[..., None, None]
    b = (posy - torch.floor(posy))[..., None, None]
    ws = (_ceil_coord(posy, pad) - half - 1 - base_y).clamp(0, rc - (ps + 1))
    cs = (_ceil_coord(posx, pad) - half - 1 - base_x).clamp(0, rc - (ps + 1))
    ar = torch.arange(ps + 1, device=regions.device)
    idx = ((ws.long()[..., None, None] + ar[:, None]) * rc
           + cs.long()[..., None, None] + ar)
    W = regions.reshape(*lead, rc * rc).gather(-1, idx.reshape(*lead, (ps + 1) ** 2))
    W = W.reshape(*lead, ps + 1, ps + 1)
    cb = (1 - a) * W[..., :, :-1] + a * W[..., :, 1:]     # [..., ps+1, ps]
    q = ((1 - b) * cb[..., :-1, :] + b * cb[..., 1:, :]).reshape(*lead, ps * ps)
    if normalize:
        q = q - pairwise_sum(q)[..., None] * inv_taps(ps)
    return q


def out_of_bounds(pos: torch.Tensor, ps: int, width: int,
                  height: int) -> torch.Tensor:
    """Valid-region test of optical_flow.cpp:55-57: ``lb = -ps/2``,
    ``ub = dim + ps/2 - 2``."""
    lb = -float(ps) / 2.0
    return ((pos[..., 0] < lb) | (pos[..., 1] < lb)
            | (pos[..., 0] > float(width + ps // 2 - 2))
            | (pos[..., 1] > float(height + ps // 2 - 2)))


def iclk_search_plain(regions: torch.Tensor, base_y: torch.Tensor,
                      base_x: torch.Tensor, tpl: PatchTemplates,
                      Tn: Optional[torch.Tensor], centers: torch.Tensor,
                      init_u: torch.Tensor, conv0: torch.Tensor,
                      cfg: DISConfig, width: int, height: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels K1 and K1b: the IC-LK loop for every
    patch at one scale.  ``Tn`` is the fixed-mode residual template (None
    in compat mode); ``centers`` [N, 2] is shared by the pairs of a batch.
    Returns (u [(B,) N, 2], Q [(B,) N, ps*ps], converged [(B,) N] bool)."""
    ps, pad = cfg.patch_size, cfg.img_padding
    fixed = cfg.mode == "fixed"
    thresh = cfg.outlier_thresh
    Hinv = tpl.Hinv

    def sample(p):
        return sample_from_regions(regions, base_y, base_x, p, ps, pad,
                                   cfg.patch_normalization)

    start = centers + init_u
    u = init_u.clone()
    Q = torch.where(conv0[..., None], tpl.T, sample(start))
    conv = conv0.clone()
    for _ in range(cfg.iterations + 1):
        active = ~conv
        R = Q - Tn if fixed else Q
        rx = pairwise_sum(tpl.Tdx * R)
        ry = pairwise_sum(tpl.Tdy * R)
        dx = Hinv[..., 0, 0] * rx + Hinv[..., 0, 1] * ry
        dy = Hinv[..., 1, 0] * rx + Hinv[..., 1, 1] * ry
        u_new = torch.stack([u[..., 0] - dx, u[..., 1] - dy], -1)
        p_new = centers + u_new
        mx = start[..., 0] - p_new[..., 0]
        my = start[..., 1] - p_new[..., 1]
        dist = sqrt_f32(mx * mx + my * my)
        policed = (dist > thresh) | out_of_bounds(p_new, ps, width, height)
        u_next = torch.where(policed[..., None], init_u, u_new)
        u = torch.where(active[..., None], u_next, u)
        Q = torch.where(active[..., None], sample(centers + u), Q)
        newly = active & policed
        if fixed:
            small = sqrt_f32(dx * dx + dy * dy) < cfg.conv_eps
            newly = newly | (active & small)
        conv = conv | newly
    return u, Q, conv


def residual_template(tpl: PatchTemplates, cfg: DISConfig) -> torch.Tensor:
    """Fixed mode's ``Tn``: the template, mean-normalized when
    patch_normalization is on."""
    if not cfg.patch_normalization:
        return tpl.T
    return tpl.T - pairwise_sum(tpl.T)[..., None] * inv_taps(cfg.patch_size)


def inverse_search(img2: torch.Tensor, tpl: PatchTemplates,
                   centers: torch.Tensor, init_u: torch.Tensor,
                   cfg: DISConfig, width: int, height: int,
                   plain: bool = False) -> SearchResult:
    """Run the full IC-LK iteration for every patch at one scale:
    region extraction (K2), then the search loop (K1).  ``img2``
    [(B,) th, tw], ``tpl`` and ``init_u`` [(B,) N, 2] carry the pair axis
    of a batch (then K2b and K1b: still one launch each); ``centers``
    [N, 2] is shared.  ``plain=True`` runs both plain versions on any
    device."""
    from .cuda.extract_kernel import extract_regions
    from .cuda.iclk_kernel import iclk_search

    extract = extract_regions_plain if plain else extract_regions
    search = iclk_search_plain if plain else iclk_search
    ps = cfg.patch_size
    Tn = residual_template(tpl, cfg) if cfg.mode == "fixed" else None
    pos0 = centers + init_u
    conv0 = out_of_bounds(pos0, ps, width, height)
    regions, base_y, base_x = extract(img2, pos0, ps, cfg.img_padding)
    u, Q, conv = search(regions, base_y, base_x, tpl, Tn, centers, init_u,
                        conv0, cfg, width, height)
    return SearchResult(u=u, Q=Q, converged=conv, start_oob=conv0)
