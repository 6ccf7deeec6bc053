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

The search reads each patch's (2ps+3)^2 sampling region of the level
plane.  On the card it is one launch of kernel K1 in its plane mode
(``ops/cuda/iclk_kernel.py``), which copies each region straight from
the plane; that is the one path of every scale, stripe and window.  K2
(``ops/cuda/extract_kernel.py``), its batched form K2b, the
column-banded K2c (``ops/cuda/extract_banded_kernel.py``) and K1's
regions mode, which reads the regions they write, are standalone
kernels that tests hold bitwise against the plane mode and the plain
versions.  Before the
search, kernel S1 cuts the templates, inverts their Hessians and picks
each patch's start from the coarser flow (``ops/cuda/scale_kernel.py``).
This module holds the kernels' plain PyTorch versions
(:func:`extract_regions_plain`, one function for K2, K2b and K2c and
the plane mode's windows, :func:`iclk_search_plain`, and S1's
:func:`scale_templates_plain`: :func:`templates_plain` then
:func:`search_start_plain`), which the wrappers take for CPU tensors.

Exact tiling passes ``row0``: the global row of the first row of the
level planes, which then hold a stripe of the frame.  It moves only the
y tap base (``ceil(y + 1e-5) + pad - row0``); x keeps ``pad``.

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
from ..utils import checks
from .image import sqrt_f32


class PatchTemplates(NamedTuple):
    T: torch.Tensor      # [(B,) N, ps*ps] raw template values
    Tdx: torch.Tensor    # [(B,) N, ps*ps] template d/dx
    Tdy: torch.Tensor    # [(B,) N, ps*ps] template d/dy
    Hinv: torch.Tensor   # [(B,) N, 2, 2] inverse 2x2 Hessian


class Start(NamedTuple):
    init_u: torch.Tensor  # [(B,) N, 2] the init, x2 the coarser flow's NN pick
    pos0: torch.Tensor    # [(B,) N, 2] the start, centers + init_u
    conv0: torch.Tensor   # [(B,) N] bool: the start is out of bounds


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


def template_origin(geom, ps: int, pad: int, row0: int = 0) -> Tuple[int, int]:
    """(y0, x0): the plane row and column of the first tap of the grid's
    first patch, for padded level planes whose first row is global row
    ``row0`` (only the y base moves with ``row0``)."""
    half = ps // 2
    return (geom.iy0 * geom.steps + geom.offset_h - half + pad - row0,
            geom.offset_w - half + pad)


def templates_plain(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                    num_w: int, num_h: int, steps: int, y0: int, x0: int, ps: int,
                    residual: bool) -> Tuple[PatchTemplates, Optional[torch.Tensor]]:
    """Plain version of kernel S1: templates and inverse Hessians for a
    regular patch grid (patch.cpp:47-91) of ``num_w`` x ``num_h`` patches
    ``steps`` apart over padded level planes [(B,) th, tw], the first
    patch's first tap at plane row ``y0`` and column ``x0``
    (:func:`template_origin`).  Each tap is a strided view of the plane;
    patches come out in the reference's x-outer order.  With ``residual``
    also fixed mode's mean-normalized template ``Tn``
    (:func:`normalized_template`), else None."""
    s = steps
    nw, nh = num_w, num_h
    n = nw * nh

    def taps(plane):
        win = plane[..., y0:y0 + (nh - 1) * s + ps, x0:x0 + (nw - 1) * s + ps]
        t = win.unfold(-2, ps, s).unfold(-2, ps, s)  # [..., nh, nw, ps(j), ps(i)]
        return t.transpose(-4, -3).reshape(*plane.shape[:-2], n, ps * ps)

    T, Tdx, Tdy = taps(img), taps(dx), taps(dy)
    a = pairwise_sum(Tdx * Tdx)
    b = pairwise_sum(Tdx * Tdy)
    c = pairwise_sum(Tdy * Tdy)
    tpl = templates_from_hessian(T, Tdx, Tdy, a, b, c)
    return tpl, (normalized_template(T, ps) if residual else None)


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


def normalized_template(T: torch.Tensor, ps: int) -> torch.Tensor:
    """The template minus its mean, ``sum(T) * float32(1 / ps^2)``."""
    return T - pairwise_sum(T)[..., None] * inv_taps(ps)


def extract_templates_grid(img: torch.Tensor, dx: torch.Tensor,
                           dy: torch.Tensor, geom, ps: int,
                           pad: int, row0: int = 0, plain: bool = False) -> PatchTemplates:
    """Templates and inverse Hessians for the patch grid ``geom`` over
    padded level planes [(B,) th, tw] whose first row is global row
    ``row0``: one launch of kernel S1 (without the start) on CUDA tensors,
    its plain version on CPU tensors or with ``plain=True``."""
    return scale_templates(img, dx, dy, geom, ps, pad, row0, False, plain)[0]


def scale_templates(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, geom,
                    ps: int, pad: int, row0: int = 0, residual: bool = False,
                    plain: bool = False, plan=None, flow_coarse: Optional[torch.Tensor] = None,
                    coarse_row_offset: int = 0, width: int = 0, height: int = 0
                    ) -> Tuple[PatchTemplates, Optional[torch.Tensor], Optional[Start]]:
    """:func:`extract_templates_grid`; with ``residual`` also the
    mean-normalized template of fixed mode (None without); and given the
    scale's ``plan`` (``ops/grid.py::ScalePlan``, whose grid is ``geom``)
    also the search start of a scale of global size [height, width] from
    the coarser flow (None at the coarsest scale; its first row is global
    row ``coarse_row_offset``), None without: one S1."""
    from .cuda.scale_kernel import scale_templates as kernel

    fn = scale_templates_plain if plain else kernel
    start = () if plan is None else (flow_coarse, plan.nn_rows, plan.nn_cols,
                                     coarse_row_offset, plan.centers, width, height)
    return fn(img, dx, dy, geom.num_w, geom.num_h, geom.steps,
              *template_origin(geom, ps, pad, row0), ps, residual, *start)


def scale_templates_plain(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                          num_w: int, num_h: int, steps: int, y0: int, x0: int, ps: int,
                          residual: bool, flow_coarse: Optional[torch.Tensor] = None,
                          nn_rows: Optional[torch.Tensor] = None,
                          nn_cols: Optional[torch.Tensor] = None, coarse_row_offset: int = 0,
                          centers: Optional[torch.Tensor] = None, width: int = 0,
                          height: int = 0
                          ) -> Tuple[PatchTemplates, Optional[torch.Tensor], Optional[Start]]:
    """Plain version of kernel S1: :func:`templates_plain` and, given the
    plan's ``centers`` and picks, :func:`search_start_plain` for the pairs
    of the planes (None without).  Returns (templates, Tn or None, start
    or None)."""
    tpl, Tn = templates_plain(img, dx, dy, num_w, num_h, steps, y0, x0, ps, residual)
    if centers is None:
        return tpl, Tn, None
    nb = img.shape[0] if img.ndim == 3 else 0
    return tpl, Tn, Start(*search_start_plain(flow_coarse, nn_rows, nn_cols, coarse_row_offset,
                                              centers, ps, width, height, nb))


def residual_template(tpl: PatchTemplates, cfg: DISConfig) -> torch.Tensor:
    """Fixed mode's ``Tn``: the template, mean-normalized when
    patch_normalization is on (:func:`normalized_template`, which S1
    computes beside the templates on the main path)."""
    if not cfg.patch_normalization:
        return tpl.T
    return normalized_template(tpl.T, cfg.patch_size)


def search_start_plain(flow_coarse: Optional[torch.Tensor], nn_rows: torch.Tensor,
                       nn_cols: torch.Tensor, coarse_row_offset: int,
                       centers: torch.Tensor, ps: int, width: int, height: int,
                       nb: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of S1's search start (once kernel S2).  ``init_u``
    [(B,) N, 2] is the x2 nearest-neighbour pick from the coarser flow
    (``grid.nn_init_plain``), zeros at the coarsest scale (``flow_coarse``
    None; ``nb`` pairs, 0 for no pair axis); ``pos0 = centers + init_u``
    and ``conv0 = out_of_bounds(pos0)``, the patches frozen at the start.
    Returns (init_u, pos0, conv0)."""
    from .grid import nn_init_plain

    if flow_coarse is None:
        lead = (nb,) if nb else ()
        init_u = centers.new_zeros(lead + (nn_cols.shape[0] * nn_rows.shape[0], 2))
    else:
        init_u = nn_init_plain(flow_coarse, nn_rows, nn_cols, coarse_row_offset)
    pos0 = centers + init_u
    conv0 = out_of_bounds(pos0, ps, width, height)
    return init_u, pos0, conv0


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
                          pad: int, row0: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels K2, K2b and K2c: each patch's [rc, rc]
    window of the padded level plane [(B,) th, tw] at ``base =
    clip(ceil(pos0 + 1e-5) + pad - ps - 2, 0, max(dim - rc, 0))`` (``row0``
    subtracted from the y base), for start positions [(B,) N, 2].  On an
    axis of fewer than ``rc`` entries the base is 0 and a window index
    past the plane reads its last row or column, the oracle's edge rule
    (``reference_semantics.py::sample_patches`` clips every tap).
    Returns (regions [(B,) N, rc, rc], base_y, base_x [(B,) N] int32)."""
    th, tw = img2.shape[-2:]
    lead = img2.shape[:-2]
    rc = region_size(ps)
    base_y = (_ceil_coord(pos0[..., 1], pad - row0) - ps - 2).clamp(0, max(th - rc, 0))
    base_x = (_ceil_coord(pos0[..., 0], pad) - ps - 2).clamp(0, max(tw - rc, 0))
    ar = torch.arange(rc, device=img2.device)
    rows = (base_y.long()[..., None, None] + ar[:, None]).clamp(max=th - 1)
    cols = (base_x.long()[..., None, None] + ar).clamp(max=tw - 1)
    idx = rows * tw + cols                                 # [..., N, rc, rc]
    flat = img2.reshape(*lead, th * tw)
    regions = flat.gather(-1, idx.reshape(*lead, -1)).reshape(idx.shape)
    return regions, base_y, base_x


def sample_from_regions(regions: torch.Tensor, base_y: torch.Tensor,
                        base_x: torch.Tensor, pos: torch.Tensor, ps: int,
                        pad: int, normalize: bool, row0: int = 0) -> torch.Tensor:
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
    ws = (_ceil_coord(posy, pad - row0) - half - 1 - base_y).clamp(0, rc - (ps + 1))
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
                      cfg: DISConfig, width: int, height: int, row0: int = 0,
                      trips: Optional[list] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernels K1 and K1b: the IC-LK loop for every
    patch at one scale.  ``Tn`` is the fixed-mode residual template (None
    in compat mode); ``centers`` [N, 2] is shared by the pairs of a batch.
    A ``trips`` list, when given, gets the number of patches still active
    at each trip (a host read per trip; it measures the work the kernel
    does for these inputs).
    Returns (u [(B,) N, 2], Q [(B,) N, ps*ps], converged [(B,) N] bool)."""
    ps, pad = cfg.patch_size, cfg.img_padding
    fixed = cfg.mode == "fixed"
    thresh = cfg.outlier_thresh
    Hinv = tpl.Hinv

    def sample(p):
        return sample_from_regions(regions, base_y, base_x, p, ps, pad,
                                   cfg.patch_normalization, row0)

    start = centers + init_u
    u = init_u.clone()
    Q = torch.where(conv0[..., None], tpl.T, sample(start))
    conv = conv0.clone()
    for _ in range(cfg.iterations + 1):
        active = ~conv
        if trips is not None:
            trips.append(int(active.sum()))
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


def inverse_search(img2: torch.Tensor, tpl: PatchTemplates,
                   centers: torch.Tensor, init_u: torch.Tensor,
                   cfg: DISConfig, width: int, height: int,
                   row0: int = 0, plain: bool = False, Tn: Optional[torch.Tensor] = None,
                   start: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> SearchResult:
    """Run the full IC-LK iteration for every patch at one scale: one
    launch of the search loop K1 in its plane mode, which copies each
    patch's window straight from the level plane.  ``img2`` [(B,) th,
    tw], ``tpl`` and ``init_u`` [(B,) N, 2] carry the pair axis of a batch
    (then K1b: still one launch); ``centers`` [N, 2] is shared.  ``width``
    and ``height`` are the scale's global size; ``row0`` is the global row
    of the plane's first row.  ``plain=True`` runs the plain versions on
    any device.  The pipeline passes fixed mode's residual template ``Tn``
    and the start ``(pos0, conv0)``, both S1's; a caller that passes
    neither gets them from :func:`residual_template`, ``centers + init_u``
    and :func:`out_of_bounds` as torch ops."""
    from .cuda.iclk_kernel import iclk_search_plane

    ps, pad = cfg.patch_size, cfg.img_padding
    if cfg.mode == "fixed" and Tn is None:
        Tn = residual_template(tpl, cfg)
    if start is None:
        pos0 = centers + init_u
        start = pos0, out_of_bounds(pos0, ps, width, height)
    pos0, conv0 = start
    args = (tpl, Tn, centers, init_u, conv0, cfg, width, height, row0)
    if plain:
        u, Q, conv = iclk_search_plain(*extract_regions_plain(img2, pos0, ps, pad, row0),
                                       *args)
    else:
        u, Q, conv = iclk_search_plane(img2, pos0, *args)
    if checks.active():
        _guard_result(u, Q, centers, init_u, pos0, cfg)
    return SearchResult(u=u, Q=Q, converged=conv, start_oob=conv0)


def _guard_result(u, Q, centers, init_u, start, cfg: DISConfig) -> None:
    """``DIS_TPU_CHECK`` invariants on a scale's search result (counterpart
    of ``dis_tpu/ops/iclk.py::_guard_result``): finite state, and the Q9
    policing guarantee, that every patch's final position is within
    ``outlier_thresh`` (plus 1e-3 of slack) of its start or exactly reset
    to the init (patch.cpp:185-194)."""
    checks.check(torch.isfinite(u).all(), "IC-LK produced non-finite u")
    checks.check(torch.isfinite(Q).all(), "IC-LK produced non-finite Q")
    d = start - (centers + u)
    dist = sqrt_f32(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    at_init = (u == init_u).all(-1)
    ok = (dist <= cfg.outlier_thresh + 1e-3) | at_init
    checks.check(ok.all(), "policing invariant violated: patch moved "
                 "beyond outlier_thresh without reset")
