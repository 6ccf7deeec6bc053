"""Coarse-to-fine DIS orchestrator (optical_flow.cpp:19-132); counterpart
of ``dis_tpu/models/dis.py``.

``flow = dis_flow(img1, img2, cfg)`` runs on the device of its inputs:
on CUDA tensors each pyramid, region extraction and search goes
through the hand-written kernels K3, K2 (K2c where the extraction route
says so: the 4K finest scale) and K1, each scale's templates and start
through S1 and its fixed-mode weights and densification through S3 and
S4; on CPU tensors
through their plain PyTorch versions.  Scale shapes are static and the
scale loop is a Python loop.

A batch of same-shape pairs ``[B, H, W]`` runs the same loop once, with
the pair axis leading every tensor: one K3 launch per image (four
levels each), one K2 (K2b or K2c) and one K1 (K1b) launch per scale, whatever B is.
Each pair of a batch gets the bits it gets alone.  Each scale's constants
come from its plan (``ops/grid.py::scale_plan``), made once per shape and
device, so a frame makes no host-to-device copy and no host sync, and can
be captured in a CUDA graph (``serving.py``).

Configs with ``refinement_iters > 0`` (``DIS_MEDIUM``, ``DIS_FULL``)
refine the densified flow variationally (``ops/variational.py``: on CUDA
tensors the kernels R0-R3, a launch per level's Sobel planes, warp,
weight update and half-sweep), after every scale (``refine_per_level``)
or once at the finest scale, on the Q1 levels or the intensity chain
(``refinement_planes``; kernel F2 builds it).  ``dis_flow`` pads the
frame with kernel F1 where it pads, and upsamples and crops the flow with
kernel F3 where ``finest_scale > 0``.  Without ``refined_init_clamp`` a per-level
refinement leaves the next scale's init without a static bound, and the
route takes K2 there.

Exact tiling (``parallel/tiles.py``) runs one scale on a window of
output rows (:func:`dis_scale_window`) or the whole pipeline on a row
stripe of the frame (:func:`dis_flow_stripe`, which never refines).  All
geometry stays global, so each is bitwise those rows of the untiled
flow.

Each stage runs inside ``utils/profiling.py::stage``, named as the JAX
package's ``jax.named_scope`` (``pyramid``, ``scale_{s}``, ``refine_s{s}``,
``variational_refinement``, ``stripe_scale_{s}``): a ``record_function``
range while a profiler runs, so that a profile attributes device time to
stages, and the stage and scale of each launch of a launch manifest.  The
``DIS_TPU_CHECK`` guards (``utils/checks.py``) sit in the search and at
the end of :func:`dis_flow_padded`; they cost nothing unless a
``checks.checked`` call is running.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import DISConfig
from ..ops import iclk
from ..ops import image as im
from ..ops.densify import densify, fixed_weights
from ..ops.grid import ScalePlan, make_grid, scale_plan
from ..ops.cuda.frame_kernel import frame_finish, frame_pad, intensity_levels
from ..ops.pyramid import construct_pyramid, intensity_levels_plain
from ..ops.variational import variational_refinement
from ..utils import checks, profiling


def _fixed_weights(res: iclk.SearchResult, tpl: iclk.PatchTemplates,
                   cfg: DISConfig, plain: bool = False) -> torch.Tensor:
    """Residual-adaptive densification weights (DIS paper eq. 4):
    ``1 / max(1, ||Q - Tn||^2)`` with the mean-normalized template, 1.0
    for patches frozen at the start (``ops/densify.py::fixed_weights``,
    kernel S3)."""
    return fixed_weights(res.Q, tpl.T, res.start_oob, cfg.patch_size,
                         cfg.patch_normalization, plain)


def motion_bound(cfg: DISConfig, scale: int) -> float:
    """Upper bound on |u| at ``scale`` from the policing chain: the
    coarsest init is zero and every scale adds at most ``ps/2`` on top
    of twice the coarser flow (patch.cpp:185-194 + patch_grid.cpp:116)."""
    b = cfg.outlier_thresh
    for _ in range(cfg.coarsest_scale - scale):
        b = 2.0 * b + cfg.outlier_thresh
    return b


def init_bound(cfg: DISConfig, scale: int) -> Optional[float]:
    """The static bound on ``|init_u|`` at ``scale``: zero at the coarsest
    scale, else twice the policing-chain bound of the coarser scale; None
    where per-level refinement without the clamp rewrites the init (the
    extraction route then takes K2)."""
    if scale == cfg.coarsest_scale:
        return 0.0
    refined = cfg.refinement_iters > 0 and cfg.refine_per_level
    if refined and not cfg.refined_init_clamp:
        return None
    return 2.0 * motion_bound(cfg, scale + 1)


def window_patch_rows(cfg: DISConfig, gh_s: int, win_lo: int,
                      win_hi: int) -> Tuple[int, int]:
    """Global patch-row range [iy0, iy1) whose ps x ps footprints
    intersect output rows [win_lo, win_hi) at a scale of global height
    ``gh_s``.  A patch at center ``cy`` covers rows
    ``[cy - ps/2, cy + ps/2 - 1]`` (patch_grid.cpp:132-165)."""
    half = cfg.patch_size // 2
    steps = cfg.steps
    num_h = math.ceil(gh_s / steps)
    offh = math.floor((gh_s - (num_h - 1) * steps) / 2)
    iy0 = max(0, math.ceil((win_lo - half + 1 - offh) / steps))
    iy1 = min(num_h, math.floor((win_hi - 1 + half - offh) / steps) + 1)
    return iy0, iy1


def _scale(l1, l2, flow_coarse, cfg: DISConfig, scale: int, gh_s: int,
           iy_range, window, row0: int = 0, coarse_row_offset: int = 0,
           plain: bool = False):
    """One scale for the global patch rows ``iy_range`` and output rows
    ``window`` of a level of global height ``gh_s``, whose planes start at
    global row ``row0``: templates, the NN init from the coarser flow
    (None at the coarsest scale; its first row is global row
    ``coarse_row_offset``), the IC-LK search and densification.  On CUDA
    tensors each step is one kernel launch: S1 (templates, inverse
    Hessians, fixed mode's ``Tn`` and the start), K2 or K2c, K1, S3
    (fixed mode's weights) and S4 (densification)."""
    sw = l1.width
    ps, pad = cfg.patch_size, cfg.img_padding
    fixed = cfg.mode == "fixed"
    plan = scale_plan(sw, gh_s, cfg.steps, ps, l1.img.device, iy_range, window)
    tpl, Tn, (init_u, pos0, conv0) = iclk.scale_templates(
        l1.img, l1.dx, l1.dy, plan.geom, ps, pad, row0, fixed and cfg.patch_normalization,
        plain, plan, flow_coarse, coarse_row_offset, sw, gh_s)
    if fixed and Tn is None:
        Tn = tpl.T
    res = iclk.inverse_search(l2.img, tpl, plan.centers, init_u, cfg, sw, gh_s,
                              row0=row0, geom=plan.geom,
                              init_bound=init_bound(cfg, scale), plain=plain, Tn=Tn,
                              start=(pos0, conv0))
    wts = _fixed_weights(res, tpl, cfg, plain) if fixed else None
    return densify(res.u, plan, wts, plain=plain), plan.geom, res


def dis_scale_window(l1, l2, flow_coarse, cfg: DISConfig, scale: int,
                     win_lo: int, win_hi: int, plain: bool = False):
    """One scale of the pipeline restricted to output rows [win_lo,
    win_hi): templates and the IC-LK search for exactly the patches whose
    footprint touches the window, then densification of the window rows,
    all against FULL-frame level planes and the FULL coarser dense flow
    (None at the coarsest scale).  Levels and flows may lead with a pair
    axis.  Bitwise equal to rows [win_lo, win_hi) of the untiled scale
    (``dis_flow_padded`` runs it with the full window).  Returns
    (flow [(B,) win_hi - win_lo, w_s, 2], geom, SearchResult)."""
    gh_s = l1.height
    return _scale(l1, l2, flow_coarse, cfg, scale, gh_s,
                  window_patch_rows(cfg, gh_s, win_lo, win_hi), (win_lo, win_hi),
                  plain=plain)


def scale_extraction_route(cfg: DISConfig, width: int, height: int,
                           scale: int) -> str:
    """The extraction kernel (``ops/iclk.py::extraction_route``: "K2" or
    "K2c") the pipeline launches at ``scale`` for a padded [height, width]
    frame, derived from static shapes alone."""
    sw, sh = width >> scale, height >> scale
    geom = make_grid(sw, sh, cfg.steps)
    pad = cfg.img_padding
    return iclk.extraction_route(cfg, (sh + 2 * pad, sw + 2 * pad),
                                 geom.num_w * geom.num_h, init_bound(cfg, scale))


def flow_plans(cfg: DISConfig, height: int, width: int,
               device: torch.device) -> Tuple[ScalePlan, ...]:
    """The plans ``dis_flow`` fetches for a [(B,) height, width] input on
    ``device``, coarsest scale first: the level of scale s is the
    divisibility-padded frame halved s times."""
    f = 2 ** cfg.coarsest_scale
    ph, pw = -(-height // f) * f, -(-width // f) * f
    return tuple(scale_plan(pw >> s, ph >> s, cfg.steps, cfg.patch_size, device)
                 for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1))


def _check_pair(img1: torch.Tensor, img2: torch.Tensor) -> None:
    """Both inputs one grayscale plane [H, W], or both a batch of B >= 1
    same-shape planes [B, H, W], on one device."""
    for name, t in (("img1", img1), ("img2", img2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.ndim not in (2, 3):
            raise ValueError(f"{name} must be a grayscale plane [H, W] or a batch of "
                             f"them [B, H, W], got shape {tuple(t.shape)}")
        if t.ndim == 3 and t.shape[0] == 0:
            raise ValueError(f"{name} is an empty batch {tuple(t.shape)}: B must be >= 1")
    if img1.device != img2.device:
        raise ValueError(f"img1 is on {img1.device} and img2 on {img2.device}: "
                         "dis_flow runs on the device of its inputs")
    if img1.ndim != img2.ndim:
        raise ValueError(f"one input is batched and the other is not: "
                         f"{tuple(img1.shape)} vs {tuple(img2.shape)}")
    if img1.ndim == 3 and img1.shape[0] != img2.shape[0]:
        raise ValueError(f"batch sizes differ: {img1.shape[0]} vs {img2.shape[0]} pairs")
    if img1.shape != img2.shape:
        raise ValueError(f"pair shapes differ: {tuple(img1.shape)} vs {tuple(img2.shape)}")


def build_refinement_planes(img1_padded: torch.Tensor, img2_padded: torch.Tensor,
                            cfg: DISConfig, plain: bool = False):
    """Per-scale intensity planes for the refinement's data term (two
    lists indexed by scale), or None when the refinement reads the Q1
    pyramid levels or is off (``refinement_planes``).  On CUDA tensors
    every level of both images is one launch of kernel F2
    (``intensity_levels``); ``plain=True`` runs its plain version.  The
    untiled and tiled engines pass them unchanged to :func:`refine`, so
    every engine refines with the same bits."""
    if cfg.refinement_iters == 0 or cfg.refinement_planes == "q1":
        return None
    build = intensity_levels_plain if plain else intensity_levels
    return build(img1_padded, img2_padded, cfg.coarsest_scale)


def refine(l1, l2, flow: torch.Tensor, cfg: DISConfig, scale: int,
           planes=None, plain: bool = False, bound: Optional[float] = None) -> torch.Tensor:
    """The variational refinement of ``flow`` at ``scale``: on the Q1
    level planes ``l1.img`` and ``l2.img``, or, where ``planes`` (from
    :func:`build_refinement_planes`) is given, on the intensity planes of
    that scale (the levels are then not read and may be None); clipped to
    [-bound, bound] where ``bound`` is given.  ``plain=True`` runs the
    plain versions of R0-R3 on any device."""
    if planes is None:
        return variational_refinement(l1.img, l2.img, flow, cfg, plain=plain, bound=bound)
    return variational_refinement(planes[0][scale], planes[1][scale], flow, cfg, pad=0,
                                  plain=plain, bound=bound)


def refine_level(l1, l2, flow: torch.Tensor, cfg: DISConfig, scale: int,
                 planes=None, plain: bool = False) -> torch.Tensor:
    """Per-level variational refinement at ``scale`` (DIS paper sec.
    3.3), shared by the untiled and grid-tiled engines, which call it
    where ``refinement_iters > 0``.  With ``cfg.refined_init_clamp`` the
    refined field is clipped to the policing-chain bound
    ``motion_bound(cfg, scale)``, which restores the static init bound
    that K2c's route needs: R3 clips the flow as it writes it in the last
    outer iteration."""
    bound = motion_bound(cfg, scale) if cfg.refined_init_clamp else None
    return refine(l1, l2, flow, cfg, scale, planes, plain, bound)


def dis_flow_padded(img1: torch.Tensor, img2: torch.Tensor,
                    cfg: DISConfig, plain: bool = False,
                    return_debug: bool = False):
    """DIS flow on an already divisibility-padded float32 pair [H, W], or
    a batch of pairs [B, H, W].

    Returns flow at scale ``finest_scale``: [(B,) H / 2**finest,
    W / 2**finest, 2].  With ``return_debug``, also returns a per-scale
    list of (scale, centers [N, 2] NumPy, u [(B,) N, 2], level image
    [(B,) h_s, w_s]) for the C12 grid overlay (optical_flow.cpp:92-123),
    coarsest scale first.
    ``plain=True`` runs the kernels' plain PyTorch versions on any device,
    the refinement's too; it exists to check the kernels on the card.
    Under ``utils.checks.checked`` with ``DIS_TPU_CHECK=1``, the flow
    must be finite (and each scale's search passes its guards).
    """
    _check_pair(img1, img2)
    h, w = img1.shape[-2:]
    f = 2 ** cfg.coarsest_scale
    if w % f or h % f:
        raise ValueError(f"padded input dims must be divisible by {f}")
    with profiling.stage("pyramid"):
        pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding, plain)
        pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding, plain)
    planes = build_refinement_planes(img1, img2, cfg, plain)
    refine_each = cfg.refinement_iters > 0 and cfg.refine_per_level
    refine_at_end = cfg.refinement_iters > 0 and not cfg.refine_per_level
    flow = None
    debug = []
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        with profiling.stage(f"scale_{scale}", scale):
            l1, l2 = pyr1[scale], pyr2[scale]
            flow, geom, res = dis_scale_window(l1, l2, flow, cfg, scale, 0, l1.height,
                                               plain=plain)
            if refine_each:
                # The refined field seeds the next finer scale's init.
                with profiling.stage(f"refine_s{scale}", scale):
                    flow = refine_level(l1, l2, flow, cfg, scale, planes, plain)
            if return_debug:
                p = cfg.img_padding
                debug.append((scale, geom.centers, res.u,
                              l1.img[..., p:p + l1.height, p:p + l1.width]))
    if refine_at_end:
        s = cfg.finest_scale
        with profiling.stage("variational_refinement", s):
            flow = refine(pyr1[s], pyr2[s], flow, cfg, s, planes, plain)
    if checks.active():
        checks.check(torch.isfinite(flow).all(), "pipeline produced non-finite flow")
    if return_debug:
        return flow, debug
    return flow


def _stripe_plan(cfg: DISConfig, global_h: int, own_r0: int, own_h: int):
    """Per-scale (patch-row range, flow-output window) for a stripe that
    must emit global rows [own_r0, own_r0 + own_h) at the finest scale.
    Windows propagate coarser through the nearest-neighbor init lookup
    (floor(cy/2), quirk Q8); patch ranges cover every footprint that
    touches the scale's output window."""
    steps = cfg.steps
    win = {cfg.finest_scale: (own_r0 >> cfg.finest_scale,
                              (own_r0 + own_h) >> cfg.finest_scale)}
    iy = {}
    for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        gh_s = global_h >> s
        num_h = math.ceil(gh_s / steps)
        offh = math.floor((gh_s - (num_h - 1) * steps) / 2)
        iy0, iy1 = iy[s] = window_patch_rows(cfg, gh_s, *win[s])
        if s < cfg.coarsest_scale:
            cmin = iy0 * steps + offh
            cmax = (iy1 - 1) * steps + offh
            win[s + 1] = (cmin // 2, cmax // 2 + 1)
    return iy, win


def validate_stripe_geometry(cfg: DISConfig, width: int, global_h: int,
                             row0: int, ext_h: int, own_r0: int,
                             own_h: int) -> None:
    """Static check that a stripe's halo covers every included patch's
    sampling reach and stencil margins; raises ValueError otherwise."""
    iy_plan, _ = _stripe_plan(cfg, global_h, own_r0, own_h)
    ps = cfg.patch_size
    stencil_margin = 4  # pyramid edge contamination per level (bounded)
    for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        r0_s = row0 >> s
        eh_s = ext_h >> s
        gh_s = global_h >> s
        iy0, iy1 = iy_plan[s]
        if iy0 >= iy1:
            continue
        num_h = math.ceil(gh_s / cfg.steps)
        offh = math.floor((gh_s - (num_h - 1) * cfg.steps) / 2)
        cmin = iy0 * cfg.steps + offh
        cmax = (iy1 - 1) * cfg.steps + offh
        reach = motion_bound(cfg, s) + ps + 3
        lo_ok = (r0_s == 0) or (cmin - reach >= r0_s + stencil_margin)
        hi_ok = (r0_s + eh_s == gh_s) or (
            cmax + reach < r0_s + eh_s - stencil_margin)
        if not (lo_ok and hi_ok):
            raise ValueError(
                f"stripe halo too small at scale {s}: patches "
                f"[{cmin},{cmax}] need +/-{reach:.0f} rows inside "
                f"[{r0_s},{r0_s + eh_s}) of {gh_s}")


def dis_flow_stripe(img1_ext: torch.Tensor, img2_ext: torch.Tensor,
                    cfg: DISConfig, row0: int, own_r0: int, own_h: int,
                    global_h: int, plain: bool = False) -> torch.Tensor:
    """Exact tiled execution: flow for global rows [own_r0, own_r0 +
    own_h) from an extended stripe [(B,) ext_h, W] holding global rows
    [row0, row0 + ext_h) of a divisibility-padded frame.

    All geometry (patch grid, policing bounds, densification windows) is
    GLOBAL; the stripe only localizes the image planes (``row0`` moves
    the y tap base of the templates, K2/K2c and K1), so the result is
    bitwise those rows of ``dis_flow_padded``.  ``row0``, ``ext_h``,
    ``own_r0``, ``own_h`` and ``global_h`` must be multiples of
    ``2**coarsest_scale``; the halo must cover the per-scale motion bound
    plus stencil margins (checked, ValueError otherwise).  Refinement is
    a global stencil that a stripe never runs: its config fields are
    ignored here, as in the JAX package; the tiling layer refines the
    gathered flow or routes per-level refinement to the grid engine.
    Returns [(B,) own_h >> finest, W >> finest, 2]."""
    _check_pair(img1_ext, img2_ext)
    ext_h, w = img1_ext.shape[-2:]
    f = 2 ** cfg.coarsest_scale
    for name, v in [("row0", row0), ("ext_h", ext_h), ("own_r0", own_r0),
                    ("own_h", own_h), ("global_h", global_h)]:
        if v % f:
            raise ValueError(f"{name}={v} must be divisible by {f}")
    if cfg.refinement_iters > 0:
        cfg = dataclasses.replace(cfg, refinement_iters=0)
    iy_plan, win_plan = _stripe_plan(cfg, global_h, own_r0, own_h)
    validate_stripe_geometry(cfg, w, global_h, row0, ext_h, own_r0, own_h)
    with profiling.stage("pyramid"):
        pyr1 = construct_pyramid(img1_ext, cfg.coarsest_scale, cfg.img_padding, plain)
        pyr2 = construct_pyramid(img2_ext, cfg.coarsest_scale, cfg.img_padding, plain)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        with profiling.stage(f"stripe_scale_{scale}", scale):
            coarse_r0 = 0 if flow is None else win_plan[scale + 1][0]
            flow, _, _ = _scale(pyr1[scale], pyr2[scale], flow, cfg, scale,
                                global_h >> scale, iy_plan[scale], win_plan[scale],
                                row0 >> scale, coarse_r0, plain)
    return flow


def dis_flow(img1: torch.Tensor, img2: torch.Tensor,
             cfg: DISConfig = DISConfig(), plain: bool = False) -> torch.Tensor:
    """End-to-end flow for an arbitrary-size grayscale pair [H, W], or a
    batch of same-shape pairs [B, H, W], on the device of its inputs:
    divisibility padding (main.cpp:140-155; kernel F1 on CUDA tensors,
    where it pads), the pipeline, the finest-scale upsample
    (main.cpp:191-196) and the crop (main.cpp:198; kernel F3 where
    ``finest_scale > 0``, else a view).  Returns [(B,) H, W, 2] float32."""
    _check_pair(img1, img2)
    h, w = img1.shape[-2:]
    pad = im.frame_pad_plain if plain else frame_pad
    finish = im.frame_finish_plain if plain else frame_finish
    p1, p2, (padw, padh) = pad(img1.to(torch.float32), img2.to(torch.float32),
                               cfg.coarsest_scale)
    flow = dis_flow_padded(p1, p2, cfg, plain=plain)
    return finish(flow, cfg.finest_scale, padw, padh, w, h)
