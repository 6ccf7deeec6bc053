"""Exact spatial tiling of one frame on one device; counterpart of the
single-controller engines of ``dis_tpu/parallel/tiles.py``.

:func:`tiled_flow_exact` computes a divisibility-padded frame as row
stripes (:func:`dis_tpu_torch.models.dis.dis_flow_stripe`, each stripe
with a halo) and :func:`grid_tiled_flow` splits each scale's patch grid
and output rows (:func:`dis_tpu_torch.models.dis.dis_scale_window`).
Both keep all geometry global, so the stitched flow is bitwise the
untiled ``dis_flow_padded``.  At 4K each stripe's finest scale takes the
column-banded extraction kernel K2c with its own ``row0``.

Variational refinement is a global stencil.  :func:`grid_tiled_flow`
assembles each scale's flow and refines it whole, per level or at the
finest scale, exactly as ``dis_flow_padded`` does; the stripes of
:func:`tiled_flow_exact` never refine, so it refines the gathered flow
at the finest scale, and routes per-level refinement to the grid engine
(a refinement between scales cannot run on stripes with private image
halos).  Both stay bitwise the untiled flow.  The multi-GPU forms
(``exchange_halo``, ``tiled_flow_fn``, ``grid_tiled_flow_fn``) wait for
ROADMAP.md queue 1, item 13.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..config import DISConfig
from ..models.dis import (_check_pair, build_refinement_planes, dis_flow_stripe,
                          dis_scale_window, refine, refine_level,
                          validate_stripe_geometry)
from ..ops.pyramid import construct_pyramid


def stripe_bounds(cfg: DISConfig, height: int, n: int, idx: int,
                  halo: int) -> Tuple[int, int, int, int]:
    """(row0, ext_h, own_r0, own_h) for stripe ``idx`` of ``n`` with the
    given halo, clamped at the frame edges."""
    own_h = height // n
    own_r0 = idx * own_h
    row0 = max(0, own_r0 - halo)
    ext_hi = min(height, own_r0 + own_h + halo)
    return row0, ext_hi - row0, own_r0, own_h


def min_stripe_halo(cfg: DISConfig, width: int, height: int, n: int) -> int:
    """Smallest halo (a multiple of 2**coarsest) for which every stripe of
    an n-way split passes :func:`validate_stripe_geometry`.  A split whose
    stripe height is not a multiple of 2**coarsest finds none short of
    whole-frame stripes."""
    f = 2 ** cfg.coarsest_scale
    for halo in range(f, height + f, f):
        try:
            for i in range(n):
                validate_stripe_geometry(cfg, width, height,
                                         *stripe_bounds(cfg, height, n, i, halo))
            return halo
        except ValueError:
            continue
    raise ValueError(f"no viable halo for {n} stripes of height {height}")


def window_partition(gh: int, n: int) -> List[Tuple[int, int]]:
    """``gh`` rows in ``n`` contiguous windows, as even as possible (the
    first ``gh % n`` windows get one extra row)."""
    base, rem = divmod(gh, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _refine_full(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor,
                 cfg: DISConfig, plain: bool = False) -> torch.Tensor:
    """Whole-frame refinement of the gathered finest-scale flow, exactly
    as ``dis_flow_padded`` runs it at the end of ``refine_per_level=False``:
    on the finest Q1 levels or on the intensity chain."""
    s = cfg.finest_scale
    planes = build_refinement_planes(img1, img2, cfg)
    if planes is not None:
        return refine(None, None, flow, cfg, s, planes)
    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding, plain)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding, plain)
    return refine(pyr1[s], pyr2[s], flow, cfg, s)


def grid_tiled_flow(img1: torch.Tensor, img2: torch.Tensor, cfg: DISConfig,
                    n_parts: int, plain: bool = False) -> torch.Tensor:
    """Exact grid-tiled flow of a divisibility-padded pair [(B,) H, W]: the
    images stay whole, each scale's patch grid and output rows are split
    ``n_parts`` ways (one extraction and one search launch per part and
    scale) and the parts are concatenated; refinement, where the config
    has it, runs on the assembled flow per level or at the finest scale.
    Bitwise equal to ``dis_flow_padded``."""
    _check_pair(img1, img2)
    h = img1.shape[-2]
    if (h >> cfg.finest_scale) < n_parts:
        raise ValueError(f"cannot split {h >> cfg.finest_scale} output "
                         f"rows into {n_parts} parts")
    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding, plain)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding, plain)
    planes = build_refinement_planes(img1, img2, cfg)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        l1, l2 = pyr1[scale], pyr2[scale]
        parts = [dis_scale_window(l1, l2, flow, cfg, scale, lo, hi, plain=plain)[0]
                 for lo, hi in window_partition(h >> scale, n_parts)]
        flow = torch.cat(parts, dim=-3)
        if cfg.refinement_iters > 0 and cfg.refine_per_level:
            flow = refine_level(l1, l2, flow, cfg, scale, planes)
    if cfg.refinement_iters > 0 and not cfg.refine_per_level:
        s = cfg.finest_scale
        flow = refine(pyr1[s], pyr2[s], flow, cfg, s, planes)
    return flow


def tiled_flow_exact(img1: torch.Tensor, img2: torch.Tensor, cfg: DISConfig,
                     n_stripes: int, halo: int, plain: bool = False,
                     refine: Optional[bool] = None) -> torch.Tensor:
    """Exact row-stripe flow of a divisibility-padded pair [(B,) H, W]:
    ``n_stripes`` stripes, each extended by ``halo`` rows (see
    :func:`min_stripe_halo`), through :func:`dis_flow_stripe`, then
    concatenated.  ``refine`` (default: ``cfg.refinement_iters > 0``)
    refines the gathered flow at the finest scale; with
    ``refine_per_level`` the whole frame goes through
    :func:`grid_tiled_flow` with ``n_stripes`` parts instead.  Bitwise
    equal to ``dis_flow_padded`` (with ``refine=False``, to its flow
    without refinement)."""
    _check_pair(img1, img2)
    refine = cfg.refinement_iters > 0 and refine is not False
    if refine and cfg.refine_per_level:
        return grid_tiled_flow(img1, img2, cfg, n_stripes, plain=plain)
    h = img1.shape[-2]
    outs = []
    for i in range(n_stripes):
        row0, ext_h, own_r0, own_h = stripe_bounds(cfg, h, n_stripes, i, halo)
        outs.append(dis_flow_stripe(
            img1[..., row0:row0 + ext_h, :].contiguous(),
            img2[..., row0:row0 + ext_h, :].contiguous(), cfg,
            row0=row0, own_r0=own_r0, own_h=own_h, global_h=h, plain=plain))
    flow = torch.cat(outs, dim=-3)
    if refine:
        flow = _refine_full(img1, img2, flow, cfg, plain)
    return flow
