"""Exact spatial tiling of one frame, on one device or over the ranks of
a mesh axis; counterpart of ``dis_tpu/parallel/tiles.py``.

:func:`tiled_flow_exact` computes a divisibility-padded frame as row
stripes (:func:`dis_tpu_torch.models.dis.dis_flow_stripe`, each stripe
with a halo) and :func:`grid_tiled_flow` splits each scale's patch grid
and output rows (:func:`dis_tpu_torch.models.dis.dis_scale_window`).
Both keep all geometry global, so the stitched flow is bitwise the
untiled ``dis_flow_padded``.  Each stripe and window searches with K1 in
its plane mode, with its own ``row0``, as the untiled frame does.

Variational refinement is a global stencil.  :func:`grid_tiled_flow`
assembles each scale's flow and refines it whole, per level or at the
finest scale, exactly as ``dis_flow_padded`` does; the stripes of
:func:`tiled_flow_exact` never refine, so it refines the gathered flow
at the finest scale, and routes per-level refinement to the grid engine
(a refinement between scales cannot run on stripes with private image
halos).  Both stay bitwise the untiled flow.

The multi-rank engines run the same math on each rank's own rows.
:func:`tiled_flow_fn` gives each rank of a ``space`` axis one stripe: it
fetches its halo rows from its neighbours (:func:`exchange_halo`, two
shifts) or, where the halo outgrows a neighbour's block, gathers the
frames; :func:`grid_tiled_flow_fn` gathers the frames once and gives each
rank one window of every scale's output rows, the parts gathered between
scales.  Each rank runs its own program, so the JAX package's shared
``lax.switch`` branches (and their ``row_delta``) have no counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import DISConfig
from ..models.dis import (_check_pair, build_refinement_planes, dis_flow_stripe,
                          dis_scale_window, refine, refine_level,
                          validate_stripe_geometry)
from ..ops.pyramid import construct_pyramid
from .mesh import all_gather_rows, axis_group, shift


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
    planes = build_refinement_planes(img1, img2, cfg, plain)
    if planes is not None:
        return refine(None, None, flow, cfg, s, planes, plain)
    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding, plain)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding, plain)
    return refine(pyr1[s], pyr2[s], flow, cfg, s, plain=plain)


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
    planes = build_refinement_planes(img1, img2, cfg, plain)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        l1, l2 = pyr1[scale], pyr2[scale]
        parts = [dis_scale_window(l1, l2, flow, cfg, scale, lo, hi, plain=plain)[0]
                 for lo, hi in window_partition(h >> scale, n_parts)]
        flow = torch.cat(parts, dim=-3)
        if cfg.refinement_iters > 0 and cfg.refine_per_level:
            flow = refine_level(l1, l2, flow, cfg, scale, planes, plain)
    if cfg.refinement_iters > 0 and not cfg.refine_per_level:
        s = cfg.finest_scale
        flow = refine(pyr1[s], pyr2[s], flow, cfg, s, planes, plain)
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


def exchange_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """This rank's row block ``[Hl, W]`` extended by ``halo`` rows of each
    neighbour's edge (two :func:`shift` calls over ``group``): global rows
    ``[i Hl - halo, (i + 1) Hl + halo)`` for index i.  The first and last
    ranks fill their outer band with their own edge row, which the stripe
    slice never reads.  Needs ``halo <= Hl``."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if halo > x.shape[0]:
        raise ValueError(f"halo {halo} exceeds the row block {x.shape[0]}: "
                         "gather the frame instead")
    from_above = shift(x[-halo:], group, [(j, j + 1) for j in range(n - 1)])
    from_below = shift(x[:halo], group, [(j + 1, j) for j in range(n - 1)])
    top = x[:1].expand(halo, *x.shape[1:]) if i == 0 else from_above
    bot = x[-1:].expand(halo, *x.shape[1:]) if i == n - 1 else from_below
    return torch.cat([top, x, bot], dim=0)


def _check_block(name: str, x: torch.Tensor, shape) -> None:
    if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(shape):
        got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"{name}: expected this rank's row block {tuple(shape)}, got {got}")


def grid_tiled_flow_fn(cfg: DISConfig, mesh, height: int, width: int,
                       axis: str = "space"):
    """Multi-rank :func:`grid_tiled_flow`: returns fn(img1, img2) of this
    rank's row blocks ``[height / n, width]`` of a divisibility-padded
    pair that returns its rows ``[(height >> finest) / n, width >> finest,
    2]`` of the flow.  Each rank gathers the frames once, then per scale
    searches and densifies its window of output rows (``window_partition``;
    ragged windows are padded to the first, largest one for the gather and
    cut back), the windows are gathered, and refinement runs on the
    assembled flow on every rank as ``dis_flow_padded`` runs it.  Bitwise
    equal to those rows of ``dis_flow_padded``."""
    group, n, idx = axis_group(mesh, axis)
    if height % n:
        raise ValueError(f"height {height} must be divisible by n_space={n} "
                         "(equal image input shards)")
    fs = cfg.finest_scale
    if (height >> fs) % n:
        raise ValueError(f"output height {height >> fs} must be divisible by "
                         f"n_space={n} (equal output shards)")
    own = (height >> fs) // n
    refine_each = cfg.refinement_iters > 0 and cfg.refine_per_level

    def run(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        _check_block("img1", img1, (height // n, width))
        _check_block("img2", img2, (height // n, width))
        f1, f2 = all_gather_rows(img1, group), all_gather_rows(img2, group)
        pyr1 = construct_pyramid(f1, cfg.coarsest_scale, cfg.img_padding)
        pyr2 = construct_pyramid(f2, cfg.coarsest_scale, cfg.img_padding)
        planes = build_refinement_planes(f1, f2, cfg)
        flow = None
        for scale in range(cfg.coarsest_scale, fs - 1, -1):
            l1, l2 = pyr1[scale], pyr2[scale]
            wins = window_partition(height >> scale, n)
            cmax = wins[0][1] - wins[0][0]
            lo, hi = wins[idx]
            part = dis_scale_window(l1, l2, flow, cfg, scale, lo, hi)[0]
            if hi - lo < cmax:
                part = torch.cat([part, part.new_zeros((cmax - (hi - lo),) + part.shape[1:])])
            flow = all_gather_rows(part, group)
            if (height >> scale) != n * cmax:
                flow = torch.cat([flow[j * cmax:j * cmax + (b - a)]
                                  for j, (a, b) in enumerate(wins)])
            if refine_each:
                flow = refine_level(l1, l2, flow, cfg, scale, planes)
        if cfg.refinement_iters > 0 and not cfg.refine_per_level:
            flow = refine(pyr1[fs], pyr2[fs], flow, cfg, fs, planes)
        return flow[idx * own:(idx + 1) * own].contiguous()

    return run


def tiled_flow_fn(cfg: DISConfig, mesh, height: int, width: int,
                  axis: str = "space", halo: Optional[int] = None):
    """Multi-rank exact stripe tiling: returns fn(img1, img2) of this
    rank's row blocks ``[height / n, width]`` of a divisibility-padded
    pair that returns its rows ``[(height / n) >> finest, width >> finest,
    2]`` of the flow, bitwise those rows of ``dis_flow_padded``.

    ``height`` must be divisible by ``n * 2**coarsest_scale``.  ``halo``
    defaults to :func:`min_stripe_halo` (validated otherwise).  A halo
    that fits in a neighbour's block comes by :func:`exchange_halo`; a
    larger one (tiny frames, many ranks) from a gather of the frames.
    Each rank runs :func:`dis_flow_stripe` on its extended stripe; with
    refinement the flow is gathered, refined whole and cut back to each
    rank's rows.  Per-level refinement routes to
    :func:`grid_tiled_flow_fn` (a refinement between scales cannot run on
    stripes with private image halos)."""
    if cfg.refinement_iters > 0 and cfg.refine_per_level:
        return grid_tiled_flow_fn(cfg, mesh, height, width, axis=axis)
    group, n, idx = axis_group(mesh, axis)
    f = 2 ** cfg.coarsest_scale
    if height % (n * f):
        raise ValueError(
            f"height {height} must be divisible by n_space*{f} = {n * f} "
            "for stripe tiling (aligned equal stripes); use "
            "grid_tiled_flow_fn for other splits")
    own_h = height // n
    if halo is None:
        halo = min_stripe_halo(cfg, width, height, n)
    else:
        for i in range(n):
            validate_stripe_geometry(cfg, width, height,
                                     *stripe_bounds(cfg, height, n, i, halo))
    use_gather = halo > own_h
    row0, ext_h, own_r0, _ = stripe_bounds(cfg, height, n, idx, halo)
    # Row of the extended block that holds global row row0.
    b0 = row0 if use_gather else row0 - (own_r0 - halo)
    fs = cfg.finest_scale

    def run(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        _check_block("img1", img1, (own_h, width))
        _check_block("img2", img2, (own_h, width))
        if use_gather:
            e1, e2 = all_gather_rows(img1, group), all_gather_rows(img2, group)
        else:
            e1, e2 = exchange_halo(img1, halo, group), exchange_halo(img2, halo, group)
        flow = dis_flow_stripe(e1[b0:b0 + ext_h].contiguous(), e2[b0:b0 + ext_h].contiguous(),
                               cfg, row0=row0, own_r0=own_r0, own_h=own_h, global_h=height)
        if cfg.refinement_iters > 0:
            flow_full = all_gather_rows(flow, group)
            if not use_gather:
                e1, e2 = all_gather_rows(img1, group), all_gather_rows(img2, group)
            flow_full = _refine_full(e1, e2, flow_full, cfg)
            flow = flow_full[idx * (own_h >> fs):(idx + 1) * (own_h >> fs)].contiguous()
        return flow

    return run
