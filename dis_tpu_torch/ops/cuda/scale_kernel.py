"""S1, S3, S4: each scale's device work around the search
(``csrc/scale_glue.cu``).

No Pallas kernel backs them: the JAX package writes this work as ``jnp``
code that XLA fuses into a few loops per scale.  They replace those
fusions, and about 75 torch ops per scale, with one launch each per scale
of ``models/dis.py::_scale``:

- S1 :func:`scale_templates`, the templates, their Hessians' inverses,
  fixed mode's mean-normalized template (``dis_tpu/ops/iclk.py:155``,
  ``:346``, ``:355``, ``:635-637``) and the search start: the x2
  nearest-neighbour init from the coarser flow and the start test
  (``dis_tpu/ops/grid.py:52``, ``dis_tpu/ops/iclk.py:639-646``), once a
  kernel of its own (S2); plain version ``ops/iclk.py::
  scale_templates_plain``, which is ``templates_plain`` then
  ``search_start_plain``;
- S3 :func:`fixed_weights`, fixed mode's densification weights
  (``dis_tpu/models/dis.py:27``); plain version
  ``ops/densify.py::fixed_weights_plain``;
- S4 :func:`densify`, densification (``dis_tpu/ops/densify.py:58-108``);
  plain version ``ops/densify.py::densify_plain``.

Each is bound by bytes on the H100: S1 stages each tile of the patch
grid's plane windows in shared memory (:func:`template_tiles`) and reads
its taps there in K1's lane layout (a group of lanes a patch, the
pair-tree sums as an in-lane tree and a butterfly), as S3 reads its
patches, and each group's first lane writes its patch's start beside its
inverse; S4 takes a block a tile of output pixels, its covers' sub-block
of the grid staged once (:func:`densify_tiles`).  Each keeps its plain
version's operations and rounding, so it equals it bitwise.  No single
PyTorch call computes any of them (a gather, a pair-tree sum, a 2x2
inverse and a stencil each), so they have no library yardstick.

A batch of pairs adds a leading axis to the planes, the per-patch tensors
and the flows; the plan's tensors (centers, picks, cover indices, the
uniform weight plane) are shared by the pairs.  The ops return new
tensors, so ``torch.export`` and CUDA graphs need no handling of mutation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ... import _build
from ..densify import densify_plain, fixed_weights_plain
from ..iclk import PatchTemplates, Start, inv_taps, scale_templates_plain
from . import all_on_cpu, check_input, dispatch, register
from .iclk_kernel import lane_layout

T = torch.Tensor             # the ops' schemas come from these annotations
I64 = torch.int64


def _pairs(lead) -> int:
    return lead[0] if lead else 1


# -- S1's and S4's tiles (the kernels take them as given) ----------------------------

S1_TILE = (8, 8)               # the patch rows and columns an S1 tile takes first
S1_SHARED_TARGET = 48 * 1024   # the shared bytes S1 keeps under where a smaller tile can
DENSIFY_ROWS, DENSIFY_COLS = 32, 128   # output rows and columns an S4 tile (csrc/scale_glue.cu)
F32 = 4


class TemplateTiles(NamedTuple):
    """S1's tiles of a patch grid (:func:`template_tiles`)."""
    rows: int          # patch rows a tile, a multiple of the patches a warp holds
    cols: int          # patch columns a tile
    tiles_h: int       # tiles down a pair's grid
    tiles_w: int       # tiles across it
    win_rows: int      # plane rows a tile stages: (rows - 1) * steps + ps
    win_cols: int      # plane columns: (cols - 1) * steps + ps
    pitch: int         # the staged row pitch in floats: win_cols rounded up to odd
    shared_bytes: int  # 3 planes * win_rows * pitch * 4
    blocks: int        # a block a tile of each pair


@functools.lru_cache(maxsize=None)
def template_tiles(ps: int, steps: int, num_w: int, num_h: int, nb: int) -> TemplateTiles:
    """S1's tiles of a ``num_w`` x ``num_h`` patch grid of ``nb`` pairs, a
    block each, of at most a block's 256 threads of patches (a thread
    writes a patch's start): :data:`S1_TILE` halved, columns first, while
    the staged window would take more than :data:`S1_SHARED_TARGET` bytes
    and the tile can shrink (rows stay a multiple of the 32 / G patches a warp
    holds, so that a warp's patches are consecutive in the x-outer
    outputs).  The staged rows' pitch is odd, so that the up to 32
    distinct rows a warp reads at one tap fall in distinct banks."""
    per_warp = 32 // lane_layout(ps)[1]

    def layout(r, c):
        wr, wc = (r - 1) * steps + ps, (c - 1) * steps + ps
        return wr, wc, wc | 1, 3 * wr * (wc | 1) * F32

    r, c = max(S1_TILE[0], per_warp), S1_TILE[1]
    while layout(r, c)[3] > S1_SHARED_TARGET and (c > 1 or r > per_warp):
        if c > 1:
            c //= 2
        else:
            r = max(per_warp, r // 2 // per_warp * per_warp)
    wr, wc, pitch, shared = layout(r, c)
    th, tw = -(-num_h // r), -(-num_w // c)
    return TemplateTiles(r, c, th, tw, wr, wc, pitch, shared, nb * th * tw)


class DensifyTiles(NamedTuple):
    """S4's tiles of an output window (:func:`densify_tiles`)."""
    tiles_h: int       # tiles of DENSIFY_ROWS output rows down the window
    tiles_w: int       # tiles of DENSIFY_COLS output columns across it
    grid_rows: int     # grid rows a tile stages at most
    grid_cols: int     # grid columns a tile stages at most
    shared_bytes: int
    blocks: int        # a block a tile of each pair


@functools.lru_cache(maxsize=None)
def densify_tiles(nb: int, out_h: int, width: int, kr: int, kc: int, num_w: int,
                  weighted: bool) -> DensifyTiles:
    """S4's tiles of ``nb`` pairs' [out_h, width] output from a grid
    ``num_w`` columns wide whose cover tables are ``kr`` and ``kc`` wide.
    The plan's covers (``ops/grid.py::_cover``) of ``DENSIFY_ROWS``
    consecutive output rows reach at most ``ceil((DENSIFY_ROWS - 1) /
    steps) + kr`` grid rows, and likewise for columns, where the grid's
    stride ``steps`` is at least ``ceil(width / num_w)`` (``num_w =
    ceil(width / steps)``); a tile stages that many.  Covers that reach
    further are summed from device memory instead, with the same bits.  A
    tile's shared memory (``densify_bytes`` in ``csrc/scale_glue.cu``)
    holds its sub-block with a zero row and its row sums with a zero
    column, each term 16 bytes where weighted ({u0 w, u1 w, w, 0}), else 8
    ({u0, u1}); its uniform weights (4 bytes a pixel) where not weighted;
    and its covers as 32-bit indices."""
    steps_lo = -(-width // num_w) if num_w else 1
    grid_rows = -(-(DENSIFY_ROWS - 1) // steps_lo) + kr
    grid_cols = -(-(DENSIFY_COLS - 1) // steps_lo) + kc
    term = 16 if weighted else 8
    shared = (term * ((grid_rows + 1) * grid_cols + DENSIFY_ROWS * (grid_cols + 1))
              + F32 * ((0 if weighted else DENSIFY_ROWS * DENSIFY_COLS)
                       + DENSIFY_ROWS * kr + DENSIFY_COLS * kc))
    th, tw = -(-out_h // DENSIFY_ROWS), -(-width // DENSIFY_COLS)
    return DensifyTiles(th, tw, grid_rows, grid_cols, shared, nb * th * tw)


# -- S1: templates, inverse Hessians and the search start ---------------------------

def scale_templates(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, num_w: int,
                    num_h: int, steps: int, y0: int, x0: int, ps: int, residual: bool,
                    flow_coarse: Optional[torch.Tensor] = None,
                    nn_rows: Optional[torch.Tensor] = None,
                    nn_cols: Optional[torch.Tensor] = None, coarse_row_offset: int = 0,
                    centers: Optional[torch.Tensor] = None, width: int = 0, height: int = 0
                    ) -> Tuple[PatchTemplates, Optional[torch.Tensor], Optional[Start]]:
    """(templates [(B,) N, ...], Tn [(B,) N, ps^2] or None, start or None)
    of the ``num_w`` x ``num_h`` patch grid over the planes [(B,) th, tw],
    the first tap at plane row ``y0`` and column ``x0``
    (``ops/iclk.py::scale_templates_plain``).  Given the plan's
    ``centers`` [N, 2] and picks ``nn_rows`` [num_h] and ``nn_cols``
    [num_w], also the search start (init_u, pos0 [(B,) N, 2], conv0 [(B,)
    N] bool) of a scale of global size [height, width] from the coarser
    flow [(B,) hc, wc, 2] (None at the coarsest scale; its first global row
    ``coarse_row_offset``).  One launch of S1."""
    given = [t for t in (flow_coarse, nn_rows, nn_cols, centers) if t is not None]
    if all_on_cpu(img, dx, dy, *given):
        return scale_templates_plain(img, dx, dy, num_w, num_h, steps, y0, x0, ps, residual,
                                     flow_coarse, nn_rows, nn_cols, coarse_row_offset,
                                     centers, width, height)
    lane_layout(ps)   # raises for a size the kernel does not take
    if img.ndim not in (2, 3):
        raise ValueError(f"img must be [th, tw] or [B, th, tw], got {tuple(img.shape)}")
    dev = img.device
    for t, name in ((img, "img"), (dx, "dx"), (dy, "dy")):
        check_input(t, name, dev, torch.float32, img.shape)
    th, tw = img.shape[-2:]
    if num_w < 0 or num_h < 0 or steps < 1:
        raise ValueError(f"grid {num_w} x {num_h} with steps {steps}")
    if num_w * num_h and (y0 < 0 or x0 < 0 or y0 + (num_h - 1) * steps + ps > th
                          or x0 + (num_w - 1) * steps + ps > tw):
        raise ValueError(f"a {num_w} x {num_h} grid of patches {ps} wide, {steps} apart "
                         f"from ({y0}, {x0}), leaves the [{th}, {tw}] planes")
    if centers is None:
        if given:
            raise ValueError("the search start needs the plan's centers")
    else:
        if nn_rows is None or nn_cols is None:
            raise ValueError("the search start needs the plan's picks nn_rows and nn_cols")
        check_input(nn_rows, "nn_rows", dev, I64, (num_h,))
        check_input(nn_cols, "nn_cols", dev, I64, (num_w,))
        check_input(centers, "centers", dev, torch.float32, (num_w * num_h, 2))
        if flow_coarse is not None:
            if (flow_coarse.ndim != img.ndim + 1 or flow_coarse.shape[-1] != 2
                    or flow_coarse.shape[:-3] != img.shape[:-2]):
                raise ValueError(f"flow_coarse must be [hc, wc, 2] with img's pair axis, got "
                                 f"{tuple(flow_coarse.shape)} for img {tuple(img.shape)}")
            check_input(flow_coarse, "flow_coarse", dev, torch.float32, flow_coarse.shape)
    out = dispatch(scale_templates_op, _templates_cuda, dev, img, dx, dy, num_w, num_h, steps,
                   y0, x0, ps, residual, flow_coarse, nn_rows, nn_cols, coarse_row_offset,
                   centers, width, height)
    return (PatchTemplates(*out[:4]), out[4] if residual else None,
            None if centers is None else Start(*out[5:]))


def _templates_empty(img: T, dx: T, dy: T, num_w: int, num_h: int, steps: int, y0: int,
                     x0: int, ps: int, residual: bool, flow_coarse: Optional[T],
                     nn_rows: Optional[T], nn_cols: Optional[T], coarse_row_offset: int,
                     centers: Optional[T], width: int, height: int):
    lead = tuple(img.shape[:-2]) + (num_w * num_h,)
    taps = lead + (ps * ps,)
    flags = (0,) if centers is None else lead          # the start's, empty without it
    init = (0,) if centers is None else lead + (2,)
    return (img.new_empty(taps), img.new_empty(taps), img.new_empty(taps),
            img.new_empty(lead + (2, 2)), img.new_empty(taps if residual else (0,)),
            img.new_empty(init), img.new_empty(init),
            torch.empty(flags, dtype=torch.bool, device=img.device))


def _templates_cuda(img: T, dx: T, dy: T, num_w: int, num_h: int, steps: int, y0: int,
                    x0: int, ps: int, residual: bool, flow_coarse: Optional[T],
                    nn_rows: Optional[T], nn_cols: Optional[T], coarse_row_offset: int,
                    centers: Optional[T], width: int, height: int
                    ) -> Tuple[T, T, T, T, T, T, T, T]:
    """S1 on checked inputs: T, Tdx, Tdy, Hinv, Tn (empty [0] unless
    ``residual``) and init_u, pos0 and conv0 (each empty [0] without
    ``centers``).  The kernel takes the start and the coarser flow as
    flags; the valid region is ``out_of_bounds``'s."""
    out = _templates_empty(img, dx, dy, num_w, num_h, steps, y0, x0, ps, residual,
                           flow_coarse, nn_rows, nn_cols, coarse_row_offset, centers, width,
                           height)
    nb = _pairs(img.shape[:-2])
    n = num_w * num_h
    if nb * n == 0:
        return out
    tiles = template_tiles(ps, steps, num_w, num_h, nb)
    start = centers is not None
    coarser = start and flow_coarse is not None
    hc, wc = flow_coarse.shape[-3:-1] if coarser else (0, 0)
    _build.launch("dis_scale_templates", img.device, img.data_ptr(), dx.data_ptr(),
                  dy.data_ptr(), nb, *img.shape[-2:], n, num_h, steps, y0, x0, ps,
                  int(residual), inv_taps(ps), tiles.rows, tiles.cols, tiles.pitch,
                  tiles.shared_bytes, *(t.data_ptr() for t in out[:4]),
                  out[4].data_ptr() if residual else None, int(start), int(coarser),
                  flow_coarse.data_ptr() if coarser else None,
                  *(t.data_ptr() if start else None for t in (nn_rows, nn_cols)), hc, wc,
                  coarse_row_offset, centers.data_ptr() if start else None,
                  -float(ps) / 2.0, float(width + ps // 2 - 2), float(height + ps // 2 - 2),
                  *(t.data_ptr() if start else None for t in out[5:]))
    scale_templates.launches += 1
    return out


def _templates_cpu(img, dx, dy, num_w, num_h, steps, y0, x0, ps, residual, flow_coarse,
                   nn_rows, nn_cols, coarse_row_offset, centers, width, height):
    tpl, Tn, start = scale_templates_plain(img, dx, dy, num_w, num_h, steps, y0, x0, ps,
                                           residual, flow_coarse, nn_rows, nn_cols,
                                           coarse_row_offset, centers, width, height)
    if start is None:
        start = (img.new_empty((0,)), img.new_empty((0,)), torch.empty(0, dtype=torch.bool))
    return (*tpl, Tn if residual else img.new_empty((0,)), *start)


# -- S3: fixed mode's weights --------------------------------------------------------

def fixed_weights(Q: torch.Tensor, T: torch.Tensor, start_oob: torch.Tensor, ps: int,
                  normalize: bool) -> torch.Tensor:
    """Densification weights [(B,) N] from the final patches ``Q`` and the
    raw templates ``T`` [(B,) N, ps^2] (``ops/densify.py::
    fixed_weights_plain``).  One launch of S3."""
    if all_on_cpu(Q, T, start_oob):
        return fixed_weights_plain(Q, T, start_oob, ps, normalize)
    lane_layout(ps)
    if Q.ndim not in (2, 3):
        raise ValueError(f"Q must be [N, ps^2] or [B, N, ps^2], got {tuple(Q.shape)}")
    dev = Q.device
    lead = tuple(Q.shape[:-1])
    check_input(Q, "Q", dev, torch.float32, lead + (ps * ps,))
    check_input(T, "T", dev, torch.float32, lead + (ps * ps,))
    check_input(start_oob, "start_oob", dev, torch.bool, lead)
    return dispatch(fixed_weights_op, _weights_cuda, dev, Q, T, start_oob, ps, normalize)


def _weights_empty(Q: torch.Tensor, T: torch.Tensor, start_oob: torch.Tensor, ps: int,
                   normalize: bool):
    return Q.new_empty(tuple(Q.shape[:-1]))


def _weights_cuda(Q: torch.Tensor, T: torch.Tensor, start_oob: torch.Tensor, ps: int,
                  normalize: bool) -> torch.Tensor:
    """S3 on checked inputs: the mean divides by ``ps^2`` (a float) and the
    weight is the reciprocal of ``max(1, r2)``."""
    out = _weights_empty(Q, T, start_oob, ps, normalize)
    if out.numel() == 0:
        return out
    nb, n = (Q.shape[0], Q.shape[1]) if Q.ndim == 3 else (1, Q.shape[0])
    _build.launch("dis_fixed_weights", Q.device, Q.data_ptr(), T.data_ptr(),
                  start_oob.data_ptr(), nb, n, ps, int(normalize), float(ps * ps),
                  out.data_ptr())
    fixed_weights.launches += 1
    return out


# -- S4: densification ------------------------------------------------------------------

def densify(u: torch.Tensor, weights: Optional[torch.Tensor], cover_rows: torch.Tensor,
            cover_cols: torch.Tensor, uniform_wsum: Optional[torch.Tensor], num_w: int,
            num_h: int) -> torch.Tensor:
    """Dense flow [(B,) out_h, width, 2] from per-patch ``u`` [(B,) N, 2]
    and ``weights`` [(B,) N] or, for the uniform weight, the plan's weight
    plane ``uniform_wsum``, with the plan's cover indices
    (``ops/densify.py::densify_plain``).  One launch of S4 (none for an
    empty output)."""
    given = [t for t in (weights, uniform_wsum) if t is not None]
    if all_on_cpu(u, cover_rows, cover_cols, *given):
        return densify_plain(u, weights, cover_rows, cover_cols, uniform_wsum, num_w, num_h)
    if u.ndim not in (2, 3):
        raise ValueError(f"u must be [N, 2] or [B, N, 2], got {tuple(u.shape)}")
    if cover_rows.ndim != 2 or cover_cols.ndim != 2 or min(cover_rows.shape[1],
                                                            cover_cols.shape[1]) < 1:
        raise ValueError(f"cover indices {tuple(cover_rows.shape)} and "
                         f"{tuple(cover_cols.shape)} must be [out_h, K] and [width, K]")
    dev = u.device
    lead = tuple(u.shape[:-2])
    out_h, width = cover_rows.shape[0], cover_cols.shape[0]
    check_input(u, "u", dev, torch.float32, lead + (num_w * num_h, 2))
    if weights is not None:
        check_input(weights, "weights", dev, torch.float32, lead + (num_w * num_h,))
    check_input(cover_rows, "cover_rows", dev, I64, cover_rows.shape)
    check_input(cover_cols, "cover_cols", dev, I64, cover_cols.shape)
    if weights is None:
        if uniform_wsum is None:
            raise ValueError("densify needs the weights or the uniform weight plane")
        check_input(uniform_wsum, "uniform_wsum", dev, torch.float32, (out_h, width, 1))
    return dispatch(densify_op, _densify_cuda, dev, u, weights, cover_rows, cover_cols,
                    uniform_wsum, num_w, num_h)


def _densify_empty(u: T, weights: Optional[T], cover_rows: T, cover_cols: T,
                   uniform_wsum: Optional[T], num_w: int, num_h: int):
    return u.new_empty(tuple(u.shape[:-2]) + (cover_rows.shape[0], cover_cols.shape[0], 2))


def _densify_cuda(u: T, weights: Optional[T], cover_rows: T, cover_cols: T,
                  uniform_wsum: Optional[T], num_w: int, num_h: int) -> T:
    """S4 on checked inputs: the weight plane is read only without weights."""
    out = _densify_empty(u, weights, cover_rows, cover_cols, uniform_wsum, num_w, num_h)
    if out.numel() == 0:
        return out
    nb, (out_h, kr), (width, kc) = _pairs(u.shape[:-2]), cover_rows.shape, cover_cols.shape
    tiles = densify_tiles(nb, out_h, width, kr, kc, num_w, weights is not None)
    _build.launch("dis_densify", u.device, u.data_ptr(),
                  None if weights is None else weights.data_ptr(), cover_rows.data_ptr(),
                  cover_cols.data_ptr(), uniform_wsum.data_ptr() if weights is None else None,
                  int(weights is not None), nb, out_h, width, kr, kc, num_w, num_h,
                  tiles.grid_rows, tiles.grid_cols, tiles.shared_bytes, out.data_ptr())
    densify.launches += 1
    return out


scale_templates.launches = 0
fixed_weights.launches = 0
densify.launches = 0
scale_templates_op = register("scale_templates", _templates_cuda, _templates_empty,
                              _templates_cpu)
fixed_weights_op = register("fixed_weights", _weights_cuda, _weights_empty,
                            fixed_weights_plain)
densify_op = register("densify", _densify_cuda, _densify_empty, densify_plain)
