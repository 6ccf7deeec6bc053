"""K1 and K1b: the IC-LK search loop at one scale (``csrc/iclk.cu``).

Replaces ``dis_tpu/ops/pallas/iclk_kernel.py::inverse_search_pallas``
(kernel body ``_iclk_kernel``; K1) and its batched rule ``_run_vmap``
(K1b), which folds a batch of pairs into the launch: one launch over
``B * N`` patches, the shared centers read at ``patch % N``.  Bound on
the H100 by instruction issue, not memory: a group of G lanes per patch
(:func:`lane_layout`; four patches per warp at ps 8), regions in shared
memory, K taps per lane in registers, sums as an in-lane pair tree plus
a butterfly over the group, ps a compile-time constant for 8, 10, 12
and 16.  Plain version: ``ops/iclk.py::iclk_search_plain``, which the
kernel equals bitwise (same pair trees, no FMA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import _build
from ...config import DISConfig
from ..iclk import PatchTemplates, iclk_search_plain, inv_taps, region_size
from . import all_on_cpu, check_input, dispatch, launched, register

MAX_TAPS = 512   # ps^2 limit of the kernel's register tiles (ps <= 22)


def lane_layout(ps: int) -> Tuple[int, int]:
    """(K, G): taps per lane and lanes per patch of the kernel for patch
    size ``ps``; ``G * K`` is the power of two >= ps^2 and K is 8 where
    ``G <= 32`` allows it (a copy of ``dis_iclk_layout`` in
    ``csrc/iclk.cu``).  Every sum over a patch's taps is the pair tree over
    K taps in a lane, then log2(G) xor-butterfly levels."""
    if ps < 2 or ps % 2 or ps * ps > MAX_TAPS:
        raise ValueError(f"patch_size {ps}: the kernel takes even sizes with "
                         f"ps^2 <= {MAX_TAPS}")
    p = 1
    while p < ps * ps:
        p *= 2
    k = p // 32 if p > 256 else min(p, 8)
    return k, p // k


def iclk_search(regions: torch.Tensor, base_y: torch.Tensor,
                base_x: torch.Tensor, tpl: PatchTemplates,
                Tn: Optional[torch.Tensor], centers: torch.Tensor,
                init_u: torch.Tensor, conv0: torch.Tensor, cfg: DISConfig,
                width: int, height: int, row0: int = 0):
    """(u [(B,) N, 2], Q [(B,) N, ps*ps], converged [(B,) N] bool).
    ``Tn`` is the fixed-mode residual template (None in compat mode).
    Every per-patch input carries the pair axis of ``init_u`` [(B,) N, 2];
    ``centers`` [N, 2] is shared by the pairs.  ``row0`` is the global row
    of the first row of the plane the regions came from."""
    fixed = cfg.mode == "fixed"
    tensors = [regions, base_y, base_x, *tpl, centers, init_u, conv0]
    if fixed:
        if Tn is None:
            raise ValueError("fixed mode needs the residual template Tn")
        tensors.append(Tn)
    if all_on_cpu(*tensors):
        return iclk_search_plain(regions, base_y, base_x, tpl, Tn, centers,
                                 init_u, conv0, cfg, width, height, row0)
    ps = cfg.patch_size
    np_ = ps * ps
    lane_layout(ps)   # raises for a size the kernel does not take
    dev = regions.device
    n = centers.shape[0]
    if init_u.ndim not in (2, 3):
        raise ValueError(f"init_u must be [N, 2] or [B, N, 2], got {tuple(init_u.shape)}")
    lead = tuple(init_u.shape[:-2])
    rc = region_size(ps)
    f32 = torch.float32
    for t, name, dtype, shape in [
            (regions, "regions", f32, lead + (n, rc, rc)),
            (base_y, "base_y", torch.int32, lead + (n,)),
            (base_x, "base_x", torch.int32, lead + (n,)),
            (tpl.T, "T", f32, lead + (n, np_)), (tpl.Tdx, "Tdx", f32, lead + (n, np_)),
            (tpl.Tdy, "Tdy", f32, lead + (n, np_)),
            (tpl.Hinv, "Hinv", f32, lead + (n, 2, 2)),
            (centers, "centers", f32, (n, 2)), (init_u, "init_u", f32, lead + (n, 2)),
            (conv0, "conv0", torch.bool, lead + (n,))]:
        check_input(t, name, dev, dtype, shape)
    if fixed:
        check_input(Tn, "Tn", dev, f32, lead + (n, np_))
    return dispatch(iclk_search_op, _search_cuda, dev, regions, base_y, base_x, *tpl,
                    Tn if fixed else None, centers, init_u, conv0, ps, cfg.iterations,
                    row0, width, height, cfg.patch_normalization, fixed, cfg.conv_eps)


def _empty_result(init_u: torch.Tensor, ps: int):
    lead = tuple(init_u.shape[:-1])
    dev = init_u.device
    return (torch.empty(lead + (2,), dtype=torch.float32, device=dev),
            torch.empty(lead + (ps * ps,), dtype=torch.float32, device=dev),
            torch.empty(lead, dtype=torch.bool, device=dev))


def _search_cuda(regions: torch.Tensor, base_y: torch.Tensor, base_x: torch.Tensor,
                 T: torch.Tensor, Tdx: torch.Tensor, Tdy: torch.Tensor,
                 Hinv: torch.Tensor, Tn: Optional[torch.Tensor], centers: torch.Tensor,
                 init_u: torch.Tensor, conv0: torch.Tensor, ps: int, iterations: int,
                 row0: int, width: int, height: int, normalize: bool, fixed: bool,
                 conv_eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1/K1b on checked inputs: ``iterations + 1`` trips, the padding
    ``ps`` and the policing threshold ``ps / 2`` (``DISConfig``'s)."""
    u, Q, conv = _empty_result(init_u, ps)
    nb = init_u.shape[0] if init_u.ndim == 3 else 1
    n = centers.shape[0]
    if nb * n == 0:
        return u, Q, conv
    _build.launch(
        "dis_iclk_search", init_u.device, regions.data_ptr(), base_y.data_ptr(),
        base_x.data_ptr(), T.data_ptr(), Tdx.data_ptr(), Tdy.data_ptr(),
        Tn.data_ptr() if fixed else None, Hinv.data_ptr(), centers.data_ptr(),
        init_u.data_ptr(), conv0.data_ptr(), nb, n, ps, iterations + 1, ps, row0, width,
        height, int(normalize), int(fixed), ps / 2.0, conv_eps, inv_taps(ps),
        u.data_ptr(), Q.data_ptr(), conv.data_ptr())
    launched("iclk_search", "K1b" if init_u.ndim == 3 else "K1", iclk_search)
    return u, Q, conv


def _search_fake(regions, base_y, base_x, T, Tdx, Tdy, Hinv, Tn, centers, init_u, conv0,
                 ps, iterations, row0, width, height, normalize, fixed, conv_eps):
    return _empty_result(init_u, ps)


def _search_cpu(regions, base_y, base_x, T, Tdx, Tdy, Hinv, Tn, centers, init_u, conv0,
                ps, iterations, row0, width, height, normalize, fixed, conv_eps):
    cfg = DISConfig(iterations=iterations, patch_size=ps, patch_normalization=normalize,
                    mode="fixed" if fixed else "compat", conv_eps=conv_eps)
    return iclk_search_plain(regions, base_y, base_x, PatchTemplates(T, Tdx, Tdy, Hinv),
                             Tn, centers, init_u, conv0, cfg, width, height, row0)


iclk_search.launches = 0
iclk_search_op = register("iclk_search", _search_cuda, _search_fake, _search_cpu)
