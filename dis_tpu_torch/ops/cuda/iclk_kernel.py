"""K1 and K1b: the IC-LK search loop at one scale (``csrc/iclk.cu``).

Replaces ``dis_tpu/ops/pallas/iclk_kernel.py::inverse_search_pallas``
(kernel body ``_iclk_kernel``; K1) and its batched rule ``_run_vmap``
(K1b), which folds a batch of pairs into the launch: one launch over
``B * N`` patches, the shared centers read at ``patch % N``.  Bound on
the H100 by the latency of the dependent iteration chain, not memory;
one warp per patch, region in shared memory, taps in registers, sums as
an in-lane pair tree plus a warp butterfly.  Plain version:
``ops/iclk.py::iclk_search_plain``, which the kernel equals bitwise (same
pair trees, no FMA).
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import _build
from ...config import DISConfig
from ..iclk import PatchTemplates, iclk_search_plain, inv_taps, region_size
from . import all_on_cpu, check_input

MAX_TAPS = 512   # ps^2 limit of the kernel's register tiles (ps <= 22)


def iclk_search(regions: torch.Tensor, base_y: torch.Tensor,
                base_x: torch.Tensor, tpl: PatchTemplates,
                Tn: Optional[torch.Tensor], centers: torch.Tensor,
                init_u: torch.Tensor, conv0: torch.Tensor, cfg: DISConfig,
                width: int, height: int):
    """(u [(B,) N, 2], Q [(B,) N, ps*ps], converged [(B,) N] bool).
    ``Tn`` is the fixed-mode residual template (None in compat mode).
    Every per-patch input carries the pair axis of ``init_u`` [(B,) N, 2];
    ``centers`` [N, 2] is shared by the pairs."""
    fixed = cfg.mode == "fixed"
    tensors = [regions, base_y, base_x, *tpl, centers, init_u, conv0]
    if fixed:
        if Tn is None:
            raise ValueError("fixed mode needs the residual template Tn")
        tensors.append(Tn)
    if all_on_cpu(*tensors):
        return iclk_search_plain(regions, base_y, base_x, tpl, Tn, centers,
                                 init_u, conv0, cfg, width, height)
    ps = cfg.patch_size
    np_ = ps * ps
    if np_ > MAX_TAPS:
        raise ValueError(f"patch_size {ps} exceeds the kernel's limit of "
                         f"{MAX_TAPS} taps per patch")
    dev = regions.device
    n = centers.shape[0]
    if init_u.ndim not in (2, 3):
        raise ValueError(f"init_u must be [N, 2] or [B, N, 2], got {tuple(init_u.shape)}")
    lead = tuple(init_u.shape[:-2])
    nb = lead[0] if lead else 1
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
    u = torch.empty(lead + (n, 2), dtype=f32, device=dev)
    Q = torch.empty(lead + (n, np_), dtype=f32, device=dev)
    conv = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    if nb * n == 0:
        return u, Q, conv
    _build.launch(
        "dis_iclk_search", dev, regions.data_ptr(), base_y.data_ptr(),
        base_x.data_ptr(), tpl.T.data_ptr(), tpl.Tdx.data_ptr(),
        tpl.Tdy.data_ptr(), Tn.data_ptr() if fixed else None,
        tpl.Hinv.data_ptr(), centers.data_ptr(), init_u.data_ptr(),
        conv0.data_ptr(), nb, n, ps, cfg.iterations + 1, cfg.img_padding, width,
        height, int(cfg.patch_normalization), int(fixed),
        cfg.outlier_thresh, cfg.conv_eps, inv_taps(ps), u.data_ptr(),
        Q.data_ptr(), conv.data_ptr())
    iclk_search.launches += 1
    return u, Q, conv


iclk_search.launches = 0
