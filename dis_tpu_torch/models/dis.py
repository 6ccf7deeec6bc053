"""Coarse-to-fine DIS orchestrator (optical_flow.cpp:19-132); counterpart
of ``dis_tpu/models/dis.py``.

``flow = dis_flow(img1, img2, cfg)`` runs on the device of its inputs:
on CUDA tensors every pyramid level, region extraction and search goes
through the hand-written kernels K3, K2 and K1; on CPU tensors through
their plain PyTorch versions.  Scale shapes are static and the scale loop
is a Python loop.

A batch of same-shape pairs ``[B, H, W]`` runs the same loop once, with
the pair axis leading every tensor: one K3 launch per level and image,
one K2 (K2b) and one K1 (K1b) launch per scale, whatever B is.  Each pair
of a batch gets the bits it gets alone.  Each scale's constants come from
its plan (``ops/grid.py::scale_plan``), made once per shape and device,
so a frame makes no host-to-device copy and no host sync, and can be
captured in a CUDA graph (``serving.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import DISConfig
from ..ops import iclk
from ..ops import image as im
from ..ops.densify import densify
from ..ops.grid import ScalePlan, init_from_coarser_flow, scale_plan
from ..ops.pyramid import construct_pyramid


def _fixed_weights(res: iclk.SearchResult, tpl: iclk.PatchTemplates,
                   cfg: DISConfig) -> torch.Tensor:
    """Residual-adaptive densification weights (DIS paper eq. 4):
    ``1 / max(1, ||Q - Tn||^2)`` with the mean-normalized template.
    Patches frozen at start never resampled (their ``Q`` is the raw
    template) and get the constant weight 1.0."""
    ps2 = cfg.num_points_patch
    Tn = tpl.T
    if cfg.patch_normalization:
        Tn = Tn - iclk.pairwise_sum(Tn)[..., None] / ps2
    r2 = iclk.pairwise_sum((res.Q - Tn) ** 2)
    return torch.where(res.start_oob, torch.ones_like(r2),
                       1.0 / torch.clamp(r2, min=1.0))


def motion_bound(cfg: DISConfig, scale: int) -> float:
    """Upper bound on |u| at ``scale`` from the policing chain: the
    coarsest init is zero and every scale adds at most ``ps/2`` on top
    of twice the coarser flow (patch.cpp:185-194 + patch_grid.cpp:116)."""
    b = cfg.outlier_thresh
    for _ in range(cfg.coarsest_scale - scale):
        b = 2.0 * b + cfg.outlier_thresh
    return b


def dis_scale_window(l1, l2, flow_coarse, cfg: DISConfig,
                     plain: bool = False):
    """One scale over the full frame: templates, the NN init from the
    coarser dense flow (None at the coarsest scale), the IC-LK search and
    densification.  Levels and flows may lead with a pair axis.  Returns
    (flow [(B,) h_s, w_s, 2], geom, SearchResult)."""
    sw, sh = l1.width, l1.height
    plan = scale_plan(sw, sh, cfg.steps, cfg.patch_size, l1.img.device)
    tpl = iclk.extract_templates_grid(l1.img, l1.dx, l1.dy, plan.geom,
                                      cfg.patch_size, cfg.img_padding)
    if flow_coarse is None:
        init_u = plan.centers.new_zeros(tpl.T.shape[:-1] + (2,))
    else:
        init_u = init_from_coarser_flow(plan, flow_coarse)
    res = iclk.inverse_search(l2.img, tpl, plan.centers, init_u, cfg, sw, sh,
                              plain=plain)
    wts = _fixed_weights(res, tpl, cfg) if cfg.mode == "fixed" else None
    flow = densify(res.u, plan, wts)
    return flow, plan.geom, res


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


def _check_supported(cfg: DISConfig) -> None:
    if cfg.refinement_iters > 0:
        raise NotImplementedError(
            "variational refinement (refinement_iters > 0, e.g. DIS_MEDIUM, "
            "DIS_FULL) is not ported yet: ROADMAP.md queue 1, item 9")


def dis_flow_padded(img1: torch.Tensor, img2: torch.Tensor,
                    cfg: DISConfig, plain: bool = False) -> torch.Tensor:
    """DIS flow on an already divisibility-padded float32 pair [H, W], or
    a batch of pairs [B, H, W].

    Returns flow at scale ``finest_scale``: [(B,) H / 2**finest,
    W / 2**finest, 2].
    ``plain=True`` runs the kernels' plain PyTorch versions on any device;
    it exists to check the kernels on the card.
    """
    _check_pair(img1, img2)
    _check_supported(cfg)
    h, w = img1.shape[-2:]
    f = 2 ** cfg.coarsest_scale
    if w % f or h % f:
        raise ValueError(f"padded input dims must be divisible by {f}")
    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding, plain)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding, plain)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        flow, _, _ = dis_scale_window(pyr1[scale], pyr2[scale], flow, cfg,
                                      plain=plain)
    return flow


def dis_flow(img1: torch.Tensor, img2: torch.Tensor,
             cfg: DISConfig = DISConfig(), plain: bool = False) -> torch.Tensor:
    """End-to-end flow for an arbitrary-size grayscale pair [H, W], or a
    batch of same-shape pairs [B, H, W], on the device of its inputs:
    divisibility padding (main.cpp:140-155), the pipeline, the
    finest-scale upsample (main.cpp:191-196) and the crop (main.cpp:198).
    Returns [(B,) H, W, 2] float32."""
    _check_pair(img1, img2)
    _check_supported(cfg)
    h, w = img1.shape[-2:]
    p1, (padw, padh) = im.pad_divisible(img1.to(torch.float32), cfg.coarsest_scale)
    p2, _ = im.pad_divisible(img2.to(torch.float32), cfg.coarsest_scale)
    flow = dis_flow_padded(p1, p2, cfg, plain=plain)
    if cfg.finest_scale != 0:
        flow = flow * float(2 ** cfg.finest_scale)
        flow = im.resize_bilinear(flow, p1.shape[-1], p1.shape[-2])
    return im.crop_padding(flow, padw, padh, w, h)
