"""Flow metrics on the device; counterpart of ``dis_tpu/utils/metrics.py``
(so far only ``epe_jax``, as :func:`epe`)."""

from __future__ import annotations

import torch


def epe(flow: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean end-point error of ``flow`` against ``gt`` [..., H, W, >= 2]
    over valid pixels, per leading index: [H, W, 2] gives a scalar,
    [B, H, W, 2] gives [B].  Pixels whose ground truth is a sentinel
    (``|gt| >= 1e9``) or whose error is not finite are left out, as in
    ``epe_jax``; with none valid the mean is 0.  Stays on the device."""
    d = flow[..., :2] - gt[..., :2]
    e = torch.sqrt((d * d).sum(-1))
    valid = ((gt[..., 0].abs() < 1e9) & (gt[..., 1].abs() < 1e9)
             & torch.isfinite(e))
    e = torch.where(valid, e, torch.zeros_like(e))
    return e.sum((-2, -1)) / valid.sum((-2, -1)).clamp(min=1)
