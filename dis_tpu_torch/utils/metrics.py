"""Flow accuracy metrics; counterpart of ``dis_tpu/utils/metrics.py``.

The reference never scores itself (SURVEY.md section 5: no EPE code
anywhere); these are new.  EPE/AE definitions follow the
Middlebury/Sintel convention.  :func:`epe`, :func:`angular_error` and
:func:`bad_pixel_ratio` are NumPy copies of the JAX package's functions
of the same names (the CLI scores with :func:`epe`); :func:`epe_torch`
is the counterpart of ``epe_jax``, a reduction that stays on the
device.  ``tests/test_torch_utils.py`` holds each equal to its original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def epe(flow: np.ndarray, gt: np.ndarray, valid: Optional[np.ndarray] = None) -> float:
    """Average endpoint error. ``valid`` is an optional [H, W] mask
    (KITTI-style sparse GT; Sintel GT marks invalid with |.| > 1e9)."""
    d = flow[..., :2] - gt[..., :2]
    e = np.sqrt((d * d).sum(-1))
    if valid is None:
        valid = (np.abs(gt[..., 0]) < 1e9) & (np.abs(gt[..., 1]) < 1e9)
    valid = valid & np.isfinite(e)
    return float(e[valid].mean()) if valid.any() else float("nan")


def angular_error(flow: np.ndarray, gt: np.ndarray) -> float:
    """Mean angular error (degrees) in the (u, v, 1) homogeneous sense."""
    num = (flow[..., 0] * gt[..., 0] + flow[..., 1] * gt[..., 1] + 1.0)
    den = np.sqrt((flow[..., 0] ** 2 + flow[..., 1] ** 2 + 1.0)
                  * (gt[..., 0] ** 2 + gt[..., 1] ** 2 + 1.0))
    cos = np.clip(num / den, -1.0, 1.0)
    valid = (np.abs(gt[..., 0]) < 1e9) & (np.abs(gt[..., 1]) < 1e9) & np.isfinite(cos)
    return float(np.degrees(np.arccos(cos[valid])).mean()) if valid.any() else float("nan")


def bad_pixel_ratio(flow: np.ndarray, gt: np.ndarray, thresh: float = 3.0,
                    rel: float = 0.05,
                    valid: Optional[np.ndarray] = None) -> float:
    """KITTI Fl-style outlier ratio: EPE > thresh AND EPE > rel*|gt|.

    ``valid`` is the GT validity mask ([H, W] bool).  It is REQUIRED for
    sparse KITTI GT: loaders zero invalid pixels, so without the mask
    ~50% of pixels would be scored against gt=(0, 0) and both the
    denominator and the outlier count would be wrong.  When omitted,
    Sintel-style sentinels (|gt| > 1e9 / NaN) are masked as in epe()."""
    d = flow[..., :2] - gt[..., :2]
    e = np.sqrt((d * d).sum(-1))
    mag = np.sqrt((gt[..., :2] ** 2).sum(-1))
    if valid is None:
        valid = (np.abs(gt[..., 0]) < 1e9) & (np.abs(gt[..., 1]) < 1e9)
    valid = valid & np.isfinite(e)
    bad = (e > thresh) & (e > rel * mag) & valid
    return float(bad.sum() / valid.sum()) if valid.any() else float("nan")


def epe_torch(flow: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
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
