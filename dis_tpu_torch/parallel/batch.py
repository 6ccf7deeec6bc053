"""Batched multi-pair flow on one device; counterpart of
``dis_tpu/parallel/batch.py``.

A stack of same-shape pairs [B, H, W] runs through the pipeline once,
with the pair axis leading every tensor: on CUDA tensors one K3 launch
per image (up to four levels), one K2b and one K1b launch per scale, whatever B
is (the TPU side folds the pairs into its kernels' grids through their
``custom_vmap`` rules).  Each pair gets the bits it gets alone.

The JAX functions also take a ``mesh`` to shard the pairs over chips;
the multi-GPU form is not ported yet (ROADMAP.md queue 1, item 13), so
these take no ``mesh``.
"""

from __future__ import annotations

import torch

from ..config import DISConfig
from ..models.dis import dis_flow_padded
from ..utils.metrics import epe_torch


def _check_batched(aa) -> None:
    if isinstance(aa, torch.Tensor) and aa.ndim != 3:
        raise ValueError(f"expected a batch of pairs [B, H, W], got shape "
                         f"{tuple(aa.shape)}")


def batched_flow_fn(cfg: DISConfig):
    """Returns fn: ([B, H, W], [B, H, W]) -> [B, h, w, 2], flow at scale
    ``finest_scale`` of divisibility-padded pairs, on their device."""
    def run(aa, bb):
        _check_batched(aa)
        return dis_flow_padded(aa, bb, cfg)

    return run


def batched_flow_epe_fn(cfg: DISConfig):
    """Returns fn: (pairs1, pairs2, gt [B, h, w, 2]) -> (flows, mean EPE):
    the mean over the pairs of each pair's mean EPE, a scalar on the
    device."""
    def run(aa, bb, gg):
        _check_batched(aa)
        flows = dis_flow_padded(aa, bb, cfg)
        return flows, epe_torch(flows, gg).mean()

    return run
