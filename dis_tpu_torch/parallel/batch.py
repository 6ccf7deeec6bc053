"""Batched multi-pair flow, on one device or sharded over the ranks of a
mesh axis; counterpart of ``dis_tpu/parallel/batch.py``.

A stack of same-shape pairs [B, H, W] runs through the pipeline once,
with the pair axis leading every tensor: on CUDA tensors one K3 launch
per image (up to four levels), one K2b and one K1b launch per scale, whatever B
is (the TPU side folds the pairs into its kernels' grids through their
``custom_vmap`` rules).  Each pair gets the bits it gets alone.

With a ``mesh``, each rank of its ``axis`` flows its own block of B/n
pairs (``mesh.batch_sharding``) the same way; no pair crosses ranks.  The
mean EPE gathers the B per-pair EPEs and averages them in pair order on
every rank, so it has the single-device bits.
"""

from __future__ import annotations

import torch

from ..config import DISConfig
from ..models.dis import dis_flow_padded
from ..utils.metrics import epe_torch
from .mesh import all_gather_rows, axis_group


def _check_batched(aa) -> None:
    if isinstance(aa, torch.Tensor) and aa.ndim != 3:
        raise ValueError(f"expected a batch of pairs [B, H, W], got shape "
                         f"{tuple(aa.shape)}")


def _pair_epes(flows: torch.Tensor, gg: torch.Tensor) -> torch.Tensor:
    """[B] per-pair mean EPEs, each reduced alone (``epe_torch`` on one
    pair), so a pair's EPE has the same bits in any batch: on the card,
    one reduction over 8 KITTI-size pairs gives some pairs other bits
    than one over 4 (``chip_smoke.py`` phase 5d)."""
    return torch.stack([epe_torch(f, g) for f, g in zip(flows, gg)])


def batched_flow_fn(cfg: DISConfig, mesh=None, axis: str = "batch"):
    """Returns fn: ([B, H, W], [B, H, W]) -> [B, h, w, 2], flow at scale
    ``finest_scale`` of divisibility-padded pairs, on their device.  With
    a ``mesh`` the arguments and the result are this rank's block of
    pairs along ``axis``."""
    if mesh is not None:
        axis_group(mesh, axis)   # this rank must be on the axis

    def run(aa, bb):
        _check_batched(aa)
        return dis_flow_padded(aa, bb, cfg)

    return run


def batched_flow_epe_fn(cfg: DISConfig, mesh=None, axis: str = "batch"):
    """Returns fn: (pairs1, pairs2, gt [B, h, w, 2]) -> (flows, mean EPE):
    the mean over the pairs of each pair's mean EPE, a scalar on the
    device.  With a ``mesh`` the arguments and flows are this rank's block
    of pairs along ``axis`` and the mean is over all the axis's pairs,
    equal on every rank and to the single-device mean bitwise."""
    group = None if mesh is None else axis_group(mesh, axis)[0]

    def run(aa, bb, gg):
        _check_batched(aa)
        flows = dis_flow_padded(aa, bb, cfg)
        epes = _pair_epes(flows, gg)
        if group is not None:
            epes = all_gather_rows(epes, group)
        return flows, epes.mean()

    return run
