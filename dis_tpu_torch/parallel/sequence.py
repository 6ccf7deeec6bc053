"""Sequence sharding: the frames of a long video over the ranks of a
mesh axis; counterpart of ``dis_tpu/parallel/sequence.py``.

A [T, H, W] clip is sharded along time (``mesh.batch_sharding`` with
``axis="seq"``); pair (t, t+1) straddles shard boundaries, so each rank
receives its right neighbour's first frame by one :func:`mesh.shift`, a
one-frame halo.  Each rank then flows its local pairs as one batch
(K2b and K1b on a card): the bits of the serial pair loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DISConfig
from ..models.dis import dis_flow_padded
from .mesh import axis_group, shift


def _check_frames(name: str, x) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 3 or x.shape[0] == 0:
        got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"{name}: expected this rank's frames [Tl >= 1, H, W], got {got}")


def sequence_pair_flow_fn(cfg: DISConfig, mesh, axis: str = "seq"):
    """Returns fn(body, last) -> [Tl, h, w, 2]: one flow per pair, no
    dummy slot.  ``body`` is this rank's block ``[Tl, H, W]`` of the
    clip's first T-1 frames (``batch_sharding(mesh, clip[:-1], axis)``,
    which refuses unless ``(T - 1) % n == 0``) and ``last`` the clip's
    final frame ``[H, W]``, the last rank's halo (the other ranks may pass
    None).  Rank i returns the flows of pairs ``i Tl .. (i + 1) Tl - 1``."""
    group, n, idx = axis_group(mesh, axis)

    def run(body: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
        _check_frames("body", body)
        if idx == n - 1 and (last is None or last.shape != body.shape[1:]):
            raise ValueError(f"the last rank needs the clip's final frame "
                             f"{tuple(body.shape[1:])} as `last`")
        nxt = shift(body[0], group, [(j + 1, j) for j in range(n - 1)])
        if idx == n - 1:
            nxt = last
        ext = torch.cat([body, nxt[None]], dim=0)
        return dis_flow_padded(ext[:-1], ext[1:], cfg)

    return run


def sequence_flow_fn(cfg: DISConfig, mesh, axis: str = "seq"):
    """Returns fn(frames) -> [Tl, h, w, 2]: ``frames`` is this rank's
    block ``[Tl, H, W]`` of a clip of T frames (``batch_sharding(mesh,
    clip, axis)``, which refuses unless ``T % n == 0``); slot t holds the
    flow of pair (t, t+1).  The final slot of the clip (no successor
    frame) is zeros, so callers use ``flows[:-1]`` of the gathered result;
    the last rank does not flow it.  Where ``(T - 1) % n == 0``,
    :func:`sequence_pair_flow_fn` has no such slot."""
    group, n, idx = axis_group(mesh, axis)

    def run(frames: torch.Tensor) -> torch.Tensor:
        _check_frames("frames", frames)
        nxt = shift(frames[0], group, [(j + 1, j) for j in range(n - 1)])
        if idx < n - 1:
            ext = torch.cat([frames, nxt[None]], dim=0)
            return dis_flow_padded(ext[:-1], ext[1:], cfg)
        h, w = frames.shape[1:]
        f = 2 ** cfg.finest_scale
        zero = frames.new_zeros((1, h // f, w // f, 2))
        if frames.shape[0] == 1:
            return zero
        return torch.cat([dis_flow_padded(frames[:-1], frames[1:], cfg), zero])

    return run
