"""State carried across from the JAX package, as NumPy arrays.

DIS has no learned weights: its "parameters" are the config and the
per-stage state (pyramid levels, templates).  These helpers build the
port's objects from what a ``dis_tpu`` stage produced, so a test can
feed one stage of the port exactly the JAX stage's outputs.  They take
NumPy arrays and plain Python values, never JAX objects.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np
import torch

from .config import DISConfig
from .ops.iclk import PatchTemplates
from .ops.pyramid import PyramidLevel


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def config_from_dict(d: Mapping) -> DISConfig:
    """A port config from ``dataclasses.asdict`` of a ``dis_tpu`` config."""
    return DISConfig(**dict(d))


def pyramid_from_numpy(levels: Iterable) -> List[PyramidLevel]:
    """Pyramid levels from ``(img, dx, dy, width, height)`` tuples of
    padded float32 planes, finest first, as CPU tensors."""
    return [PyramidLevel(img=_tensor(img), dx=_tensor(dx), dy=_tensor(dy),
                         width=int(w), height=int(h))
            for img, dx, dy, w, h in levels]


def templates_from_numpy(T: np.ndarray, Tdx: np.ndarray, Tdy: np.ndarray,
                         Hinv: np.ndarray) -> PatchTemplates:
    """Patch templates [N, ps*ps] and inverse Hessians [N, 2, 2], as CPU
    tensors."""
    return PatchTemplates(T=_tensor(T), Tdx=_tensor(Tdx), Tdy=_tensor(Tdy),
                          Hinv=_tensor(Hinv))
