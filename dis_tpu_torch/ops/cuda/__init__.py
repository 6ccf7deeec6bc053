"""Wrappers of the hand-written CUDA kernels K1-K3 (K2 and K1 with their
batched forms K2b and K1b: a leading pair axis on their inputs) and K2c,
the column-banded form of K2.

Each wrapper takes its kernel's plain PyTorch version when every input
tensor lies on the CPU; otherwise it checks the inputs (CUDA, one
device, dtype, shape, contiguity), allocates the outputs with
``torch.empty``, launches the kernel on the current stream and adds one
to its ``launches`` count.  There is no fallback from a CUDA tensor to
the plain version.
"""

from __future__ import annotations

import torch


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_input(t: torch.Tensor, name: str, device: torch.device,
                dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA device ``device``."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel takes tensors "
                         f"on one CUDA device ({device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
