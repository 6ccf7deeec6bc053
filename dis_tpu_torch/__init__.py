"""dis_tpu_torch — Dense Inverse Search optical flow in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``dis_tpu`` (JAX/Pallas on TPU), which stays the reference.
``dis_flow(img1, img2, cfg)`` runs on the device of its input tensors:
on CUDA tensors the pyramid levels, region extraction, IC-LK search and
the variational refinement of ``DIS_MEDIUM`` and ``DIS_FULL`` (its warp,
weight updates and SOR half-sweeps) run as CUDA kernels (``csrc/``, built
with ``nvcc`` at first use); on CPU tensors the same stages run as their
plain PyTorch versions.  It also takes a batch of same-shape pairs ``[B, H, W]``
(``parallel``), and ``serving.aot_compile`` captures one shape bucket into
a CUDA graph; ``serving.export_flow`` saves a bucket's program with
``torch.export``, the kernels as ``dis_tpu_torch`` ops.  The package never
imports JAX.
"""

from .config import (DISConfig, DIS_ULTRAFAST, DIS_FAST, DIS_MEDIUM,
                     DIS_FULL, DIS_COMPAT_DEFAULT, PRESETS)
from .models.dis import dis_flow, dis_flow_padded

__all__ = [
    "DISConfig", "DIS_ULTRAFAST", "DIS_FAST", "DIS_MEDIUM", "DIS_FULL",
    "DIS_COMPAT_DEFAULT", "PRESETS", "dis_flow", "dis_flow_padded",
]

__version__ = "0.1.0"
