"""Configuration of the DIS pipeline (copy of ``dis_tpu/config.py``).

``dis_tpu/__init__.py`` imports JAX, so the port cannot import the
framework-free config from there; it carries this copy instead.
``tests/test_torch_package.py`` holds the two copies equal field by
field for every preset, including the derived ``steps``,
``outlier_thresh`` and ``img_padding``.

The fields and their validation are those of the JAX package.  Two of
them select JAX-only routes and are accepted but not read here:
``sampler`` and ``kernel``.  In the port the device of the input
tensors picks the route: CUDA tensors go through the hand-written
kernels, CPU tensors through their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """Parameters of the DIS pipeline.

    Compat-core parameters (the reference CLI's ten positional args):
    ``iterations``, ``patch_size``, ``coarsest_scale``, ``finest_scale``,
    ``patch_overlap`` (patch stride ``steps = max(1, floor(ps * (1 -
    overlap)))``) and ``patch_normalization`` (mean-subtract the warped
    query patch).

    ``mode="compat"`` reproduces the reference's quirks (SURVEY.md Q1-Q10);
    ``"fixed"`` subtracts the template from the residual, adds a
    per-patch convergence test (``|delta_u| < conv_eps``) and
    residual-adaptive densification weights.  ``refinement_*`` configure
    the variational refinement, which the port does not run yet.
    """

    iterations: int = 1000
    patch_size: int = 8
    coarsest_scale: int = 3
    finest_scale: int = 0
    patch_overlap: float = 0.7
    patch_normalization: bool = True

    mode: str = "compat"  # "compat" | "fixed"
    sampler: str = "region"  # JAX route; not read by the port
    kernel: str = "auto"  # JAX route; not read by the port
    refinement_iters: int = 0
    refinement_alpha: float = 10.0
    refinement_delta: float = 5.0
    refinement_gamma: float = 10.0
    refine_per_level: bool = False
    refined_init_clamp: bool = False
    refinement_inner_sweeps: int = 5
    refinement_sor_sweeps: int = 1
    refinement_omega: float = 1.0
    refinement_scheme: str = "planes6"
    refinement_planes: str = "q1"
    early_exit: bool = True
    conv_eps: float = 0.01

    def __post_init__(self):
        if self.mode not in ("compat", "fixed"):
            raise ValueError(f"mode must be 'compat' or 'fixed', got {self.mode!r}")
        if self.sampler not in ("region", "global"):
            raise ValueError(f"sampler must be 'region' or 'global', got {self.sampler!r}")
        if self.kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"kernel must be 'auto', 'pallas' or 'xla', got {self.kernel!r}")
        if self.refinement_scheme not in ("planes6", "warp1"):
            raise ValueError(
                f"refinement_scheme must be 'planes6' or 'warp1', "
                f"got {self.refinement_scheme!r}")
        if self.refinement_planes not in ("q1", "intensity"):
            raise ValueError(
                f"refinement_planes must be 'q1' or 'intensity', "
                f"got {self.refinement_planes!r}")
        if self.patch_size % 2 != 0:
            raise ValueError("patch_size must be even (reference uses ps/2 offsets)")
        if self.finest_scale > self.coarsest_scale:
            raise ValueError("finest_scale must be <= coarsest_scale")

    @property
    def steps(self) -> int:
        """Patch-center stride in px (``optical_flow.cpp:38``)."""
        return max(1, int(math.floor(self.patch_size * (1.0 - self.patch_overlap))))

    @property
    def outlier_thresh(self) -> float:
        """Max displacement from the scale's start position (``optical_flow.cpp:34``)."""
        return float(self.patch_size) / 2.0

    @property
    def num_points_patch(self) -> int:
        return self.patch_size * self.patch_size

    @property
    def img_padding(self) -> int:
        """Per-level border padding equals patch_size (``main.cpp:177``)."""
        return self.patch_size

    @property
    def num_scales(self) -> int:
        return self.coarsest_scale - self.finest_scale + 1

    def scale_dims(self, width: int, height: int, scale: int) -> Tuple[int, int]:
        """(w, h) at pyramid scale ``scale`` for padded input dims."""
        f = 2.0 ** (-scale)
        return int(width * f), int(height * f)


DIS_ULTRAFAST = DISConfig(
    iterations=12, patch_size=8, coarsest_scale=3, finest_scale=1,
    patch_overlap=0.3, mode="fixed", early_exit=True,
)

DIS_FAST = DISConfig(
    iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
    patch_overlap=0.3, patch_normalization=True, mode="fixed",
    early_exit=True,
)

DIS_MEDIUM = DISConfig(
    iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
    patch_overlap=0.5, mode="fixed", early_exit=True,
    refinement_iters=1, refine_per_level=True,
    refinement_inner_sweeps=5, refinement_sor_sweeps=5,
    refinement_omega=1.6,
    refinement_planes="intensity", refinement_alpha=40.0,
)

DIS_FULL = DISConfig(
    iterations=64, patch_size=12, coarsest_scale=4, finest_scale=0,
    patch_overlap=0.75, mode="fixed", early_exit=True,
    refinement_iters=1, refine_per_level=True,
    refinement_inner_sweeps=10, refinement_sor_sweeps=5,
    refinement_omega=1.6,
    refinement_planes="intensity", refinement_alpha=40.0,
)

DIS_COMPAT_DEFAULT = DISConfig()

PRESETS = {
    "ultrafast": DIS_ULTRAFAST,
    "fast": DIS_FAST,
    "medium": DIS_MEDIUM,
    "full": DIS_FULL,
    "compat": DIS_COMPAT_DEFAULT,
}
