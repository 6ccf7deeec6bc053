"""The serving path: a fixed-shape flow executable; counterpart of
``dis_tpu/serving.py`` (``aot_compile`` and ``CompiledFlow``).

:func:`aot_compile` builds a :class:`CompiledFlow` for one shape bucket,
a single pair [H, W] or a batch [B, H, W].  On a CUDA device it runs
``dis_flow`` on static input buffers a few times on a side stream (which
builds the kernels and the per-scale plans), then captures one call into
a ``torch.cuda.CUDAGraph``; each request copies its frames into the
static inputs and replays the graph, so no Python runs per kernel and no
op is dispatched from the host.  A CUDA device either captures or
raises.  On an explicitly requested CPU device the executable is the
same planned eager ``dis_flow``, with the same shape guard.

Not ported yet (ROADMAP.md queue 1, item 11): ``cost_analysis`` and
``memory_analysis`` (XLA's own reports), and ``export_flow``,
``save_exported``, ``load_exported`` and the serving CLI, which need a
design for a saved artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .config import DISConfig
from .models.dis import dis_flow, flow_plans
from .ops.cuda.extract_banded_kernel import extract_regions_banded
from .ops.cuda.extract_kernel import extract_regions
from .ops.cuda.iclk_kernel import iclk_search
from .ops.cuda.pyramid_kernel import pyramid_levels
from .ops.grid import ScalePlan

WARMUP_CALLS = 2


@dataclasses.dataclass
class CompiledFlow:
    """A fixed-shape flow executable, made by :func:`aot_compile`.  Inputs
    must be ``(height, width)`` (with the leading ``batch`` dim if set);
    call it as ``flow = compiled(img1, img2)``."""

    cfg: DISConfig
    height: int
    width: int
    batch: Optional[int]
    device: torch.device
    # The per-scale plans of the bucket, coarsest first.  The graph reads
    # their device memory at every replay, so the executable owns them.
    plans: Tuple[ScalePlan, ...] = dataclasses.field(init=False, default=())
    graph: Optional[torch.cuda.CUDAGraph] = dataclasses.field(
        init=False, default=None)                  # None on the CPU
    static_in: Tuple[torch.Tensor, ...] = dataclasses.field(init=False, default=())
    static_out: Optional[torch.Tensor] = dataclasses.field(init=False, default=None)
    # Kernel launches recorded into the graph, by kernel; every replay runs
    # them all.  (A wrapper counts a launch when it is captured, not when
    # it is replayed.)
    graph_launches: Dict[str, int] = dataclasses.field(init=False,
                                                       default_factory=dict)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        hw = (self.height, self.width)
        return hw if self.batch is None else (self.batch,) + hw

    def __call__(self, img1, img2) -> torch.Tensor:
        """Flow [(B,) H, W, 2] float32 on the executable's device.  On CUDA
        the result is a fresh tensor (a clone of the graph's output
        buffer), so it stays valid across later calls."""
        a, b = torch.as_tensor(img1), torch.as_tensor(img2)
        want = self.input_shape
        if tuple(a.shape) != want or tuple(b.shape) != want:
            raise ValueError(
                f"compiled for {want}, got {tuple(a.shape)} / {tuple(b.shape)}; "
                "aot_compile a new bucket for other shapes")
        if self.device.type == "cpu":
            f32 = torch.float32
            return dis_flow(a.to(self.device, f32), b.to(self.device, f32), self.cfg)
        if self.graph is None:
            raise RuntimeError(f"CompiledFlow on {self.device} holds no captured "
                               "graph: make it with aot_compile")
        self.static_in[0].copy_(a)
        self.static_in[1].copy_(b)
        self.graph.replay()
        return self.static_out.clone()


def aot_compile(cfg: DISConfig, height: int, width: int,
                batch: Optional[int] = None,
                device="cuda") -> CompiledFlow:
    """The flow pipeline for one shape bucket, built now rather than at
    the first request.  ``batch=None`` takes a single pair [H, W];
    ``batch=B`` a batch [B, H, W], whose kernels fold the pairs into
    their launches.  A refinement config (``DIS_MEDIUM``, ``DIS_FULL``)
    captures its sweeps into the same graph."""
    dev = torch.device(device)
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be None or >= 1, got {batch}")
    compiled = CompiledFlow(cfg, height, width, batch, dev)
    if dev.type == "cpu":
        compiled.plans = flow_plans(cfg, height, width, dev)
        return compiled
    if dev.type != "cuda":
        raise ValueError(f"aot_compile takes a CUDA or CPU device, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"aot_compile on {dev}: no CUDA device is available "
                           "(pass device='cpu' for the eager CPU executable)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
        compiled.device = dev
    _build.library()        # build and load the kernels before any capture
    with torch.cuda.device(dev):
        # Made here, before the warm-up: the capture fetches these same
        # plans from the cache and records their memory.
        compiled.plans = flow_plans(cfg, height, width, dev)
        static_in = tuple(torch.zeros(compiled.input_shape, dtype=torch.float32,
                                      device=dev) for _ in range(2))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                dis_flow(*static_in, cfg)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph):
            static_out = dis_flow(*static_in, cfg)
        after = _launch_counts()
    compiled.graph, compiled.static_in, compiled.static_out = graph, static_in, static_out
    compiled.graph_launches = {k: after[k] - before[k] for k in after}
    return compiled


def _launch_counts() -> Dict[str, int]:
    return {"K3": pyramid_levels.launches, "K2": extract_regions.launches,
            "K2c": extract_regions_banded.launches, "K1": iclk_search.launches}
