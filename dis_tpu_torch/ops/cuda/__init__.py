"""Wrappers of the hand-written CUDA kernels K1-K3 (K2 and K1 with their
batched forms K2b and K1b: a leading pair axis on their inputs), K2c,
the column-banded form of K2, the refinement's R0, R1, R23 and R3, each
scale's S1, S3 and S4 and the frame's F1-F3, and the ops they launch
through.

Each C entry point of ``csrc/`` is registered as an op of the
``dis_tpu_torch`` namespace (``torch.library.custom_op``) with a flat
schema of tensors, ints, floats and bools, 16 ops: ``pyramid_levels``
(K3), ``extract_regions`` (K2, K2b), ``extract_regions_banded`` (K2c),
``iclk_search`` and ``iclk_search_plane`` (K1, K1b; the second in its
plane mode), ``refine_planes`` (R0), ``refine_setup`` and
``refine_setup_warp1`` (R1 in its setup and warp1 modes),
``refine_update`` (R23), ``refine_nosweep`` (R3 in its no-sweep mode),
``scale_templates`` (S1, the search start included), ``fixed_weights``
and ``densify`` (S3, S4), ``frame_pad``, ``intensity_levels`` and
``frame_finish`` (F1-F3).  Each op has three
functions: for CUDA, which allocates the outputs with ``torch.empty``,
launches the kernel on the current stream (``_build.launch``) and counts
the launch (:func:`launched`: one to its wrapper's ``launches`` count,
and an entry of the launch manifest that ``utils/profiling.py`` may be
recording); a fake one (``register_fake``), which gives the
outputs' shapes and dtypes only, so that ``torch.export`` records the op
as one node of a saved program (``serving.export_flow``); and for the
CPU, the kernel's plain PyTorch version, so that
``torch.library.opcheck`` can hold the fake function against a real one
where there is no card.

A wrapper takes its kernel's plain version inline when every input
tensor lies on the CPU, so a CPU export holds ATen ops only.  Otherwise
it checks the inputs (CUDA, one device, dtype, shape, contiguity) and
calls the op's CUDA function (:func:`dispatch`): through the op while
``torch.export`` traces, straight otherwise.  There is no path from a
CUDA tensor to the plain version.  Inside :func:`ops_on_cpu` (the cost count of
``serving.CompiledFlow.cost_analysis``) CPU inputs go through the op
too, so that each kernel shows as one call.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ...utils import profiling

_local = threading.local()


@contextlib.contextmanager
def ops_on_cpu():
    """Within this context the wrappers send CPU tensors through their ops
    (whose CPU function is the plain version, and whose fake function
    runs under a ``FakeTensorMode``), so that a dispatch mode sees each
    kernel call as one op."""
    outer = getattr(_local, "ops_on_cpu", False)
    _local.ops_on_cpu = True
    try:
        yield
    finally:
        _local.ops_on_cpu = outer


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper takes its plain version inline: every tensor on
    the CPU, outside :func:`ops_on_cpu`."""
    return (all(t.device.type == "cpu" for t in tensors)
            and not getattr(_local, "ops_on_cpu", False))


def check_input(t: torch.Tensor, name: str, device: torch.device,
                dtype: torch.dtype, shape, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on the CUDA
    device ``device`` (or on the CPU within :func:`ops_on_cpu`),
    contiguous unless ``contiguous`` is false (a kernel that reads
    strides)."""
    on_cpu_op = device.type == "cpu" and getattr(_local, "ops_on_cpu", False)
    if (t.device.type != "cuda" and not on_cpu_op) or t.device != device:
        raise ValueError(f"{name} is on {t.device}; the kernel takes tensors "
                         f"on one CUDA device ({device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launched(op: str, kernel: str, *wrappers) -> None:
    """Count one launch of ``kernel`` (a key of
    ``profiling.KERNEL_FUNCTIONS``) through the op ``op``: one to the
    ``launches`` of each of ``wrappers`` (the kernel's wrapper first, then
    a mode's), and an entry of the manifest recording on this thread."""
    for w in wrappers:
        w.launches += 1
    profiling.note_launch(op, kernel)


def dispatch(op, cuda_fn, device: torch.device, *args):
    """Call the registered ``op`` on checked inputs, or, for an eager call
    on CUDA tensors, its CUDA function ``cuda_fn`` straight: the same
    function either way.  A trace (``torch.export``) records the op; an
    eager call skips the dispatcher, which added 12-13% to the eager 1080p
    compat frame (``serving_cost.py``, PERF.md)."""
    if device.type == "cuda" and not torch.compiler.is_exporting():
        return cuda_fn(*args)
    return op(*args)


def register(name: str, cuda_fn, fake_fn, cpu_fn, mutates_args=()):
    """The op ``dis_tpu_torch::name`` with its CUDA, fake and CPU functions."""
    op = torch.library.custom_op(f"dis_tpu_torch::{name}", cuda_fn,
                                 mutates_args=mutates_args, device_types="cuda")
    op.register_fake(fake_fn)
    op.register_kernel("cpu", cpu_fn)
    return op


# The ops are registered when their modules are imported; importing this
# package registers all of them (a loaded artifact needs them).
from . import (extract_banded_kernel, extract_kernel, frame_kernel,  # noqa: E402,F401
               iclk_kernel, pyramid_kernel, refine_kernel, scale_kernel)
