"""Tracing / profiling hooks; counterpart of ``dis_tpu/utils/profiling.py``.

The reference's only observability is ``cout`` progress lines
(main.cpp:110,205; optical_flow.cpp:69).  Here: named ranges per
pipeline stage (``torch.profiler.record_function`` in
``models/dis.py``: ``pyramid``, ``scale_{s}``, ``refine_s{s}``,
``variational_refinement``, ``stripe_scale_{s}``, the names of the JAX
package's ``jax.named_scope`` s), a trace context, and a phase timer for
JSON-lines run logs.

A range costs about a microsecond of host time when no profiler runs,
so they mark stages, never single ops.  A CUDA graph replays without
them: a trace names the stages of eager runs only (the CLI runs eagerly
under ``--profile-dir``).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile CPU and (where there is a card) CUDA activity; on exit the
    trace is written into ``log_dir`` as a Chrome trace
    (``*.pt.trace.json``, viewable in Perfetto, chrome://tracing or
    TensorBoard's profiler plugin)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class PhaseTimer:
    """Wall-clock phase timing with JSON-lines output.

    With a CUDA ``device``, each phase ends with a
    ``torch.cuda.synchronize`` of it, so the device work a phase queued
    counts in its own seconds and in no later phase's.
    """

    def __init__(self, log_path: Optional[str] = None, device=None):
        self.log_path = log_path
        self.records: list = []
        dev = None if device is None else torch.device(device)
        self._sync = dev if dev is not None and dev.type == "cuda" else None

    @contextlib.contextmanager
    def phase(self, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            dt = time.perf_counter() - t0
            rec = {"phase": name, "seconds": dt, **meta}
            self.records.append(rec)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out
