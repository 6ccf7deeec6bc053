"""Tracing / profiling hooks; counterpart of ``dis_tpu/utils/profiling.py``.

The reference's only observability is ``cout`` progress lines
(main.cpp:110,205; optical_flow.cpp:69).  Here:

- :func:`stage`, the pipeline's stages (``models/dis.py``: ``pyramid``,
  ``scale_{s}``, ``refine_s{s}``, ``variational_refinement``,
  ``stripe_scale_{s}``, the names of the JAX package's
  ``jax.named_scope`` s): a ``record_function`` range while a profiler
  runs, and the innermost open stage while a launch manifest records.
- :func:`launch_manifest`, the launches of a call in launch order, each
  with its op, its kernel id (:data:`KERNEL_FUNCTIONS`) and the innermost
  stage and scale that launched it.  A CUDA graph replays without Python,
  so a profiler sees its kernels with no stage; ``serving.CompiledFlow``
  records the manifest of the call it captures (``graph_manifest``), and a
  replay's kernels, in device order, are that manifest's launches.
- :func:`request`, the stages of one ``CompiledFlow`` request
  (:data:`REQUEST_SPANS`): ranges while a profiler runs, and CUDA events
  and host stamps under :func:`recording`, whose :meth:`Recorder.summary`
  splits the recorded window's device time without a profiler.
- :func:`trace`, a profiler context, and :class:`PhaseTimer`, host phases
  for JSON-lines run logs.

Off (no profiler, no manifest, no recorder), each hook is one check of a
flag: a ``record_function`` costs about 10 us of host time even with no
profiler running, so none is opened then.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# The __global__ function each kernel id launches (csrc/), as a pattern
# that matches at the start of a trace's kernel name or after a space or
# colon: K2 and K1 with a pair axis (K2b, K1b) launch the same functions
# as without one, K2 on a plane smaller than a region (K2s) launches
# small_kernel; R1's setup and warp1 modes (R1s, R1w) launch warp_kernel
# and warp1_kernel, R3's no-sweep mode (R3n) an instance of sor_kernel,
# and R23 an overload of it, told apart by its arguments.
KERNEL_FUNCTIONS = {
    "K3": r"pyramid_kernel\b", "K2": r"extract_kernel\b", "K2b": r"extract_kernel\b",
    "K2s": r"small_kernel\b", "K2c": r"banded_kernel\b", "K1": r"iclk_kernel\b",
    "K1b": r"iclk_kernel\b", "S1": r"templates_kernel\b", "S3": r"weights_kernel<",
    "S4": r"densify_kernel\b", "R0": r"planes_kernel\b", "R1s": r"warp_kernel\b",
    "R1w": r"warp1_kernel\b", "R3n": r"sor_kernel\b",
    "R23": r"sor_kernel<\w+>\((?:\(anonymous namespace\)::)?UpdateArgs\b",
    "F1": r"pad_kernel\b", "F2": r"levels_kernel\b", "F3": r"finish_kernel\b"}

# A request's ranges: the whole request (its name ends with the request's
# number), then its copy-in (the two static inputs), the graph's replay
# and the copy-out (the clone of the output).
REQUEST = "dis.request"
REQUEST_SPANS = ("dis.copy_in", "dis.replay", "dis.copy_out")


class Launch(NamedTuple):
    """One kernel launch of a manifest."""

    op: str                  # the op it goes through (ops/cuda), e.g. "iclk_search"
    kernel: str              # the kernel id, a key of KERNEL_FUNCTIONS
    stage: Optional[str]     # the innermost open stage, None outside any
    scale: Optional[int]     # that stage's scale, None where it has none


class _State(threading.local):
    manifest: Optional[List[Launch]] = None     # while a manifest records
    stages: Tuple[Tuple[str, Optional[int]], ...] = ()   # open stages, innermost last
    recorder: Optional["Recorder"] = None


_state = _State()
_requests = itertools.count()


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Stage:
    __slots__ = ("name", "scale", "range")

    def __init__(self, name: str, scale: Optional[int]):
        self.name, self.scale, self.range = name, scale, None

    def __enter__(self):
        _state.stages += ((self.name, self.scale),)
        if _profiler_on():
            self.range = record_function(self.name).__enter__()

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        _state.stages = _state.stages[:-1]


_NO_STAGE = contextlib.nullcontext()


def stage(name: str, scale: Optional[int] = None):
    """A context for one stage of the pipeline, at ``scale`` where it has
    one: a ``record_function`` range named ``name`` while a profiler runs,
    the innermost stage of the launches a manifest notes while one
    records, and nothing otherwise."""
    if _profiler_on() or _state.manifest is not None:
        return _Stage(name, scale)
    return _NO_STAGE


@contextlib.contextmanager
def launch_manifest() -> Iterator[List[Launch]]:
    """Record, on this thread, every kernel launch that the kernels'
    wrappers count (``ops/cuda::launched``) into the list this yields, in
    launch order.  An inner manifest takes the launches made inside it."""
    outer = _state.manifest
    entries: List[Launch] = []
    _state.manifest = entries
    try:
        yield entries
    finally:
        _state.manifest = outer


def note_launch(op: str, kernel: str) -> None:
    """Add one launch of ``kernel`` through ``op`` to the manifest that is
    recording on this thread, if one is."""
    entries = _state.manifest
    if entries is not None:
        name, scale = _state.stages[-1] if _state.stages else (None, None)
        entries.append(Launch(op, kernel, name, scale))


# -- a request's stages -----------------------------------------------------------

class Recorder:
    """The CUDA events and host stamps of up to ``requests`` requests, made
    when the recorder is, and read by :meth:`summary`.  A request past the
    capacity is counted in ``dropped`` and not recorded.

    Each request records four events on its device's current stream, with
    a ``time.perf_counter_ns`` stamp beside each: before the copy-in, before
    the replay, after the replay and after the clone.  The graph's head
    (``CompiledFlow.graph_head``, an event captured as the graph's first
    node) is re-recorded by every replay, so its time is read when the
    next request starts, or by :meth:`summary`, if the replay has ended by
    then; else the request has no launch-wait reading.  ``numbers`` holds
    each recorded request's number, the one its ``dis.request <n>`` range
    carries under a profiler."""

    def __init__(self, requests: int, device=None):
        if requests < 1:
            raise ValueError(f"requests must be >= 1, got {requests}")
        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
            else torch.device("cpu"))
        self.device = dev
        self.capacity = requests
        self.events = None
        if dev.type == "cuda":
            # Each event is created on the card when first recorded: record
            # them all once now, so that a request only re-records its own.
            self.events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(4))
                           for _ in range(requests)]
            stream = torch.cuda.current_stream(dev)
            for evs in self.events:
                for e in evs:
                    e.record(stream)
            torch.cuda.synchronize(dev)
        self._stream = None
        self.host: List[List[int]] = []
        self.numbers: List[int] = []
        self.launch_wait: List[Optional[float]] = []
        self.dropped = 0
        self._pending: Optional[Tuple[int, torch.cuda.Event]] = None

    def _begin(self, number: int) -> Optional[int]:
        self._read_head()
        k = len(self.host)
        if k == self.capacity:
            self.dropped += 1
            return None
        self.host.append([0, 0, 0, 0])
        self.numbers.append(number)
        self.launch_wait.append(None)
        if self.events is not None:
            self._stream = torch.cuda.current_stream(self.device)
        return k

    def _mark(self, k: int, i: int) -> None:
        self.host[k][i] = time.perf_counter_ns()
        if self.events is not None:
            self.events[k][i].record(self._stream)

    def _end(self, k: int, head, failed: bool) -> None:
        if failed:                           # a request that raised is not kept
            del self.host[k], self.numbers[k], self.launch_wait[k]
            return
        self._mark(k, 3)
        if head is not None and self.events is not None:
            self._pending = (k, head)

    def _read_head(self) -> None:
        if self._pending is None:
            return
        k, head = self._pending
        self._pending = None
        if self.events[k][2].query():        # the replay has ended
            self.launch_wait[k] = self.events[k][1].elapsed_time(head)

    def summary(self) -> Dict:
        """Waits for the recorded requests, then :func:`summarize` their
        device times (ms from the first request's first event) and host
        stamps."""
        n = len(self.host)
        device = None
        if self.events is not None and n:
            self.events[n - 1][3].synchronize()
            self._read_head()
            first = self.events[0][0]
            device = [tuple(first.elapsed_time(e) for e in self.events[k]) for k in range(n)]
        return summarize(device, self.launch_wait[:n], self.host, self.dropped)


@contextlib.contextmanager
def recording(requests: int = 4096, device=None) -> Iterator[Recorder]:
    """Record the stages of every ``CompiledFlow`` request made on this
    thread inside the context (see :class:`Recorder`); ``device``
    defaults to the current CUDA device.  Off by default."""
    rec = Recorder(requests, device)
    outer = _state.recorder
    _state.recorder = rec
    try:
        yield rec
    finally:
        _state.recorder = outer


class _Request:
    """One request's ranges (while a profiler runs) and marks (under a
    recorder): ``with`` it, call :meth:`stage` with 0, 1 and 2 as the
    copy-in, the replay and the copy-out begin."""

    __slots__ = ("number", "recorder", "slot", "profiled", "ranges", "head")

    def __init__(self, recorder: Optional[Recorder], profiled: bool, head):
        self.number = next(_requests)
        self.recorder, self.profiled, self.head = recorder, profiled, head
        self.slot = None
        self.ranges: List = []

    def __enter__(self):
        if self.recorder is not None:
            self.slot = self.recorder._begin(self.number)
        if self.profiled:
            self.ranges.append(record_function(f"{REQUEST} {self.number}").__enter__())
        return self

    def stage(self, i: int) -> None:
        if len(self.ranges) > 1:
            self.ranges.pop().__exit__(None, None, None)
        if self.slot is not None:
            self.recorder._mark(self.slot, i)
        if self.profiled:
            self.ranges.append(record_function(REQUEST_SPANS[i]).__enter__())

    def __exit__(self, *exc):
        if self.slot is not None:
            self.recorder._end(self.slot, self.head, exc[0] is not None)
        while self.ranges:
            self.ranges.pop().__exit__(*exc)


def request(head=None) -> Optional[_Request]:
    """The stages of one request whose graph starts with the event
    ``head``, or None where neither a profiler runs nor a recorder
    records on this thread."""
    rec = _state.recorder
    profiled = _profiler_on()
    if rec is None and not profiled:
        return None
    return _Request(rec, profiled, head)


def summarize(device: Optional[Sequence[Sequence[float]]],
              launch_wait: Sequence[Optional[float]],
              host: Sequence[Sequence[int]], dropped: int = 0) -> Dict:
    """The recorded window's split.  ``device`` holds each request's four
    device times in ms (before the copy-in, before the replay, after the
    replay, after the clone; None where nothing was timed on a card),
    ``launch_wait`` each request's device ms from the replay call to the
    graph's head (None where not read), ``host`` its four
    ``perf_counter_ns`` stamps at the same points.

    Device ms are means a request: ``copy_in``, ``launch_wait`` (over the
    requests that have it), ``graph`` (the replay less its launch wait, or
    the whole replay where it has none), ``copy_out`` and ``gap`` (from a
    request's end to the next one's start).  ``idle_pct`` is the share of
    the window (first event to last) outside every request's copy-in,
    graph and copy-out: the union of those spans, so that overlapping
    requests count once.  Host us are means a request: ``copy_in``,
    ``replay`` (the call), ``copy_out`` and ``between`` (from a request's
    last stamp to the next one's first)."""
    n = len(host)
    out: Dict = {"requests": n, "dropped": dropped}
    if n == 0:
        return out

    def mean(xs):
        xs = [x for x in xs if x is not None]
        return statistics.fmean(xs) if xs else None

    hs = [[t / 1e3 for t in h] for h in host]
    out["host_us"] = {
        "copy_in": mean(h[1] - h[0] for h in hs), "replay": mean(h[2] - h[1] for h in hs),
        "copy_out": mean(h[3] - h[2] for h in hs),
        "between": mean(hs[k + 1][0] - hs[k][3] for k in range(n - 1))}
    if device is None:
        return out
    waits = [None if w is None else min(max(w, 0.0), d[2] - d[1])
             for w, d in zip(launch_wait, device)]
    busy = []
    for d, w in zip(device, waits):
        busy += [(d[0], d[1]), (d[1] + (w or 0.0), d[2]), (d[2], d[3])]
    window = max(d[3] for d in device) - min(d[0] for d in device)
    out["window_ms"] = window
    out["device_ms"] = {
        "copy_in": mean(d[1] - d[0] for d in device), "launch_wait": mean(waits),
        "graph": mean(d[2] - d[1] - (w or 0.0) for d, w in zip(device, waits)),
        "copy_out": mean(d[3] - d[2] for d in device),
        "gap": mean(max(device[k + 1][0] - device[k][3], 0.0) for k in range(n - 1))}
    out["idle_pct"] = (100.0 * (1.0 - _union(busy) / window)) if window > 0 else None
    return out


def _union(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


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
