"""Capture and summarize a device-time budget of one flow frame;
counterpart of ``tools/trace_budget.py``.

``capture`` traces a few frames with ``torch.profiler`` (CPU and CUDA
activities) twice: the frame replayed from the CUDA graph of
``serving.aot_compile``, and the same frame run eagerly (``dis_flow``)
after a warm-up.  A graph replay runs no Python, so only the eager
trace carries the ``record_function`` scopes of ``models/dis.py``
(``pyramid``, ``scale_{s}``, ``refine_s{s}``, ``variational_refinement``,
``stripe_scale_{s}``); it launches the same kernels.  The bucket's graph
is captured while the profiler runs, so that the tracer sees its
kernels, and the frames are timed inside a window of their own
(``WINDOW``), outside which nothing is counted.  On the CPU there is no
graph: the one trace is the eager frame, and its ops are the CPU's.

Each frame runs inside a range of its own (``FRAME``).  ``summarize``
reads a Chrome trace and prints three views, per frame:

1. device ms for each kernel, copy and fill name, largest first, the
   port's kernels with their ids (``PORT_KERNELS``: K1-K3, R0, R1, R23,
   R3, S1, S3, S4, F1-F3), torch's with the op that launched them;
2. the same grouped by the innermost pipeline scope that launched it
   (kernels of a replay have none: ``(no scope)``);
3. the device's time a frame: busy (the union of kernel, copy and fill
   spans); device ms, the sum of each launch's span (a graph replay is
   one launch, so this adds the idle time between the graph's kernels:
   what CUDA events around a replayed frame read, less the host's
   launches); the frame's span, which adds the waits for the host
   between launches (longer under the profiler); and the busy share of
   the window.

On a trace without device events (a CPU run) the ops are the CPU's
``aten`` ops, each counted by its self time, so that nested ops are
counted once; device ms is then the busy time and a frame's span its
range.

Usage:
    python -m dis_tpu_torch.tools.trace_budget                      # 1080p compat bench config
    python -m dis_tpu_torch.tools.trace_budget --preset medium --top 30
    python -m dis_tpu_torch.tools.trace_budget --size 375x1242 --batch 8
    python -m dis_tpu_torch.tools.trace_budget --trace DIR/replay.json
    python -m dis_tpu_torch.tools.trace_budget --size 64x96 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import PRESETS, DISConfig
from ..models.dis import dis_flow
from ..serving import _device, aot_compile
from ..utils import synth

WINDOW = "trace_budget.frames"
FRAME = "trace_budget.frame"
# The pipeline's record_function scopes (models/dis.py).
SCOPES = re.compile(r"^(pyramid|scale_\d+|refine_s\d+|variational_refinement|stripe_scale_\d+)$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SCOPE = "(no scope)"
# The port's kernels (csrc/) by their function names in a trace, with
# their ids (K2 and K1 with a pair axis launch the same functions, R1's
# setup and warp1 modes count as R1, R3's no-sweep mode is R3, and R23 is
# an overload of R3's function, told apart by its arguments); every other
# kernel is torch's: the glue, copies and fills.
PORT_KERNELS = tuple((re.compile(r"(?:^|[\s:])" + pattern), kid) for pattern, kid in (
    (r"pyramid_kernel\b", "K3"), (r"extract_kernel\b", "K2"), (r"banded_kernel\b", "K2c"),
    (r"iclk_kernel\b", "K1"), (r"planes_kernel\b", "R0"), (r"warp_kernel\b", "R1"),
    (r"warp1_kernel\b", "R1"),
    (r"sor_kernel<\w+>\((?:\(anonymous namespace\)::)?UpdateArgs\b", "R23"),
    (r"sor_kernel\b", "R3"), (r"templates_kernel\b", "S1"),
    (r"weights_kernel<", "S3"), (r"densify_kernel\b", "S4"), (r"pad_kernel\b", "F1"),
    (r"levels_kernel\b", "F2"), (r"finish_kernel\b", "F3")))

# The compat bench config of bench.py: iterations 16, patch 8, stride 5,
# scales 3..0, no early exit.
BENCH_CFG = DISConfig(iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
                      patch_overlap=0.3, patch_normalization=True, mode="compat",
                      early_exit=False)


def frame_inputs(height: int, width: int, batch: Optional[int] = None,
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``synth.translation`` pair [H, W] (a (2, 1) px shift), or
    ``batch`` of them [B, H, W] (seeds 0 to B - 1), on ``device``."""
    dev = _device(device, "trace_budget")
    pairs = [synth.translation(height, width, seed=i)[:2] for i in range(batch or 1)]
    out = tuple(np.stack([p[j] for p in pairs]) if batch else pairs[0][j] for j in (0, 1))
    return tuple(torch.from_numpy(x).to(dev) for x in out)


def _profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _window(run, frames: int, dev: torch.device) -> None:
    with torch.profiler.record_function(WINDOW):
        for _ in range(frames):
            with torch.profiler.record_function(FRAME):
                run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def capture(cfg: DISConfig, height: int, width: int, out_dir: str, frames: int = 3,
            batch: Optional[int] = None, device="cuda", inputs=None) -> Dict[str, str]:
    """Trace ``frames`` frames of ``cfg`` on [(batch,) height, width]
    inputs (``frame_inputs`` unless ``inputs`` is given) into
    ``out_dir``.  Returns {"replay": path, "eager": path} on a card,
    {"eager": path} on the CPU (Chrome traces)."""
    dev = _device(device, "trace_budget")
    a, b = inputs if inputs is not None else frame_inputs(height, width, batch, dev)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    if dev.type == "cuda":
        with _profile() as prof:
            served = aot_compile(cfg, height, width, batch=batch, device=dev)
            _window(lambda: served(a, b), frames, dev)
        paths["replay"] = os.path.join(out_dir, "replay.json")
        prof.export_chrome_trace(paths["replay"])
        del served
    dis_flow(a, b, cfg)      # build the kernels and plans outside the window
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with _profile() as prof:
        _window(lambda: dis_flow(a, b, cfg), frames, dev)
    paths["eager"] = os.path.join(out_dir, "eager.json")
    prof.export_chrome_trace(paths["eager"])
    return paths


def _spans_union(spans: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_busy_ms(trace: dict) -> float:
    """Milliseconds in which the card ran a kernel, a copy or a fill, from
    a ``torch.profiler`` Chrome trace (the union of those events' spans)."""
    return _spans_union([(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                         if e.get("cat") in DEVICE_CATS and "dur" in e]) / 1e3


def _enclosing(intervals, points, default: str) -> List[str]:
    """For each (tid, ts) of ``points``, the name of the innermost of
    ``intervals`` [(tid, start, end, name)] on that thread open at ts, or
    ``default``: one sweep a thread.  A thread's intervals nest, as its
    ops and ``record_function`` ranges do."""
    out = [default] * len(points)
    by_tid = collections.defaultdict(lambda: ([], []))
    for iv in intervals:
        by_tid[iv[0]][0].append(iv)
    for i, (tid, ts) in enumerate(points):
        by_tid[tid][1].append((ts, i))
    for ivs, pts in by_tid.values():
        ivs.sort(key=lambda iv: (iv[1], -iv[2]))
        stack, k = [], 0           # the open intervals, nested: innermost last
        for ts, i in sorted(pts):
            while k < len(ivs) and ivs[k][1] <= ts:
                while stack and stack[-1][2] <= ivs[k][1]:
                    stack.pop()
                stack.append(ivs[k])
                k += 1
            while stack and stack[-1][2] <= ts:
                stack.pop()
            if stack:
                out[i] = stack[-1][3]
    return out


def _self_times(ops):
    """Each CPU op's duration less its children's on the same thread."""
    out = []
    by_tid = collections.defaultdict(list)
    for e in ops:
        by_tid[e["tid"]].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []     # [event, self time]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
                out.append(tuple(stack.pop()))
            if stack:
                stack[-1][1] -= e["dur"]
            stack.append([e, e["dur"]])
        out.extend(tuple(s) for s in stack)
    return out


def budget(trace: dict) -> dict:
    """The budget of the frames in ``trace`` (a Chrome trace dict), per
    frame: {"events": "device" or "cpu", "frames", "ops": {name: ms},
    "scopes": {scope: ms}, "port_kernels": {id: ms}, "port_ms", "total_ms",
    "busy_ms", "device_ms", "span_ms", "window_ms", "busy_share",
    "kernels"}: ``port_kernels`` the ops of the port's kernels by id, and
    ``port_ms`` their sum.

    Ops and scopes are largest first and both sum to ``total_ms``.  Of a
    frame on the device: ``busy_ms`` is the union of its events' spans;
    ``device_ms`` the sum over its launches (a graph replay is one) of
    each launch's span, its first event's start to its last one's end,
    which adds the idle time between a graph's kernels to the busy time;
    ``span_ms`` its first event's start to its last one's end, which
    also holds the waits for the host between launches (longer under the
    profiler).  ``busy_share`` is busy over the window; ``kernels``:
    kernel events a frame.  On the CPU, ``device_ms`` is the busy time
    and the span is the frame's range."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    ranges = lambda name: sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                                 if e.get("cat") == "user_annotation" and e["name"] == name)
    wins, frame_ranges = ranges(WINDOW), ranges(FRAME)
    if not wins or not frame_ranges:
        raise ValueError(f"no {WINDOW!r} and {FRAME!r} ranges in the trace")
    w0, w1 = wins[0][0], wins[-1][1]
    frames = len(frame_ranges)
    frame_of = lambda ts: next((f for f, (a, b) in enumerate(frame_ranges) if a <= ts < b), None)
    inside = [e for e in ev if w0 <= e["ts"] < w1]
    scopes = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
              if e.get("cat") == "user_annotation" and SCOPES.match(e["name"])]
    # A device event belongs to the window by its launch, the runtime call
    # of the same correlation id on the host's clock: the device's
    # timestamps may drift from the host's over a long process.
    launch = {e["args"]["correlation"]: e for e in inside
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    dev_ev = [e for e in ev if e.get("cat") in DEVICE_CATS
              and (e.get("args", {}).get("correlation") in launch
                   or ("correlation" not in e.get("args", {}) and w0 <= e["ts"] < w1))]
    ops, by_scope = collections.Counter(), collections.Counter()
    # Spans by frame and launch (a CPU op is its own launch).
    launches = collections.defaultdict(list)
    if dev_ev:
        hosts = [launch.get(e.get("args", {}).get("correlation")) for e in dev_ev]
        points = [(-1, 0.0) if h is None else (h["tid"], h["ts"]) for h in hosts]
        cpu_ops = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
                   if e.get("cat") == "cpu_op"]
        op_of = collections.defaultdict(collections.Counter)
        for e, host, scope, op in zip(dev_ev, hosts, _enclosing(scopes, points, NO_SCOPE),
                                      _enclosing(cpu_ops, points, "")):
            ops[e["name"]] += e["dur"]
            by_scope[scope] += e["dur"]
            if op:
                op_of[e["name"]][op] += e["dur"]
            f = None if host is None else frame_of(host["ts"])
            if f is not None:
                launches[f, host["args"]["correlation"]].append((e["ts"], e["ts"] + e["dur"]))
    else:
        op_of = {}
        cpu = _self_times([e for e in inside if e.get("cat") == "cpu_op"])
        for (e, self_us), scope in zip(cpu, _enclosing(scopes, [(e["tid"], e["ts"])
                                                              for e, _ in cpu], NO_SCOPE)):
            ops[e["name"]] += self_us
            by_scope[scope] += self_us
            f = frame_of(e["ts"])
            if f is not None:
                launches[f, id(e)].append((e["ts"], e["ts"] + e["dur"]))
    per_frame = [[] for _ in frame_ranges]
    launched = [0.0] * frames
    for (f, _), sp in launches.items():
        per_frame[f] += sp
        launched[f] += max(b for _, b in sp) - min(a for a, _ in sp)
    busy = [_spans_union(sp) for sp in per_frame]
    if dev_ev:
        spans = [max(b for _, b in sp) - min(a for a, _ in sp) if sp else 0.0
                 for sp in per_frame]
    else:
        launched = busy
        spans = [b - a for a, b in frame_ranges]
    mean = lambda xs: sum(xs) / 1e3 / frames
    per = lambda c: {k: v / 1e3 / frames for k, v in c.most_common()}
    window = (w1 - w0) / 1e3 / frames
    by_kernel = collections.Counter()
    for k, v in ops.items():
        if kernel_id(k):
            by_kernel[kernel_id(k)] += v
    return {"events": "device" if dev_ev else "cpu", "frames": frames, "ops": per(ops),
            "port_kernels": per(by_kernel), "port_ms": sum(by_kernel.values()) / 1e3 / frames,
            "scopes": per(by_scope), "total_ms": sum(ops.values()) / 1e3 / frames,
            "busy_ms": mean(busy), "device_ms": mean(launched), "span_ms": mean(spans),
            "window_ms": window, "busy_share": mean(busy) / window,
            "kernels": sum(e.get("cat") == "kernel" for e in dev_ev) / frames,
            "launched_by": {k: c.most_common(1)[0][0] for k, c in op_of.items()}}


def kernel_id(name: str) -> Optional[str]:
    """The id of the port's kernel that a trace names ``name`` (K1-K3, R0,
    R1, R23, R3, S1, S3, S4, F1-F3), or None for torch's."""
    return next((kid for pattern, kid in PORT_KERNELS if pattern.search(name)), None)


def _short(kernel: str) -> str:
    """A kernel's name without the namespaces and qualifiers that every
    PyTorch kernel's name repeats."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        kernel = kernel.replace(noise, "")
    return kernel


def summarize(trace_path: str, top: int = 20) -> dict:
    """Print the three views of :func:`budget` for the trace at
    ``trace_path`` and return the budget."""
    with open(trace_path) as f:
        got = budget(json.load(f))
    what = "device" if got["events"] == "device" else "CPU op (self time)"
    print(f"{trace_path}: {what} total {got['total_ms']:.4f} ms/frame "
          f"({len(got['ops'])} distinct names, {got['frames']} frames)")
    for k, v in list(got["ops"].items())[:top]:
        by = kernel_id(k) or got["launched_by"].get(k)
        print(f"{v:9.4f} ms  " + (f"[{by}] " if by else "") + _short(k)[:100])
    print("--- by pipeline scope")
    for k, v in got["scopes"].items():
        print(f"{v:9.4f} ms  {k}")
    if got["events"] == "cpu":
        print(f"--- a frame: ops busy {got['busy_ms']:.4f} ms of its {got['span_ms']:.4f} ms")
        return got
    print(f"--- a frame: busy {got['busy_ms']:.4f} ms; device {got['device_ms']:.4f} ms "
          f"(its launches' spans: {got['device_ms'] - got['busy_ms']:.4f} ms idle between a "
          f"graph's kernels); span {got['span_ms']:.4f} ms (waits for the host "
          f"{got['span_ms'] - got['device_ms']:.4f} ms); {100 * got['busy_share']:.1f}% busy "
          f"over a {got['window_ms']:.4f} ms window")
    return got


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="summarize this Chrome trace (skip capture)")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="a preset instead of the compat bench config")
    ap.add_argument("--size", default="1080x1920", metavar="HxW")
    ap.add_argument("--batch", type=int, default=None,
                    help="trace a batch of B pairs [B, H, W] (ms per batch)")
    ap.add_argument("--frames", type=int, default=3, help="frames a trace")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default="trace_budget_out",
                    help="directory the traces are written to")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)
    if args.trace:
        summarize(args.trace, args.top)
        return 0
    h, w = (int(v) for v in args.size.split("x"))
    cfg = PRESETS[args.preset] if args.preset else BENCH_CFG
    for path in capture(cfg, h, w, args.out, args.frames, args.batch, args.device).values():
        summarize(path, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
