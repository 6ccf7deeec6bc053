"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The span arithmetic and the search for the host activity enclosing a
point are copies of the program's ``tools/trace_budget.py``
(``_spans_union``, ``_enclosing``), which the benchmark does not import.

Device events (kernels, copies, fills) belong to the window by their
launch: the runtime call of the same correlation id inside the window's
range on the host.  A graph replay's kernels all carry its
``cudaGraphLaunch``'s id.  Each device event is attributed to a layer by
the kernel-name patterns of ``flowbench/layers/*.json``: a layer is the
union of every file that names it, so a later kernel adds a file.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAYERS_DIR = Path(__file__).resolve().parent / "layers"
UNATTRIBUTED = "unattributed"


def spans_union(spans: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def enclosing(intervals, points, default: str) -> List[str]:
    """For each (tid, ts) of ``points``, the name of the innermost of
    ``intervals`` [(tid, start, end, name)] on that thread open at ts, or
    ``default``: one sweep a thread.  A thread's intervals nest."""
    out = [default] * len(points)
    by_tid = collections.defaultdict(lambda: ([], []))
    for iv in intervals:
        by_tid[iv[0]][0].append(iv)
    for i, (tid, ts) in enumerate(points):
        by_tid[tid][1].append((ts, i))
    for ivs, pts in by_tid.values():
        ivs.sort(key=lambda iv: (iv[1], -iv[2]))
        stack, k = [], 0
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


def layer_patterns(layers_dir: Path = LAYERS_DIR) -> List[Tuple[re.Pattern, str, str]]:
    """(compiled pattern, kernel id, layer) of every layer file.  A
    pattern matches at the start of a name or after a space or colon."""
    out = []
    for path in sorted(layers_dir.glob("*.json")):
        spec = json.loads(path.read_text())
        for kid, pattern in spec["kernels"].items():
            out.append((re.compile(r"(?:^|[\s:])" + pattern), kid, spec["layer"]))
    return out


def attribute(name: str, patterns) -> Tuple[str, str]:
    """(layer, kernel id) of a device event's name, or
    (``UNATTRIBUTED``, name)."""
    for pattern, kid, layer in patterns:
        if pattern.search(name):
            return layer, kid
    return UNATTRIBUTED, name


def _short(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:120]


@dataclasses.dataclass
class Window:
    """What the device did in the traced window."""

    window_s: float                 # the window's length on the host's clock
    busy_s: float                   # the union of its device events' spans
    layer_s: Dict[str, float]       # device seconds by layer (unattributed too)
    kernel_s: Dict[str, float]      # device seconds by kernel id or name
    device_ops: List[List]          # [[name, seconds]], largest first
    idle_gaps: List[List]           # [[host activity, seconds]], largest first
    events: int


def read_window(trace: dict, window: str, patterns, top: int = 10) -> Window:
    """The window named ``window`` (a ``record_function`` range) of a
    Chrome trace."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in ev if e.get("cat") == "user_annotation" and e["name"] == window]
    if not wins:
        raise ValueError(f"no {window!r} range in the trace")
    w0 = min(e["ts"] for e in wins)
    w1 = max(e["ts"] + e["dur"] for e in wins)
    host_tid = wins[0]["tid"]
    inside = [e for e in ev if w0 <= e["ts"] < w1]
    launch = {e["args"]["correlation"] for e in inside
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS
           and e.get("args", {}).get("correlation") in launch]
    layer_s, kernel_s, ops = (collections.Counter() for _ in range(3))
    for e in dev:
        layer, kid = attribute(e["name"], patterns)
        layer_s[layer] += e["dur"] / 1e6
        kernel_s[kid if layer != UNATTRIBUTED else _short(kid)] += e["dur"] / 1e6
        ops[(kid + " " if layer != UNATTRIBUTED else "") + _short(e["name"])] += e["dur"] / 1e6
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, end = [], w0
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    host = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
            if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
            and e["tid"] == host_tid and e["name"] != window]
    by_activity = collections.Counter()
    for (a, b), name in zip(gaps, enclosing(host, [(host_tid, (a + b) / 2) for a, b in gaps],
                                           "(host outside any span)")):
        by_activity[name] += (b - a) / 1e6
    return Window(window_s=(w1 - w0) / 1e6, busy_s=spans_union(spans) / 1e6,
                  layer_s=dict(layer_s), kernel_s=dict(kernel_s),
                  device_ops=[[k, v] for k, v in ops.most_common(top)],
                  idle_gaps=[[k, v] for k, v in by_activity.most_common(top)],
                  events=len(dev))
