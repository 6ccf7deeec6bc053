"""A replayed graph's kernels against the program's launch manifest, and a
recorded window of requests, read without a profiler.

    python3 -m flowbench.replays --workload <cell> --seed <n> --seconds <s>

A replay runs no Python, so a ``torch.profiler`` trace gives each of its
kernels a name and the ``cudaGraphLaunch``'s correlation id, and no
stage.  The program records, when it captures the graph, the launches of
the captured call in launch order (``CompiledFlow.graph_manifest``: each
launch's op, kernel id, stage and scale; ``dis_tpu_torch/utils/
profiling.py``).  :func:`match` walks each replay's kernels in device
order against that manifest: the layer of a kernel comes from its name
(``flowbench/layers/*.json``, as in ``trace.py``), its scale from the
manifest.  torch's own copies and fills are skipped; any other kernel
that is not the manifest's next launch raises.

Under ``profiling.recording()`` the program records CUDA events and host
stamps around each request's copy-in, replay and copy-out, and the
graph's first node (``graph_head``); ``Recorder.summary()`` splits the
window's device time with no profiler attached, whose CUPTI cost per
kernel the traced idle share carries.

The readers ``metrics/search_coarse_device_ms.py``,
``refine_coarse_device_ms.py``, ``idle_untraced_pct.py`` and
``launch_wait_ms.py`` read :func:`match`'s result as ``ctx.replays`` and
the recorder's summary as ``ctx.recorded``, which ``run.py`` does not set
yet (each reads nothing then).  :func:`measure` runs a cell's set-up, an
untraced window, a recorded window and a profiled window in one process,
and gives the readers' values beside the figures they are checked
against; :func:`main` prints them as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace as tr

# The manifest's kernel ids (dis_tpu_torch/utils/profiling.py) by the
# kernel ids of flowbench/layers: the pair axis (K2b, K1b) and R1's and
# R3's modes launch the same functions; K2 on a plane smaller than a
# region launches small_kernel.
KERNEL_IDS = {"K3": "K3", "K2": "K2", "K2b": "K2", "K2s": "K2_small", "K2c": "K2c",
              "K1": "K1", "K1b": "K1", "S1": "S1", "S3": "S3", "S4": "S4", "R0": "R0",
              "R1": "R1", "R1s": "R1", "R1w": "R1w", "R2": "R2", "R3": "R3", "R3c": "R3",
              "R3n": "R3", "F1": "F1", "F2": "F2", "F3": "F3"}
# torch's own device work, which no manifest lists.
TORCH_IDS = ("copy", "fill", "torch_fill", "torch_copy")
GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class Replays:
    """The program's kernels of every replay in a window, matched to the
    manifest."""

    replays: int
    kernels: int                                    # program kernels matched
    layer_scale_s: Dict[Tuple[str, Optional[int]], float]   # device s by (layer, scale)

    def layer_ms_per_pair(self, layer: str, pairs: int, coarser_than: int) -> Optional[float]:
        """Device ms a pair of ``layer`` at scales above ``coarser_than``,
        or None where the layer ran nothing there."""
        s = sum(v for (lay, scale), v in self.layer_scale_s.items()
                if lay == layer and scale is not None and scale > coarser_than)
        return s / pairs * 1e3 if s > 0 and pairs else None


def match(trace: dict, window: str, patterns, manifest: Sequence) -> Replays:
    """Each replay (a ``cudaGraphLaunch`` inside the ``record_function``
    range ``window``) of a Chrome trace, its program kernels in device
    order one for one against ``manifest`` (a sequence of launches with
    ``kernel`` and ``scale``, ``CompiledFlow.graph_manifest``).  Raises
    ValueError where a replay's program kernels differ from the manifest
    in number or in kernel id, or where a kernel is neither the
    program's nor torch's."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in ev if e.get("cat") == "user_annotation" and e["name"] == window]
    if not wins:
        raise ValueError(f"no {window!r} range in the trace")
    w0 = min(e["ts"] for e in wins)
    w1 = max(e["ts"] + e["dur"] for e in wins)
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in ev
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e["name"] == GRAPH_LAUNCH and w0 <= e["ts"] < w1
                      and "correlation" in e.get("args", {}))
    by_launch = collections.defaultdict(list)
    ids = {c for _, c in launches}
    for e in ev:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in tr.DEVICE_CATS and c in ids:
            by_launch[c].append(e)
    want = [KERNEL_IDS[m.kernel] for m in manifest]
    layer_scale_s: Dict[Tuple[str, Optional[int]], float] = collections.Counter()
    kernels = 0
    for i, (_, c) in enumerate(launches):
        program = []
        for e in sorted(by_launch[c], key=lambda e: e["ts"]):
            layer, kid = tr.attribute(e["name"], patterns)
            if layer == tr.UNATTRIBUTED:
                raise ValueError(f"replay {i}: kernel {e['name']!r} is neither the "
                                 "program's nor torch's")
            if kid not in TORCH_IDS:
                program.append((layer, kid, e["dur"]))
        if len(program) != len(want):
            raise ValueError(f"replay {i}: {len(program)} program kernels, the manifest "
                             f"lists {len(want)}")
        for j, ((layer, kid, dur), m) in enumerate(zip(program, manifest)):
            if kid != want[j]:
                raise ValueError(f"replay {i}, launch {j}: kernel {kid}, the manifest "
                                 f"lists {m.kernel} ({want[j]})")
            layer_scale_s[(layer, m.scale)] += dur / 1e6
        kernels += len(program)
    return Replays(replays=len(launches), kernels=kernels, layer_scale_s=dict(layer_scale_s))


def _closed_loop(call, reqs, timer, seconds: float, passes: Optional[int] = None):
    """Requests in a closed loop, each waited for, for ``seconds`` or for
    ``passes`` whole passes over ``reqs``; returns (requests, seconds)."""
    n = 0
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        while True:
            timer.start()
            call(*reqs[n % len(reqs)])
            timer.stop_ms()
            n += 1
            if passes is not None:
                if n == passes * len(reqs):
                    break
            elif time.perf_counter() - t0 >= seconds:
                break
    finally:
        gc.enable()
    return n, time.perf_counter() - t0


def head_cost(entry, reps: int = 200, rounds: int = 3) -> Dict[str, float]:
    """Device ms a replay of ``entry``'s graph, whose first node is its
    head event, and of the same call captured without one: ``reps``
    replays back to back between two events, in turns, median of
    ``rounds``."""
    import statistics

    import torch

    bare = torch.cuda.CUDAGraph()
    with torch.cuda.graph(bare):
        entry._run(*entry.static_in)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms = {"with_head": [], "without_head": []}
    for _ in range(rounds):
        for key, graph in (("with_head", entry.graph), ("without_head", bare)):
            torch.cuda.synchronize(entry.device)
            start.record()
            for _ in range(reps):
                graph.replay()
            end.record()
            end.synchronize()
            ms[key].append(start.elapsed_time(end) / reps)
    return {k: statistics.median(v) for k, v in ms.items()}


def measure(name: str, seed: int, seconds: float, device, size=None) -> Dict:
    """One process: the cell's set-up as ``run.py`` makes it, an untraced
    window and a recorded window of ``seconds`` each, and a profiled
    window of whole passes over the pool (``run.TRACE_SECONDS``); the
    per-layer readers on what the windows gave."""
    import torch

    from dis_tpu_torch import DISConfig, serving
    from dis_tpu_torch.utils import profiling

    from . import run
    from .reference import dis as reference
    from .traffic.pool import make_pool

    spec = run.load_cell(name)
    config, mix = spec["config"], spec["mix"]
    height, width = size or (config["height"], config["width"])
    dev = torch.device(device)
    cfg = DISConfig(**config["dis"])
    prm = reference.Params.from_fields(config["dis"])
    batch = mix["batch"]
    pool = make_pool(mix["pairs"], seed, height, width, dev)
    if batch == 1:
        reqs = [(pool.img1[i], pool.img2[i]) for i in range(len(pool))]
    else:
        reqs = [(pool.img1[i:i + batch], pool.img2[i:i + batch])
                for i in range(0, len(pool), batch)]
    entry = serving.aot_compile(cfg, height, width, batch if batch > 1 else None, device=dev)
    timer = run._Timer(dev)
    _closed_loop(entry, reqs, timer, 0.0, passes=1)
    n, window_s = _closed_loop(entry, reqs, timer, seconds)
    capacity = int(n * 1.5) + len(reqs)
    with profiling.recording(capacity, dev) as rec:
        n_rec, rec_s = _closed_loop(entry, reqs, timer, seconds)
    recorded = rec.summary()
    passes = max(1, round(run.TRACE_SECONDS * n / max(window_s, 1e-9) / len(reqs)))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(run.WINDOW):
            for i in range(passes * len(reqs)):
                with torch.profiler.record_function("flowbench.request"):
                    entry(*reqs[i % len(reqs)])
                with torch.profiler.record_function("flowbench.wait"):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
    patterns = tr.layer_patterns()
    f = 2 ** prm.coarsest_scale
    ctx = run.Context(prm, -(-height // f) * f, -(-width // f) * f, n, 0.0)
    ctx.window = tr.read_window(chrome, run.WINDOW, patterns)
    ctx.pairs_traced = passes * len(reqs) * batch
    ctx.replays = match(chrome, run.WINDOW, patterns, entry.graph_manifest)
    ctx.recorded = recorded
    del chrome, prof
    readers = ("search_device_ms", "refine_device_ms", "frame_device_ms", "device_idle_pct",
               "search_coarse_device_ms", "refine_coarse_device_ms", "idle_untraced_pct",
               "launch_wait_ms")
    metrics = {m: run._metric_reader(m)(ctx) for m in readers}
    pairs_per_s = n * batch / window_s
    device_ms_pair = sum(ctx.window.layer_s.values()) / ctx.pairs_traced * 1e3
    by_scale = collections.defaultdict(dict)
    for (layer, scale), s in sorted(ctx.replays.layer_scale_s.items(),
                                    key=lambda kv: (kv[0][0], -1 if kv[0][1] is None
                                                    else kv[0][1])):
        by_scale[layer][str(scale)] = s / ctx.pairs_traced * 1e3
    layer_ms = {k: v / ctx.pairs_traced * 1e3 for k, v in ctx.window.layer_s.items()}
    graph_ms = head_cost(entry) if dev.type == "cuda" else None
    return {
        "workload": name, "seed": seed, "device": (torch.cuda.get_device_name(dev)
                                                   if dev.type == "cuda" else "cpu"),
        "card": run._power_limit() if dev.type == "cuda" else None,
        "pairs_per_s": pairs_per_s, "pairs_per_s_recorded": n_rec * batch / rec_s,
        "requests": n, "requests_recorded": n_rec,
        "recorded": recorded, "metrics": metrics,
        "device_ms_a_pair": device_ms_pair,
        "idle_from_rate_pct": 100.0 * (1.0 - pairs_per_s * device_ms_pair / 1e3),
        "layer_ms_a_pair": layer_ms, "layer_scale_ms_a_pair": by_scale,
        "replays": ctx.replays.replays, "kernels_matched": ctx.replays.kernels,
        "manifest_launches": len(entry.graph_manifest),
        "idle_gaps": ctx.window.idle_gaps, "replay_ms": graph_ms,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="flowbench.replays", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("flowbench.replays: needs a CUDA card: no result", file=sys.stderr)
        return 1
    print(json.dumps(measure(args.workload, args.seed, args.seconds, torch.device("cuda", 0))),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
