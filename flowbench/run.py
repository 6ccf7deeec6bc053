"""The benchmark of dis_tpu_torch, one cell a run.

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration
(``flowbench/configs/<config>.json``: a DIS preset and a frame size) and a
traffic mix (``flowbench/mixes/<traffic>.json``: the pairs a call and the
pool's entries).  A run:

1. Set-up: imports, the card, the kernel library (built into the
   program's ``_build/`` on a checkout's first run), the pool of distinct
   pairs made on the card from the seed, and the entry warmed on the
   cell's one shape: ``serving.aot_compile`` (plans, two warm-up calls, the
   graph's capture).  ``setup_s`` is the time from the process's start to
   the first timed request.
2. The window: one client in a closed loop for ``--seconds``, each request
   the next pair (or batch) of the pool, issued once the previous flow is
   ready.  A request's latency is read from the device's clock by CUDA
   events recorded around it: from its issue to its flow being ready.
   With ``--trace 1`` a short profiled window follows, whole passes over
   the pool, which the per-layer readers (``flowbench/metrics``) read.
3. The check: flows of requests sampled from the seed over the window,
   against the plain reference (``flowbench/reference``) on the same
   pairs, after the program's state is freed (``flowbench/compare.py``).

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the last key of that object.  Without a CUDA card, or with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded,
the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


def _process_start() -> float:
    """The process's start on ``time.clock_gettime(CLOCK_BOOTTIME)``'s scale."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.clock_gettime(time.CLOCK_BOOTTIME)


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dis_tpu")
WINDOW = "flowbench.window"
TRACE_SECONDS = 0.5


def forbidden_modules(names) -> List[str]:
    """The top-level names among ``names`` (module names) that are JAX's or
    the JAX package's, compared whole: ``dis_tpu_torch`` is not ``dis_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_cell(name: str) -> Dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files read: {"cell", "config", "mix", "manifest"}."""
    manifest = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    config = json.loads((ROOT / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((ROOT / "mixes" / f"{cell['traffic']}.json").read_text())
    return {"cell": cell, "config": config, "mix": mix, "manifest": manifest}


def _metric_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(f"flowbench.metrics.{name}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _peaks(device_name: str) -> Optional[Dict]:
    for key, v in json.loads((ROOT / "peaks.json").read_text()).items():
        if key in device_name:
            return v
    return None


@dataclasses.dataclass
class Context:
    """What the per-layer readers read."""

    prm: object                      # reference.dis.Params
    height: int                      # the divisibility-padded frame
    width: int
    requests: int                    # untraced window
    enqueue_s: float
    window: object = None            # trace.Window of the traced window
    pairs_traced: int = 0
    trips: List = dataclasses.field(default_factory=list)   # a Trips a pool pair
    peaks: Optional[Dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    def layer_ms_per_pair(self, layer: str) -> Optional[float]:
        if self.window is None or not self.pairs_traced:
            return None
        s = self.window.layer_s.get(layer, 0.0)
        return s / self.pairs_traced * 1e3 if s > 0 else None

    def roofline_pct(self, layer: str, count) -> Optional[float]:
        device_ms = self.layer_ms_per_pair(layer)
        if device_ms is None or self.peaks is None or not self.trips:
            return None
        flops = nbytes = 0.0
        for t in self.trips:
            f, b = count(self.prm, self.height, self.width, t)
            flops += f / len(self.trips)
            nbytes += b / len(self.trips)
        if flops == 0 and nbytes == 0:
            return None
        t_ops = flops / self.peaks["fp32_flop_per_s"]
        t_bytes = nbytes / self.peaks["bytes_per_s"]
        least_ms = max(t_ops, t_bytes) * 1e3
        self.notes.append(
            f"roofline {layer}: {flops:.6g} operations, {nbytes:.6g} bytes a pair; "
            f"least {least_ms:.6f} ms, bound by {'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"device {device_ms:.6f} ms a pair")
        return 100.0 * least_ms / device_ms


class _Timer:
    """Issue-to-ready time of a request: CUDA events on the card, the
    host's clock on the CPU (tests only)."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.cuda:
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t0) * 1e3


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             size=None, wrap: Optional[Callable] = None, log=None) -> Dict:
    """One run of cell ``name``; returns the result object.  ``size``
    (H, W) replaces the configuration's frame size and ``wrap`` wraps the
    entry (the fault tests use both, on the CPU); ``log`` takes the
    lines printed before the result (default: standard error)."""
    import torch
    from torch.profiler import record_function

    from .reference import dis as reference
    from .traffic.pool import make_pool
    from . import compare
    from . import trace as tr

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    spec = load_cell(name)
    cell, config, mix = spec["cell"], spec["config"], spec["mix"]
    height, width = size or (config["height"], config["width"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dis_tpu_torch
    from dis_tpu_torch import serving

    cfg = dis_tpu_torch.DISConfig(**config["dis"])
    prm = reference.Params.from_fields(config["dis"])
    batch = mix["batch"]
    t_imported = time.clock_gettime(time.CLOCK_BOOTTIME)
    pool = make_pool(mix["pairs"], seed, height, width, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_pool = time.clock_gettime(time.CLOCK_BOOTTIME)
    if len(pool) % batch:
        raise ValueError(f"a pool of {len(pool)} pairs does not split into batches of {batch}")
    if batch == 1:
        reqs = [(pool.img1[i], pool.img2[i]) for i in range(len(pool))]
    else:
        reqs = [(pool.img1[i:i + batch], pool.img2[i:i + batch])
                for i in range(0, len(pool), batch)]
    entry = serving.aot_compile(cfg, height, width, batch if batch > 1 else None, device=dev)
    call = wrap(entry) if wrap else entry
    timer = _Timer(dev)
    for r in reqs:                           # the loop itself, once over the pool
        timer.start()
        call(*r)
        timer.stop_ms()
    setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) - PROCESS_START

    log(f"set-up: imports {t_imported - PROCESS_START:.3f} s, pool {t_pool - t_imported:.3f} s, "
        f"entry {setup_s - (t_pool - PROCESS_START):.3f} s ({len(pool)} pairs, "
        f"{len(reqs)} requests a pass)")
    sampler = random.Random(seed * 2654435761 % 2 ** 61)
    n_sample = mix["sample_requests"]
    sample: List = []                        # (request index, flow)
    lat: List[float] = []
    enqueue_s = 0.0
    failed = 0
    n = 0
    gc.collect()
    gc.disable()                 # no collection pauses inside the window
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a, b = reqs[n % len(reqs)]
        timer.start()
        h0 = time.perf_counter()
        try:
            out = call(a, b)
        except RuntimeError as e:
            failed += 1
            out = None
            log(f"request {n} failed: {e}")
        enqueue_s += time.perf_counter() - h0
        lat.append(timer.stop_ms())
        if out is not None:
            if len(sample) < n_sample:
                sample.append((n, out))
            else:
                j = sampler.randrange(n + 1)
                if j < n_sample:
                    sample[j] = (n, out)
        n += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    gc.enable()
    pairs = (n - failed) * batch
    q = statistics.quantiles(lat, n=100, method="inclusive") if len(lat) > 1 else lat * 99
    log(f"window: {n} requests ({failed} failed), {pairs} pairs in {window_s:.6f} s; "
        f"latency median {statistics.median(lat):.6f} ms, p95 {q[94]:.6f} ms")

    ctx = Context(prm, -(-height // 2 ** prm.coarsest_scale) * 2 ** prm.coarsest_scale,
                  -(-width // 2 ** prm.coarsest_scale) * 2 ** prm.coarsest_scale,
                  n, enqueue_s)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1}
    breakdown = None
    if trace:
        passes = max(1, round(TRACE_SECONDS * n / max(window_s, 1e-9) / len(reqs)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with record_function(WINDOW):
                for i in range(passes * len(reqs)):
                    with record_function("flowbench.request"):
                        call(*reqs[i % len(reqs)])
                    with record_function("flowbench.wait"):
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                chrome = json.load(f)
        patterns = tr.layer_patterns()
        ctx.window = tr.read_window(chrome, WINDOW, patterns)
        del chrome, prof
        ctx.pairs_traced = passes * len(reqs) * batch
        ctx.peaks = _peaks(device_info["kind"])
        device_info["busy_s"] = ctx.window.busy_s
        device_info["window_s"] = ctx.window.window_s
        breakdown = {"device_ops": ctx.window.device_ops, "idle_gaps": ctx.window.idle_gaps}
        for layer, s in sorted(ctx.window.layer_s.items()):
            log(f"layer {layer}: {s * 1e3 / ctx.pairs_traced:.6f} device ms a pair")
        ids = {kid for _, kid, _ in patterns}
        for k, v in ctx.window.kernel_s.items():
            if k not in ids:
                log(f"unattributed: {v * 1e3 / ctx.pairs_traced:.6f} ms a pair: {k}")
        log(f"traced: {passes} passes, {ctx.pairs_traced} pairs, {ctx.window.events} device "
            f"events, busy {ctx.window.busy_s:.6f} of {ctx.window.window_s:.6f} s")
    if dev.type == "cuda":
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    else:
        device_info["memory_peak_bytes"] = 0

    # The check: the program's state freed, the reference on the pairs of
    # the sampled requests (on every pool pair in a traced run, whose
    # search roofline reads the reference's trips).
    del entry, call
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    wanted = {}
    for i, out in sample:
        r = i % len(reqs)
        flows = out if batch > 1 else out[None]
        for k in range(batch):
            wanted.setdefault(r * batch + k, []).append(flows[k])
    ref_pairs = range(len(pool)) if trace else sorted(wanted)
    readings, epes = [], []
    t_ref = time.perf_counter()
    for p in ref_pairs:
        trips = reference.Trips()
        ref = reference.flow(pool.img1[p], pool.img2[p], prm, trips=trips)
        ctx.trips.append(trips)
        for fl in wanted.get(p, []):
            readings.append(compare.pair_gaps(fl, ref))
            epes.append(compare.masked_epe(fl, pool.gt[p], pool.valid[p]))
    log(f"reference: {len(ref_pairs)} pairs in {time.perf_counter() - t_ref:.3f} s; "
        f"{len(readings)} flows compared; mean EPE against ground truth "
        f"{statistics.fmean(epes) if epes else float('nan'):.6f} px")
    numbers = compare.worst(readings)
    log("gaps to the reference, worst pair: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()))

    if trace:
        metrics = {}
        for m in spec["manifest"]["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = _metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        for note in ctx.notes:
            log(note)
        if dev.type == "cuda":
            log(f"card: {_power_limit()}")
    else:
        metrics = {"pairs_per_s": {"value": pairs / window_s, "unit": "pairs/s"},
                   "latency_p95_ms": {"value": q[94], "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    lim = compare.limits(name)
    correct = bool(readings) and failed == 0 and compare.judge(numbers, lim)
    compared = {k: {"value": None if math.isnan(numbers.get(k, math.nan)) else numbers[k],
                    "limit": v} for k, v in lim.items()}
    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    for k, v in compared.items():
        log(f"compared {k}: {v['value']!r} limit {v['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flowbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)["cell"]
    except (OSError, KeyError, ValueError) as e:
        print(f"flowbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)             # one process, few threads: steadier host times
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"flowbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}: no result", file=sys.stderr)
        return 1
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except ImportError as e:
        print(f"flowbench: the program cannot be imported: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules(sys.modules)
    if found:
        print(f"flowbench: loaded {found} (JAX or the JAX package): no result",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
