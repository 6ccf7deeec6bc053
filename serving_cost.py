#!/usr/bin/env python3
"""Two one-time measurements of ``dis_tpu_torch``'s serving layer, on one
CUDA GPU (no arguments):

1. The op dispatcher on the eager 1080p compat frame.  An eager wrapper
   calls its op's CUDA function straight (``ops/cuda::dispatch``); the
   other route sends every call through the registered op
   (``dis_tpu_torch::``), as a trace records it.  Both routes give the
   same bits.  The frame is
   timed in 10 rounds of four slots, the first slot alternating between
   the routes (op, direct, direct, op, then direct, op, op, direct, ...;
   CUDA events, median of 20 after warm-up), and one K3 launch on a
   64 x 64 image, host microseconds a call over 500 calls, the same way.
2. The saved artifact of 1080p ``DIS_MEDIUM`` (``serving.export_flow``):
   export seconds, graph nodes, kernel ops and bytes; load in this
   process; the artifact in a fresh process that this one waits for
   (``chip_smoke.py --serve-child``: load and import to first flow, and
   its replay); then ``serving.aot_compile`` of the same bucket, whose
   flow the reloaded artifact's must equal bitwise, and the two replays
   timed in turns (``chip_smoke.in_turns``).

Prints the card (name and power limit) and one JSON line.  Without a card
it exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import H, W, fresh_process, in_turns, time_ms

ROUNDS = 10
CALLS = 500


@contextlib.contextmanager
def op_route():
    """Within this context each wrapper calls its registered op, eagerly
    too, not the op's CUDA function."""
    from dis_tpu_torch.ops.cuda import (extract_banded_kernel as bk, extract_kernel as ek,
                                        iclk_kernel as ik, pyramid_kernel as pk,
                                        refine_kernel as rk)

    modules = (pk, ek, bk, ik, rk)
    saved = [m.dispatch for m in modules]
    for m in modules:
        m.dispatch = lambda op, cuda_fn, device, *args: op(*args)
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.dispatch = fn


def host_us(fn, calls: int = CALLS) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls, the card
    synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def dispatch_cost(a, b) -> dict:
    import dis_tpu_torch as dt
    from dis_tpu_torch.ops.cuda import pyramid_kernel as pk
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search

    cfg = dt.DISConfig(iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
                       patch_overlap=0.3, patch_normalization=True, mode="compat",
                       early_exit=False)
    want = dt.dis_flow(a, b, cfg)
    with op_route():
        if not torch.equal(dt.dis_flow(a, b, cfg), want):
            raise SystemExit("the op route's flow differs from the direct route's")
    src = torch.rand(64, 64, device=a.device)
    k3 = lambda: pk.pyramid_levels(src, 4, 1)              # noqa: E731
    frame = lambda: dt.dis_flow(a, b, cfg)                 # noqa: E731
    out = {"frame_ms": {"op": [], "direct": []}, "k3_host_us": {"op": [], "direct": []}}
    for r in range(ROUNDS):
        order = ("op", "direct", "direct", "op") if r % 2 == 0 else ("direct", "op", "op",
                                                                      "direct")
        for route in order:
            with op_route() if route == "op" else contextlib.nullcontext():
                out["frame_ms"][route].append(time_ms(frame, reps=20))
                out["k3_host_us"][route].append(host_us(k3))
    for key in ("frame_ms", "k3_host_us"):
        op, direct = (float(np.median(out[key][r])) for r in ("op", "direct"))
        out[key + "_median"] = {"op": op, "direct": direct, "op_over_direct": op / direct - 1}
    wrappers = (pk.pyramid_levels, extract_regions, extract_regions_banded, iclk_search)
    before = sum(w.launches for w in wrappers)
    frame()
    out["op_calls_per_frame"] = sum(w.launches for w in wrappers) - before
    return out


def artifact_cost(a, b) -> dict:
    from dis_tpu_torch import DIS_MEDIUM
    from dis_tpu_torch.cost import kernel_ops
    from dis_tpu_torch.serving import aot_compile, export_flow, load_exported

    out = {}
    t0 = time.perf_counter()
    data = export_flow(DIS_MEDIUM, H, W)
    out["export_s"] = time.perf_counter() - t0
    out["bytes"] = len(data)
    t0 = time.perf_counter()
    loaded, program = load_exported(data)
    out["load_s"] = time.perf_counter() - t0
    out["graph_nodes"] = len(program.graph.nodes)
    out["kernel_ops"] = kernel_ops(program)
    del program
    got, flow_child, out["fresh_process_wall_s"] = fresh_process(data)
    out["fresh_process"] = got
    t0 = time.perf_counter()
    compiled = aot_compile(DIS_MEDIUM, H, W)
    out["aot_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flow = loaded(a, b)             # the loaded program's capture
    torch.cuda.synchronize()
    out["first_call_s"] = time.perf_counter() - t0
    if not (torch.equal(flow, compiled(a, b)) and torch.equal(flow_child.to(a.device), flow)):
        raise SystemExit("the reloaded artifact's flow differs from aot_compile's")
    out["replay_ms_in_turns"] = in_turns({"artifact": loaded, "aot_compile": compiled}, a, b)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("serving_cost: torch.cuda.is_available() is False; it measures "
                         "on a CUDA GPU only")
    from bench import synth_pair

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    a, b = (torch.from_numpy(q).cuda() for q in synth_pair())
    out = {"card": card, "dispatch": dispatch_cost(a, b),
           "medium_1080p_artifact": artifact_cost(a, b)}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
