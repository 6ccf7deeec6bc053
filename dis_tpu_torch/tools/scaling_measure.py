"""Multi-GPU scaling projection from one card; counterpart of
``tools/scaling_measure.py``.

On one card the tool times, by CUDA-graph replay, every per-rank program
of the two exact tiling engines of ``parallel/tiles.py``:

* stripes (``tiled_flow_fn``): rank i runs ``dis_flow_stripe`` on its
  stripe extended by ``min_stripe_halo`` rows (the top, interior and
  bottom stripes differ); the slowest rank is the frame's critical path;
* windows (``grid_tiled_flow_fn``): rank i builds both pyramids and runs
  ``dis_scale_window`` on its window of every scale's output rows, fed
  the true coarser flows of the untiled run.

The collectives are modelled, not measured: :func:`collective_bytes`
gives the bytes the busiest rank receives from each ``shift`` and
``all_gather_rows`` call the engine makes (``parallel/mesh.py``), and
they cross a link of ``--link-gbps``.  Its default is an assumption,
named in the output: NVIDIA's published NVLink 4 bandwidth of one H100
SXM, 900 GB/s over its 18 links counting both directions, so 450 GB/s
into the card.  Host dispatch and the host staging of gloo are not
modelled: the figures are a device-side projection,

    efficiency(n) = T1 / (n * (max over ranks of compute + link)),

where T1 is the untiled ``dis_flow_padded``.  Each rank's flow is
stitched and held to the untiled flow bitwise.  The sizes are the 1080p
and 4K frames padded so that 2, 4 and 8 stripes align (1088 x 1920 and
2176 x 3840, as the JAX tool takes them).  One JSON record per size:
the projection, the halo duplication table and the times.

Usage:
    python -m dis_tpu_torch.tools.scaling_measure
    python -m dis_tpu_torch.tools.scaling_measure --sizes 4K --ns 2,4
    python -m dis_tpu_torch.tools.scaling_measure --sizes 64x96 --ns 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DISConfig
from ..models.dis import dis_flow_padded, dis_flow_stripe, dis_scale_window
from ..ops.pyramid import construct_pyramid
from ..parallel.tiles import min_stripe_halo, stripe_bounds, window_partition
from ..serving import _device
from .trace_budget import BENCH_CFG

SIZES = {"1080p": (1088, 1920), "4K": (2176, 3840)}
NS = (2, 4, 8)
# NVIDIA's published NVLink 4 bandwidth of one H100 SXM: 900 GB/s in
# total over 18 links, both directions; 450 GB/s into the card.
LINK_GBPS = 450.0
LINK_ASSUMPTION = ("NVIDIA's published NVLink 4 figure for the H100 SXM (900 GB/s over "
                   "18 links, both directions), taken as {gbps:g} GB/s into each card; "
                   "every rank receives from its peers at once over an NVSwitch")
F32 = 4


def synth_pair(h: int, w: int, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """``bench.synth_pair``'s recipe at h x w: a uniform random plane
    under a 7x7 box mean (symmetric border) and its copy shifted by
    (3, 2) px."""
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    big = (r.random((h + 16, w + 16)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    return (np.ascontiguousarray(big[8:8 + h, 8:8 + w]),
            np.ascontiguousarray(big[6:6 + h, 5:5 + w]))


def time_ms(fn: Callable, dev: torch.device, calls: int = 5, reps: int = 5) -> float:
    """Median ms per call of ``fn``.  On a card: device time, ``calls``
    calls captured in one CUDA graph and replayed between CUDA events
    (the graph counts each kernel's launch once, at its capture).  On
    the CPU: the host clock around single calls."""
    if dev.type != "cuda":
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ts = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(ts))


def collective_bytes(engine: str, cfg: DISConfig, height: int, width: int,
                     n: int) -> Dict[int, List[Tuple[str, int]]]:
    """{rank: [(call, bytes received), ...]}: the ``shift`` and
    ``all_gather_rows`` calls of one frame of ``engine`` ("stripe":
    ``tiled_flow_fn``; "grid": ``grid_tiled_flow_fn``) over ``n`` ranks
    for a config without refinement, in call order, with the bytes each
    call brings to each rank (a gather brings the other ranks' shards)."""
    if cfg.refinement_iters > 0:
        raise ValueError("the model covers configs without refinement")
    own_h = height // n
    calls = {i: [] for i in range(n)}
    if engine == "stripe":
        halo = min_stripe_halo(cfg, width, height, n)
        for img in ("img1", "img2"):
            if halo > own_h:
                for i in range(n):
                    calls[i].append((f"all_gather_rows({img})", (n - 1) * own_h * width * F32))
            else:
                for i in range(n):
                    calls[i].append((f"shift({img} bottom rows, down)",
                                     halo * width * F32 if i > 0 else 0))
                    calls[i].append((f"shift({img} top rows, up)",
                                     halo * width * F32 if i < n - 1 else 0))
    elif engine == "grid":
        for img in ("img1", "img2"):
            for i in range(n):
                calls[i].append((f"all_gather_rows({img})", (n - 1) * own_h * width * F32))
        for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            wins = window_partition(height >> s, n)
            cmax = wins[0][1] - wins[0][0]
            for i in range(n):
                calls[i].append((f"all_gather_rows(flow scale {s})",
                                 (n - 1) * cmax * (width >> s) * 2 * F32))
    else:
        raise ValueError(f"engine must be 'stripe' or 'grid', got {engine!r}")
    return calls


def measure(name: str, height: int, width: int, ns: Sequence[int] = NS,
            cfg: DISConfig = BENCH_CFG, device="cuda",
            link_gbps: float = LINK_GBPS) -> dict:
    """The record of one size: T1, each engine's per-rank times, link
    bytes and times, projected efficiency and speedup for each n, the
    halo duplication table, and whether each engine's stitched flow is
    bitwise the untiled flow."""
    dev = _device(device, "scaling_measure")
    if cfg.refinement_iters > 0:
        raise ValueError("the projection covers configs without refinement")
    f = 2 ** cfg.coarsest_scale
    for n in ns:
        if height % (n * f):
            raise ValueError(f"height {height} must be divisible by n * {f} = {n * f} "
                             "for stripe tiling")
    link_bps = link_gbps * 1e9
    a, b = (torch.from_numpy(x).to(dev) for x in synth_pair(height, width))
    untiled = dis_flow_padded(a, b, cfg)
    t1 = time_ms(lambda: dis_flow_padded(a, b, cfg), dev)
    rec = {"size": name, "height": height, "width": width,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "config": "compat bench config (iterations 16, patch 8, overlap 0.3, scales 3..0)",
           "projection": "device-side: per-rank compute measured on one device, "
                         "collectives modelled from their exact bytes; host dispatch "
                         "and staging not modelled",
           "link_bytes_per_s": link_bps,
           "link_assumption": LINK_ASSUMPTION.format(gbps=link_gbps),
           "t1_ms": t1, "stripe": {}, "grid": {}, "halo": {}}

    # The true coarser flow that feeds each scale (None at the coarsest).
    pyr1 = construct_pyramid(a, cfg.coarsest_scale, cfg.img_padding)
    pyr2 = construct_pyramid(b, cfg.coarsest_scale, cfg.img_padding)
    coarser, flow = {}, None
    for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        coarser[s] = flow
        flow = dis_scale_window(pyr1[s], pyr2[s], flow, cfg, s, 0, pyr1[s].height)[0]
    del pyr1, pyr2, flow

    for n in ns:
        halo = min_stripe_halo(cfg, width, height, n)
        bounds = [stripe_bounds(cfg, height, n, i, halo) for i in range(n)]
        rec["halo"][str(n)] = {"halo": halo, "own_h": height // n,
                               "gathers_frames": halo > height // n,
                               "ext_h": [bd[1] for bd in bounds],
                               "dup_factor": sum(bd[1] for bd in bounds) / height}
        ranks, parts = [], []
        for row0, ext_h, own_r0, own_h in bounds:
            s1, s2 = (x[row0:row0 + ext_h].contiguous() for x in (a, b))

            def stripe(s1=s1, s2=s2, row0=row0, own_r0=own_r0, own_h=own_h):
                return dis_flow_stripe(s1, s2, cfg, row0=row0, own_r0=own_r0,
                                       own_h=own_h, global_h=height)

            parts.append(stripe())
            ranks.append(time_ms(stripe, dev))
        rec["stripe"][str(n)] = _engine_rec("stripe", cfg, height, width, n, ranks, t1,
                                            link_bps, torch.equal(torch.cat(parts), untiled))

        ranks, parts = [], []
        for i in range(n):
            def window(i=i):
                p1 = construct_pyramid(a, cfg.coarsest_scale, cfg.img_padding)
                p2 = construct_pyramid(b, cfg.coarsest_scale, cfg.img_padding)
                out = None
                for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
                    lo, hi = window_partition(height >> s, n)[i]
                    out = dis_scale_window(p1[s], p2[s], coarser[s], cfg, s, lo, hi)[0]
                return out

            parts.append(window())
            ranks.append(time_ms(window, dev))
        rec["grid"][str(n)] = _engine_rec("grid", cfg, height, width, n, ranks, t1,
                                          link_bps, torch.equal(torch.cat(parts), untiled))
    return rec


def _engine_rec(engine, cfg, height, width, n, ranks, t1, link_bps, bitwise) -> dict:
    """One engine's entry for n ranks; the link carries the calls of the
    rank that receives the most bytes."""
    calls = max(collective_bytes(engine, cfg, height, width, n).values(),
                key=lambda c: sum(b for _, b in c))
    nbytes = sum(b for _, b in calls)
    link_ms = nbytes / link_bps * 1e3
    frame = max(ranks) + link_ms
    return {"rank_ms": ranks, "max_rank_ms": max(ranks), "link_calls": calls,
            "link_bytes": nbytes, "link_ms": link_ms, "frame_ms": frame,
            "efficiency": t1 / (n * frame), "speedup": t1 / frame,
            "stitched_bitwise": bool(bitwise)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1080p,4K",
                    help="comma-separated: 1080p, 4K or HxW")
    ap.add_argument("--ns", default=",".join(map(str, NS)),
                    help="comma-separated rank counts to project")
    ap.add_argument("--link-gbps", type=float, default=LINK_GBPS,
                    help=f"assumed bandwidth into each card, GB/s (default {LINK_GBPS:g}: "
                         "NVLink 4 of the H100 SXM)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)
    ns = [int(x) for x in args.ns.split(",")]
    ok = True
    for name in args.sizes.split(","):
        h, w = SIZES[name] if name in SIZES else (int(v) for v in name.split("x"))
        rec = measure(name, h, w, ns, device=args.device, link_gbps=args.link_gbps)
        ok &= all(e["stitched_bitwise"] for k in ("stripe", "grid") for e in rec[k].values())
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
