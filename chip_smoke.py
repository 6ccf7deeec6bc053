#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``dis_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dis_tpu_torch/csrc`` and then:

0. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, both TF32 flags (set off) and the build time;
1. holds each kernel against its plain PyTorch version on the card, at
   the 1080p main-path shapes, bitwise: K3 (all four levels of a pyramid
   in one launch) against the plain level chain for both images, K2 (also
   at N = 0) and K1 (compat and ``DIS_FAST``; its equivalence-class
   numbers, max |du| and freeze flips, are printed beside), and K1/K2 at
   ps 8, 10, 12, 16 on a small plane with random init and random start
   freezes, so that the patches of one warp freeze at different trips;
2. drives ``dis_tpu_torch.dis_flow`` on the 1920x1080 pair of
   ``bench.synth_pair()`` (a (3, 2) px shift) under the compat bench
   config and ``DIS_FAST``: K3 launches once per image, K2 and K1 once
   per scale, the
   flow finite, its median within 0.01 px of (3, 2), its mean EPE within
   0.002 px of the JAX package's CPU reading, and the kernel path within
   1e-3 px mean (<= 1% of pixels over 1e-2 px) of the plain path;
3. times each kernel and its plain version at the main-path shapes, and
   ``dis_flow`` per frame, with CUDA events (median of 20 after warm-up);
   a kernel's time is its device time per call, from a CUDA graph of 20
   calls replayed between the events (``replay_ms``), and K3, K2 and K1
   are also timed a call at a time with their host work.

Batched pairs and the serving path, on 8 KITTI-size pairs (375 x 1242,
padded to 376 x 1248 inside; ``kitti_pair``, NumPy only, a known integer
shift per pair) under config 3 of ``benchmarks/suite.py`` (compat,
iterations 16, patch 8, overlap 0.3, scales 3..0) and ``DIS_ULTRAFAST``
(fixed mode, scales 3..1, so the batched upsample and crop run):

1b. K2b and K1b (K2 and K1 with the pair axis) at each config's B = 8
    finest-scale shapes (152,000 patches for config 3), bitwise equal to
    their batched plain versions and to 8 serial K2/K1 calls;
2b. ``parallel.batched_flow_fn`` and batched ``dis_flow`` on the 8 pairs:
    per batch K2 and K1 launch once per scale and K3 once per image
    stack, whatever B is; the flows equal 8 serial ``dis_flow`` calls
    bitwise; each pair's median is within 0.01 px of its shift and its
    mean EPE within 0.002 px of the JAX package's CPU reading;
2c. ``serving.aot_compile`` (a CUDA graph) for the 1080p compat config at
    B = None and config 3 at KITTI size with B = 8: the captured graph
    holds the same launches as one eager call, each replay is bitwise
    equal to the eager kernel path, and a wrong shape raises;
3b. times (CUDA events, median after warm-up): KITTI pairs/s at B = 1, 2,
    4, 8, eager and replayed; 1080p ms/frame eager and replayed; K2b and
    K1b against their plain versions at B = 8.

The 4K path, on ``synth_pair_4k()`` (3840x2160, ``bench.synth_pair``'s
recipe, a (3, 2) px shift) under the compat bench config and
``DIS_FAST``, and exact row-stripe tiling:

1c. K3 on a 4K image against the plain level chain, bitwise; K2c (the
    column-banded K2) at the 4K finest-scale shapes (N =
    331,776), bitwise equal to its plain version and to K2 at B = 1, at
    B = 2 and on stripe 1 of 3 (row0 = 544), where K1 with row0 > 0 is
    held to its plain version bitwise; K2c at ps 12 on a small plane; an empty
    grid launches nothing; K2 in each of these also with the grid's column
    length (``num_h``), so that its groups follow the columns; the share of
    windows that K2c copied from device memory, outside its group's staged
    box, is printed (a few, where the init flow spreads a group widely);
1d. windows outside the staged box: inits drawn up to the 4K finest
    scale's static bound (56 px) on the 4K, 1080p and KITTI B = 8 finest
    grids, so that many groups' boxes outgrow the fixed stage; K2c, K2
    and K2 with ``num_h`` bitwise equal to the plain version;
2d. ``dis_flow`` at 4K: per call K3 launches twice, K2c once and K2 three times
    (none under ``DIS_ULTRAFAST``, whose finest scale is 1), the median
    within 0.01 px of (3, 2), the mean EPE within 0.002 px of the JAX
    package's CPU reading, the kernel path against the plain path under
    the 1080p gates, a batch of 2 bitwise equal to 2 serial calls, and
    an ``aot_compile`` 4K graph replay bitwise equal to the eager path;
2e. ``parallel.tiled_flow_exact`` with 3 stripes and ``min_stripe_halo``
    (176 rows; row0 0, 544, 1264) and ``parallel.grid_tiled_flow`` with 3
    parts, each bitwise equal to the untiled flow, K2c once and K3 twice
    per stripe;
3c. times: K2c and K2 on the same 4K finest inputs (beside a ``zero_``
    fill of as many bytes, the card's practical write rate), 4K ms/frame
    eager and replayed (compat and ``DIS_FAST``), 3-stripe tiled 4K
    ms/frame.

The refinement presets (``DIS_MEDIUM``: ps 8, stride 4, scales 3..0;
``DIS_FULL``: ps 12, stride 3, scales 4..0; both refine every level on
the intensity planes, 5 and 10 weight updates of 5 red-black SOR sweeps),
whose variational refinement is torch ops (no TPU kernel backs it):

1d. (also) K2c and K2 on ``DIS_FULL``'s 1080p finest grid (230,400
    patches, ps 12) from its own refined init, with the share of windows
    copied from device memory;
2f. ``dis_flow`` on the 1080p pair: per frame K3 2, K2 4, K1 4
    (``DIS_MEDIUM``) and K3 4, K2 5, K1 5 (``DIS_FULL``, whose five
    levels take two K3 launches per image), no K2c; the median within
    0.01 px of (3, 2), the mean EPE within 0.002 px of the JAX package's
    CPU reading (``tools/jax_epe_readings.py``), the kernel path against
    the plain path under the phase-2 gates; the refinement of each
    frame's finest level on the card bitwise equal to the same call on
    the CPU;
2g. ``DIS_MEDIUM`` on the other paths: the 8 KITTI pairs batched
    bitwise equal to serial; ``aot_compile`` graphs at 1080p and KITTI
    B = 8 (peak memory printed) holding the eager launches, each replay
    bitwise equal to eager; ``grid_tiled_flow`` (3 parts) and
    ``tiled_flow_exact`` (3 stripes, routed to the grid engine), and
    ``refine_per_level=False`` through ``tiled_flow_exact``, bitwise
    equal to untiled; 4K unclamped (K2 at every scale, no K2c) and 1080p
    and 4K with ``refined_init_clamp`` (K2c exactly where
    ``scale_extraction_route`` says), each flow finite with its median
    within 0.01 px of its shift;
3d. times: eager and replayed ms/frame for 1080p ``DIS_MEDIUM`` and
    ``DIS_FULL`` and 4K ``DIS_MEDIUM``, KITTI ``DIS_MEDIUM`` pairs/s at
    B = 8, and the refinement alone, replayed, per level at 1080p with
    its launches (non-view torch ops) and its share of the frame.

The saved serving artifact (``serving.export_flow``, ``torch.export``
with the kernels as ``dis_tpu_torch`` ops), after phase 2g:

2h. the compat bench config exported at 1080p (B = None), config 3 at
    KITTI size with B = 8 and the compat 4K bucket: each program holds the
    kernel ops in the counts of ``scale_counts`` (at 4K one extraction is
    K2c) and no gather of a plain K2 or K1; the KITTI and 4K artifacts,
    reloaded in this process (``load_exported``), replay bitwise equal to
    their eager kernel flows; the 1080p artifact, loaded in a fresh process
    that has the pipeline's functions replaced by ones that raise
    (``--serve-child``; this process waits for it, so nothing else runs on
    the card or the host meanwhile), gives a flow bitwise equal to phase
    2c's replay, its graph holding K3 2, K2 4, K1 4; export time, bytes,
    the child's time from import to the first flow and its replayed frame
    are printed, then the 1080p artifact's replay and ``aot_compile``'s in
    turns;
    then ``cost_analysis()`` and ``memory_analysis()`` of the 1080p
    bucket, whose kernel entries give the ``kernels`` line's bounds (K3,
    K2 exactly; K1, counted for its fixed loop, within 0.1%).

The user-facing surface (phase 4, after the times): the CLI
(``dis_tpu_torch.cli.main``) and the sequence runner on a 9-frame
1920x1080 sequence (``write_sequence``: ``bench.synth_pair``'s recipe,
each frame shifted (3, 2) px from the last, quantised to 8-bit PNG by the
port's own writer, with ``.flo`` ground truth) in a temporary directory:

4.  the native I/O library builds (required); the compat bench config
    over the 8 pairs writes 8 colourised PNGs and ``.flo`` files, each
    ``.flo`` bitwise equal to the eager kernel path on the decoded
    frames, its graph capturing K3 2, K2 4, K1 4 a frame (the counts move
    at the 2 warm-up calls and the capture, never at a replay), its mean
    EPE within 0.002 px of the JAX CLI's CPU reading (``EPE_JAX_CLI``);
    ``--batch 4`` (K2b, K1b), ``--preset medium``, ``draw_grid = 1``,
    ``DIS_TPU_CHECK=1``, ``--profile-dir`` (a trace naming ``pyramid``
    and ``scale_0``) and the runner stopped after pair 4 and resumed,
    each bitwise equal to the serial run; a 4K pair through the CLI
    (K2c once); and the CLI's steady-state rate with its split by phase
    (``PhaseTimer``: decode, flow, colorize, encode, flo, score), the
    card's busy time a pair read from the ``--profile-dir`` trace, and
    the port's PNG writer timed against PIL's (where PIL is installed) on
    a 1080p colour frame.

The multi-rank engines (phase 5, last), every rank a process on card 0
with gloo (NCCL refuses two ranks on one card; gloo's point-to-point ops
take host tensors, so ``parallel.mesh.shift`` stages those through the
host and counts the bytes), spawned by ``parallel.launch.spawn``; each
rank's launches are counted on its first call, and a second, timed call
must give the same bits:

5a. ``tiled_flow_fn`` at 4K compat over 2 ranks (halo 176 by neighbour
    shifts) and 3 ranks (halo 176), the stitched flow bitwise equal to
    phase 2d's, K3 twice and K2c exactly where ``part_routes`` puts it
    on each rank (the finest scale);
5b. 1080p ``DIS_MEDIUM`` through ``tiled_flow_fn`` (routed to
    ``grid_tiled_flow_fn``) over 3 ranks, bitwise equal to phase 2f's;
5c. ``sequence_pair_flow_fn`` (9 frames) and ``sequence_flow_fn`` (the
    first 8) over 2 ranks on phase 4's 1080p sequence, bitwise equal to
    the serial flows (K2b and K1b on each rank);
5d. the batch mesh over 2 ranks on the 8 KITTI pairs: flows bitwise equal
    to phase 2b's, the mean EPE to the single-device
    ``batched_flow_epe_fn``'s on every rank; read beside it: whether one
    reduction over 8 pairs gives each pair's EPE the bits of one over 4,
    and both forms' times;
5e. NCCL at world size 1 (``init_multi_host`` from ``MASTER_ADDR`` and
    friends): ``tiled_flow_fn`` and the batch mesh with n = 1, bitwise,
    nothing staged;
5f. ``run_sequence_shard`` with 2 hosts on the sequence, host 1 killed
    after one pair and relaunched: every ``.flo`` bitwise equal to the
    serial flow;
5g. ``dryrun_multichip(4, device="cuda:0")``.

Each rank's time is printed as that of N ranks sharing one H100, not a
scaling figure, and the phase's seconds.

Each kernel's line gives its bound: the larger of the bytes it must move
(each input read once, each output written once: K3 the raw image and
every level's planes, K1 its inputs with the raw template only for the
patches frozen at the start) over 3.35 TB/s and its operations (K1's for
the trips these inputs run) over 67 TFLOP/s, the H100 SXM's HBM3 and
float32 peaks; the formulas are the package's (``dis_tpu_torch/cost.py``).
No single PyTorch call computes any of these functions, so
``library_ms`` is null.

``python3 chip_smoke.py --kernel-times ROOT`` builds and times only the
kernels (K3; K2 and K1 at the 1080p finest scale; K2b and K1b at KITTI
B = 8; K2c and K2 on the same 4K finest inputs, and K1 there) and the
replayed 1080p and 4K compat frames, on the same inputs, for the
``dis_tpu_torch`` package under the directory ROOT
(an unpacked earlier commit, say, to compare two trees in one run on one
card), and prints one JSON line.

It prints one JSON line of kernel results, then the card line, then
``{"ok": true, "device": {...}}`` last.  Any failed check raises, so the
script exits nonzero before the last line.  Without a CUDA device, or
without the repository beside it, it fails the same way.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 1920, 1080
SHIFT = (3.0, 2.0)
# Mean EPE against the (3, 2) shift of the JAX package on CPU, same pair
# and configs; the port must land within EPE_TOL of it.  DIS_MEDIUM and
# DIS_FULL: tools/jax_epe_readings.py (64 s and 302 s on the CPU).
EPE_JAX = {"compat": 0.1526, "fast": 0.00515,
           "medium": 0.00048054210492409766, "full": 0.0002898645179811865}
EPE_TOL = 0.002
REPS = 20

# KITTI-size batch: 8 pairs of 375 x 1242 (padded to 376 x 1248 inside),
# pair i shifted by KITTI_SHIFTS[i] px (x, y).
KH, KW = 375, 1242
KITTI_SHIFTS = ((3, 2), (-2, 1), (1, -3), (4, 0), (0, 4), (-3, -2), (2, 3), (-1, -4))
# Per-pair mean EPE against the shift of the JAX package's dis_flow on CPU
# for the pairs of kitti_pair() (config 3 of benchmarks/suite.py, and
# DIS_ULTRAFAST); the port must land within EPE_TOL of each.
EPE_JAX_KITTI = {
    "config3": (0.173230, 0.169141, 0.197344, 0.181740,
                0.163455, 0.214641, 0.174270, 0.218064),
    "ultrafast": (0.151357, 0.154174, 0.210587, 0.018400,
                  0.016074, 0.153179, 0.160621, 0.160990),
}


W4K, H4K = 3840, 2160
# Mean EPE against the (3, 2) shift of the JAX package's dis_flow on CPU
# for synth_pair_4k(), compat bench config and DIS_FAST.
EPE_JAX_4K = {"compat": 0.1492468, "fast": 0.0040877}
N_STRIPES = 3
PLAIN_REPS_4K = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak
F32_OPS_PER_S = 67e12       # H100 SXM float32 peak outside the tensor cores


def kitti_pair(i: int):
    """Pair i of the KITTI-size batch, NumPy only: a uniform random plane
    (seed 100 + i) under a 7x7 box mean (separable float32 sums over a
    symmetric border), and its copy shifted by KITTI_SHIFTS[i], so the
    flow from the first frame to the second is KITTI_SHIFTS[i]."""
    m = 8
    r = np.random.default_rng(100 + i)
    big = (r.random((KH + 2 * m, KW + 2 * m)) * 255).astype(np.float32)
    pad = np.pad(big, 3, mode="symmetric")
    rows = sum(pad[:, k:k + big.shape[1]] for k in range(7))
    box = sum(rows[k:k + big.shape[0]] for k in range(7)) / np.float32(49.0)
    dx, dy = KITTI_SHIFTS[i]
    i1 = box[m:m + KH, m:m + KW]
    i2 = box[m - dy:m - dy + KH, m - dx:m - dx + KW]
    return np.ascontiguousarray(i1), np.ascontiguousarray(i2)


def synth_pair_4k():
    """``bench.synth_pair``'s recipe at 3840x2160: a uniform random plane
    (seed 42) under a 7x7 box mean (SciPy ``convolve2d``, symmetric
    border), and its copy shifted by (3, 2) px."""
    from scipy.signal import convolve2d

    r = np.random.default_rng(42)
    big = (r.random((H4K + 16, W4K + 16)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    return (np.ascontiguousarray(big[8:8 + H4K, 8:8 + W4K]),
            np.ascontiguousarray(big[6:6 + H4K, 5:5 + W4K]))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def replay_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Median device milliseconds per call of ``fn``: ``calls`` calls
    captured in one CUDA graph and replayed between CUDA events, so no
    host work lies inside the timed window (a call's own launch overhead
    would otherwise count for the shortest kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps=reps, warmup=2) / calls
    del graph
    return ms


def search_gate(name, kout, pout):
    """K1 bitwise equal to its plain version; also the equivalence class
    of the JAX package's tests (u within 1e-3 px where the freeze state
    agrees, freeze flips < 2%), whose numbers are printed.  Returns (max
    |du| over all patches, flip share)."""
    (ku, _, kc), (pu, _, pc) = kout, pout
    agree = kc == pc
    du = (ku - pu).abs().max(dim=1).values
    flips = float((~agree).float().mean()) if agree.numel() else 0.0
    worst = float(du[agree].max()) if bool(agree.any()) else 0.0
    check(worst <= 1e-3, f"{name}: |du| {worst} > 1e-3 on agreeing patches")
    check(flips < 0.02, f"{name}: freeze flips {flips} >= 2%")
    for k, p in zip(kout, pout):
        check(torch.equal(k, p), f"{name}: differs from its plain version")
    return (float(du.max()) if du.numel() else 0.0), flips


def finest_inputs(img1, img2, cfg, p):
    """The finest scale's real K2/K1 inputs for a pair or a batch: the
    coarser scales run through the port.  Returns (cfg, l2, tpl, Tn,
    centers, init_u, pos0, conv0)."""
    from dis_tpu_torch.models.dis import dis_scale_window
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops.grid import init_from_coarser_flow, scale_plan
    from dis_tpu_torch.ops.pyramid import construct_pyramid

    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, p)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, p)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale, -1):
        flow, _, _ = dis_scale_window(pyr1[scale], pyr2[scale], flow, cfg, scale,
                                      0, pyr1[scale].height)
    l1, l2 = pyr1[cfg.finest_scale], pyr2[cfg.finest_scale]
    plan = scale_plan(l1.width, l1.height, cfg.steps, cfg.patch_size, img1.device)
    tpl = iclk.extract_templates_grid(l1.img, l1.dx, l1.dy, plan.geom,
                                      cfg.patch_size, p)
    init_u = init_from_coarser_flow(plan, flow)
    pos0 = plan.centers + init_u
    conv0 = iclk.out_of_bounds(pos0, cfg.patch_size, l1.width, l1.height)
    Tn = iclk.residual_template(tpl, cfg) if cfg.mode == "fixed" else None
    return cfg, l2, tpl, Tn, plan.centers, init_u, pos0, conv0


def num_h_of(level, cfg) -> int:
    """Column length of the scale's patch grid (the main path hands it to
    K2 so that its groups follow the columns)."""
    from dis_tpu_torch.ops.grid import make_grid

    return make_grid(level.width, level.height, cfg.steps).num_h


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def extract_cost(img, pos0, ps):
    """(bytes, operations) of the K2/K2b/K2c launch on these inputs
    (``dis_tpu_torch/cost.py``)."""
    from dis_tpu_torch import cost

    nb = img.shape[0] if img.ndim == 3 else 1
    return cost.extract_cost(nb, *img.shape[-2:], pos0.shape[-2], ps)


def search_cost(init_u, conv0, cfg, trips):
    """(bytes, operations) of the K1/K1b launch on these inputs, for the
    trips they run (``trips``: active patches per trip, from the plain
    version) and the patches frozen at the start (``conv0``)
    (``dis_tpu_torch/cost.py``)."""
    from dis_tpu_torch import cost

    nb = init_u.shape[0] if init_u.ndim == 3 else 1
    return cost.search_cost(nb, init_u.shape[-2], cfg.patch_size, cfg.mode == "fixed",
                            cfg.patch_normalization, sum(trips), int(conv0.sum()))


def refined_levels(img1, img2, cfg):
    """``dis_flow_padded``'s main path with per-level refinement, scale by
    scale: {scale: (l1, l2, coarser refined flow or None, densified
    flow, refined flow)} and the refinement planes."""
    from dis_tpu_torch.models.dis import (build_refinement_planes, dis_scale_window,
                                          refine_level)
    from dis_tpu_torch.ops.pyramid import construct_pyramid

    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding)
    planes = build_refinement_planes(img1, img2, cfg)
    out, flow = {}, None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        l1, l2 = pyr1[scale], pyr2[scale]
        dense, _, _ = dis_scale_window(l1, l2, flow, cfg, scale, 0, l1.height)
        out[scale] = (l1, l2, flow, dense, refine_level(l1, l2, dense, cfg, scale, planes))
        flow = out[scale][4]
    return out, planes


def refine_inputs(cfg, levels, planes, scale):
    """The arguments of the refinement at ``scale`` of a main-path run."""
    l1, l2, _, dense, _ = levels[scale]
    if planes is None:
        return (l1.img, l2.img, dense, cfg)
    return (planes[0][scale], planes[1][scale], dense, cfg, 0)


def torch_ops(fn) -> int:
    """Non-view aten ops that one call of ``fn`` dispatches: each
    launches one kernel on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def flow_gates(label, f, shift, epe_jax=None):
    """The flow [..., H, W, 2] on the host: finite, its median within 0.01
    px of ``shift`` and, where given, its mean EPE within EPE_TOL of the
    JAX reading.  Returns (median, EPE)."""
    check(bool(np.isfinite(f).all()), f"{label}: non-finite flow")
    med = np.median(f.reshape(-1, 2), axis=0)
    epe = float(np.sqrt((f[..., 0] - shift[0]) ** 2 + (f[..., 1] - shift[1]) ** 2).mean())
    check(bool(np.all(np.abs(med - np.array(shift)) <= 0.01)),
          f"{label}: median {med} not within 0.01 of {shift}")
    if epe_jax is not None:
        check(abs(epe - epe_jax) <= EPE_TOL, f"{label}: EPE {epe} vs JAX {epe_jax}")
    return med, epe


def scale_counts(cfg):
    """Launches one call must make, whatever B is: K2 and K1 once per
    scale; K3 once per image (or stack of images) for up to four levels."""
    from dis_tpu_torch.ops.cuda.pyramid_kernel import MAX_LEVELS

    n = cfg.coarsest_scale - cfg.finest_scale + 1
    return {"K3": 2 * -(-(cfg.coarsest_scale + 1) // MAX_LEVELS), "K2": n, "K1": n}


def serve_child(artifact: str, out: str) -> int:
    """Phase 2h's fresh process: load the 1080p artifact and run it on
    ``bench.synth_pair()``, with the pipeline's functions replaced by ones
    that raise (the loaded program must not run them); save the flow to
    ``out`` and print one JSON line of times and launches."""
    from bench import synth_pair

    i1, i2 = synth_pair()
    t0 = time.perf_counter()
    import dis_tpu_torch.models.dis as pipeline
    from dis_tpu_torch import serving

    def refuse(*args, **kwargs):
        raise RuntimeError("the loaded program ran a pipeline function")

    pipeline._scale = pipeline.construct_pyramid = serving.dis_flow = refuse
    import_s = time.perf_counter() - t0
    run, _ = serving.load_exported(artifact)
    load_s = time.perf_counter() - t0 - import_s
    a, b = (torch.from_numpy(x).cuda() for x in (i1, i2))
    flow = run(a, b)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.save(flow.cpu(), out)
    print(json.dumps({"import_s": import_s, "load_s": load_s, "first_flow_s": first,
                      "replay_ms": time_ms(lambda: run(a, b), reps=10),
                      "launches": run.graph_launches}))
    return 0


def fresh_process(data: bytes):
    """Run the saved 1080p artifact ``data`` in a fresh process
    (:func:`serve_child`) and wait for it: its JSON line, its flow (on the
    CPU) and its wall seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "flow.pt2"), os.path.join(tmp, "flow.pt")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-child",
                               path, out], capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"serving child failed:\n{proc.stdout}{proc.stderr}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), torch.load(out), wall


def in_turns(fns, a, b, reps: int = 10):
    """Median ms of each of two flow executables on (a, b), timed in turns
    (first, second, second, first): {name: [ms, ms]}."""
    (n1, f1), (n2, f2) = fns.items()
    turns = {n1: [], n2: []}
    for name, fn in ((n1, f1), (n2, f2), (n2, f2), (n1, f1)):
        turns[name].append(time_ms(lambda: fn(a, b), reps=reps))
    return turns


SEQ_FRAMES = 9
# Mean EPE against the (3, 2) shift of the JAX package's CLI on CPU over the
# 8 pairs of write_sequence() (1920x1080, quantised to uint8) under the
# compat bench config: the mean of the "epe" records of
#   python3 -c "import chip_smoke as c; c.write_sequence('_seq')"
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#     from dis_tpu.cli import main; main(['_seq/frames', '1', '9', '16', '8',
#     '3', '0', '0.3', '1', '0', '--no-early-exit', '--gt-dir', '_seq/gt',
#     '--json-log', '_seq/jax.jsonl', '--out-dir', '_seq/OF'])"
# (102 s and 1.2 GiB on the CPU).  The port's CLI must land within EPE_TOL
# of it.
EPE_JAX_CLI = 0.15257339738309383


def sequence_frames(n: int, h: int, w: int):
    """n frames [h, w] uint8, made as ``bench.synth_pair`` makes its pair
    (a uniform random plane, seed 42, under a 7x7 box mean with a
    symmetric border), frame t shifted by SHIFT px from frame t - 1 and
    rounded to uint8."""
    from scipy.signal import convolve2d

    dx, dy = int(SHIFT[0]), int(SHIFT[1])
    m = 4
    r = np.random.default_rng(42)
    big = (r.random((h + dy * (n - 1) + 2 * m, w + dx * (n - 1) + 2 * m)) * 255
           ).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    out = []
    for t in range(n):
        y0, x0 = m + dy * (n - 1 - t), m + dx * (n - 1 - t)
        fr = big[y0:y0 + h, x0:x0 + w]
        out.append(np.clip(np.rint(fr), 0, 255).astype(np.uint8))
    return out


def write_sequence(root, n: int = SEQ_FRAMES, h: int = H, w: int = W) -> None:
    """``root/frames/frame_%04d.png`` (1-based) of :func:`sequence_frames`,
    written with the port's own ``imwrite``, and the ground truth of every
    pair, a uniform SHIFT, as ``root/gt/frame_%04d.flo``."""
    import os

    from dis_tpu_torch.utils.flo import save_flo
    from dis_tpu_torch.utils.io import imwrite

    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt"), exist_ok=True)
    for t, fr in enumerate(sequence_frames(n, h, w), start=1):
        imwrite(os.path.join(root, "frames", f"frame_{t:04d}.png"), fr)
    gt = np.broadcast_to(np.float32(SHIFT), (h, w, 2))
    for t in range(1, n):
        save_flo(os.path.join(root, "gt", f"frame_{t:04d}.flo"), gt)


def device_busy_ms(trace: dict) -> float:
    """Milliseconds in which the card ran a kernel, a copy or a fill, from
    a ``torch.profiler`` Chrome trace (the union of those events' spans)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def time_png_writers(root, flow) -> str:
    """The port's ``imwrite`` (Up-filtered rows, zlib level 1) against
    PIL's PNG encoder, where PIL is installed, on ``flow``'s colourised
    frame: the median ms of 5 writes each."""
    from dis_tpu_torch.utils.color import draw_optical_flow
    from dis_tpu_torch.utils.io import imwrite

    img = draw_optical_flow(flow)

    def ms(write):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            write()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    own = ms(lambda: imwrite(str(root / "writer_own.png"), img))
    try:
        from PIL import Image
    except ImportError:
        return f"port's writer {own:.3f} ms; PIL not installed"
    pil = ms(lambda: Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
             .save(str(root / "writer_pil.png")))
    return f"port's writer {own:.3f} ms, PIL {pil:.3f} ms ({pil / own:.2f}x)"


def run_cli(argv, timer=None):
    """``dis_tpu_torch.cli.main(argv)`` with its stdout captured; fails
    unless it exits 0.  Returns the stdout lines."""
    import contextlib
    import io

    from dis_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv], timer=timer)
    out = buf.getvalue().splitlines()
    check(rc == 0, f"CLI {argv} exited {rc}; stdout tail {out[-3:]}")
    return out


def cli_phase(dev, card, bench_cfg, wrappers):
    """Phase 4: the CLI and the runner on a 9-frame 1080p sequence (and a
    2-frame 4K one) in a temporary directory.  Returns the launches by
    kernel of the CLI's main-path runs (K2b/K1b: the ``--batch`` run)."""
    import os
    import tempfile
    from pathlib import Path

    import dis_tpu_torch as dt
    from dis_tpu_torch import serving
    from dis_tpu_torch.runner import run_sequence
    from dis_tpu_torch.utils import native
    from dis_tpu_torch.utils.flo import load_flo
    from dis_tpu_torch.utils.io import imread_gray
    from dis_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    built = native.available()
    print(f"phase4 native I/O library: {'built' if built else 'NOT built'} "
          f"({native.library_path().name}, {time.perf_counter() - t0:.2f} s)", flush=True)
    native.require()
    per_capture = serving.WARMUP_CALLS + 1     # eager warm-up calls and the capture
    launches = {k: 0 for k in ("K3", "K2", "K1", "K2b", "K1b", "K2c")}

    def counted(label, argv, want, timer=None, batched=False):
        """The CLI with every count set to 0 just before and read just after;
        a graph's kernels count at the warm-up and the capture, never at a
        replay, so ``want`` (one frame's launches) comes per_capture times.
        The counts join ``launches`` (K2 and K1 as K2b and K1b where
        ``batched``)."""
        for w in wrappers.values():
            w.launches = 0
        out = run_cli(argv, timer)
        counts = {k: w.launches for k, w in wrappers.items()}
        check(counts == {k: per_capture * v for k, v in want.items()},
              f"{label}: launches {counts}, want {per_capture} x {want}")
        for k, n in counts.items():
            launches[k + "b" if batched and k in ("K2", "K1") else k] += n
        print(f"phase4 {label}: launches {counts} = {per_capture} x {want} (warm-up and "
              f"capture; replays launch through the graph)", flush=True)
        return out

    with tempfile.TemporaryDirectory(prefix="dis_cli_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_sequence(root)
        print(f"phase4 wrote {SEQ_FRAMES} frames {W}x{H} and {SEQ_FRAMES - 1} .flo GT "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        frames = root / "frames"
        decoded = [torch.from_numpy(imread_gray(str(frames / f"frame_{t:04d}.png"))
                                    .astype(np.float32)).to(dev)
                   for t in range(1, SEQ_FRAMES + 1)]

        def eager(cfg, t):
            return dt.dis_flow(decoded[t - 1], decoded[t], cfg).cpu().numpy()

        def flows(out, pairs):
            return {t: load_flo(str(root / out / f"frame_{t:04d}.flo")) for t in pairs}

        pairs = range(1, SEQ_FRAMES)
        pos = [frames, 1, SEQ_FRAMES, 16, 8, 3, 0, 0.3, 1, 0]
        common = ["--no-early-exit", "--save-flo", "--device", "cuda"]
        want = {**scale_counts(bench_cfg), "K2c": 0}

        # The compat bench config over the 8 pairs.
        timer = PhaseTimer(device=dev)
        out = counted("CLI compat 8 pairs", pos + common + [
            "--gt-dir", root / "gt", "--json-log", root / "compat.jsonl",
            "--out-dir", root / "compat"], want, timer)
        names = sorted(p.name for p in (root / "compat").iterdir())
        check(names == sorted([f"frame_{t:04d}.{e}" for t in pairs for e in ("png", "flo")]),
              f"CLI compat wrote {names}")
        base = flows("compat", pairs)
        for t in pairs:
            check(np.array_equal(base[t], eager(bench_cfg, t)),
                  f"CLI compat pair {t}: .flo differs from the eager kernel path")
        recs = [json.loads(x) for x in (root / "compat.jsonl").read_text().splitlines()]
        check([r["frame"] for r in recs] == list(pairs) and all("epe" in r for r in recs),
              f"CLI compat JSON records {recs}")
        epe = float(np.mean([r["epe"] for r in recs]))
        print(f"phase4 CLI compat: 8 colourised PNGs and .flo files, each .flo bitwise equal "
              f"to the eager kernel path; mean EPE {epe} (JAX CLI on CPU {EPE_JAX_CLI}); "
              f"stdout: {out[-2:]}", flush=True)
        check(abs(epe - EPE_JAX_CLI) <= EPE_TOL, f"CLI EPE {epe} vs JAX {EPE_JAX_CLI}")
        fps_line = [x for x in out if "fps steady-state" in x]
        writer = time_png_writers(root, base[2])
        split = {}
        for r in timer.records:
            if r["frame"] != 1:       # steady state: the first pair captures the graph
                split[r["phase"]] = split.get(r["phase"], 0.0) + r["seconds"] / (SEQ_FRAMES - 2)
        total = sum(split.values())
        print(f"phase4 CLI steady state: {fps_line}; per pair (pairs 2-8, PhaseTimer) "
              + ", ".join(f"{k} {v * 1e3:.3f} ms ({100 * v / total:.1f}%)"
                          for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
              + f"; sum {total * 1e3:.3f} ms ({1.0 / total:.2f} pairs/s) [{card}]", flush=True)
        print(f"phase4 1080p colour PNG, median of 5 writes: {writer} [{card}]", flush=True)

        # --batch 4: two chunks through one batched graph (K2b, K1b).
        counted("CLI compat --batch 4", pos + common + [
            "--batch", 4, "--out-dir", root / "batch"], want, batched=True)
        got = flows("batch", pairs)
        check(all(np.array_equal(got[t], base[t]) for t in pairs),
              "CLI --batch 4 differs from the serial run")
        print("phase4 CLI --batch 4: 8 flows bitwise equal to the serial run", flush=True)

        # --preset medium on 2 pairs.
        med = dt.DIS_MEDIUM
        counted("CLI --preset medium 2 pairs", [frames, 1, 3, "--preset", "medium", "--save-flo",
                                                "--device", "cuda", "--out-dir", root / "medium"],
                {**scale_counts(med), "K2c": 0})
        got = flows("medium", (1, 2))
        check(all(np.array_equal(got[t], eager(med, t)) for t in (1, 2)),
              "CLI --preset medium differs from the eager kernel path")
        print("phase4 CLI --preset medium: 2 flows bitwise equal to the eager kernel path",
              flush=True)

        # draw_grid = 1, DIS_TPU_CHECK=1 and --profile-dir: eager, same bits.
        two = [frames, 1, 3, 16, 8, 3, 0, 0.3, 1]
        run_cli(two + [1] + common + ["--out-dir", root / "grid"])
        names = {p.name for p in (root / "grid").iterdir()}
        grids = {f"frame_{t:04d}_grid_s{sc}.png" for t in (1, 2) for sc in range(4)}
        check(grids <= names, f"draw_grid: overlays missing: {sorted(grids - names)}")
        os.environ["DIS_TPU_CHECK"] = "1"
        try:
            run_cli(two + [0] + common + ["--out-dir", root / "checked"])
        finally:
            del os.environ["DIS_TPU_CHECK"]
        run_cli(two + [0] + common + ["--out-dir", root / "prof", "--profile-dir",
                                      root / "trace"])
        for out in ("grid", "checked", "prof"):
            got = flows(out, (1, 2))
            check(all(np.array_equal(got[t], base[t]) for t in (1, 2)),
                  f"CLI {out}: flow differs from the run without it")
        traces = list((root / "trace").glob("*.json"))
        text = "".join(x.read_text() for x in traces)
        check(len(traces) == 1 and '"pyramid"' in text and '"scale_0"' in text,
              f"--profile-dir: {len(traces)} traces, stage names missing")
        busy = device_busy_ms(json.loads(text)) / 2
        print(f"phase4 CLI draw_grid = 1 ({len(grids)} overlays), DIS_TPU_CHECK=1 (guards "
              f"pass) and --profile-dir (a {len(text) / 2 ** 20:.1f} MiB trace naming "
              f"pyramid and scale_0): 2 flows each bitwise equal to the plain run", flush=True)
        print(f"phase4 card busy a pair (kernels, copies and fills of the --profile-dir "
              f"trace, eager, 2 pairs): {busy:.3f} ms; against the steady serial pair's "
              f"{total * 1e3:.3f} ms the card is {100 * (1 - busy / (total * 1e3)):.2f}% idle "
              f"[{card}]", flush=True)

        # The runner: stopped after pair 4, resumed at 5, equal to a fresh run.
        class Stop(Exception):
            pass

        def stop_after_4(i, flow):
            if i == 4:
                raise Stop()

        kw = dict(save_flo=True, device=dev)
        try:
            run_sequence(str(frames), 1, SEQ_FRAMES, bench_cfg, out_dir=str(root / "run"),
                         ckpt_dir=str(root / "ck"), on_pair=stop_after_4, **kw)
        except Stop:
            pass
        else:
            check(False, "runner: on_pair did not stop the run")
        resumed = run_sequence(str(frames), 1, SEQ_FRAMES, bench_cfg, out_dir=str(root / "run"),
                               ckpt_dir=str(root / "ck"), **kw)
        fresh = run_sequence(str(frames), 1, SEQ_FRAMES, bench_cfg,
                             out_dir=str(root / "fresh"), **kw)
        check((resumed["resumed_from"], resumed["pairs_done"]) == (5, 4)
              and fresh["pairs_done"] == 8, f"runner: resumed {resumed}, fresh {fresh}")
        a, b = flows("run", pairs), flows("fresh", pairs)
        check(all(np.array_equal(a[t], b[t]) and np.array_equal(a[t], base[t]) for t in pairs),
              "runner: the resumed run differs from a fresh run or from the CLI")
        print(f"phase4 runner: stopped after pair 4, resumed from {resumed['resumed_from']} "
              f"({resumed['pairs_done']} pairs); 8 flows bitwise equal to a fresh run and to "
              f"the CLI's; fresh run {fresh['mean_seconds'] * 1e3:.3f} ms a pair [{card}]",
              flush=True)
        del decoded

        # 4K: one pair through the CLI, K2c at the finest scale.
        root4 = root / "4k"
        write_sequence(root4, 2, H4K, W4K)
        counted("CLI compat 4K 1 pair", [root4 / "frames", 1, 2, 16, 8, 3, 0, 0.3, 1, 0]
                + common + ["--out-dir", root4 / "out"], {"K3": 2, "K2": 3, "K2c": 1, "K1": 4})
        a4, b4 = (torch.from_numpy(imread_gray(str(root4 / "frames" / f"frame_{t:04d}.png"))
                                   .astype(np.float32)).to(dev) for t in (1, 2))
        check(np.array_equal(load_flo(str(root4 / "out" / "frame_0001.flo")),
                             dt.dis_flow(a4, b4, bench_cfg).cpu().numpy()),
              "CLI 4K: .flo differs from the eager kernel path")
        print("phase4 CLI 4K: the flow bitwise equal to the eager kernel path", flush=True)
    return launches


def part_routes(cfg, width, height, n, i, halo=None):
    """The extraction kernel ("K2" or "K2c") of each scale, finest first,
    that rank i of n launches: on its stripe of ``tiled_flow_fn`` with
    ``halo``, or (``halo`` None) on its windows of ``grid_tiled_flow_fn``,
    read from the same static shapes as ``ops/iclk.py::inverse_search``."""
    from dis_tpu_torch.models.dis import _stripe_plan, init_bound, window_patch_rows
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops.grid import make_grid
    from dis_tpu_torch.parallel import stripe_bounds, window_partition

    p = cfg.img_padding
    if halo is not None:
        row0, ext_h, own_r0, own_h = stripe_bounds(cfg, height, n, i, halo)
        iy = _stripe_plan(cfg, height, own_r0, own_h)[0]
    else:
        ext_h = height
        iy = {s: window_patch_rows(cfg, height >> s, *window_partition(height >> s, n)[i])
              for s in range(cfg.finest_scale, cfg.coarsest_scale + 1)}
    return [iclk.extraction_route(
        cfg, ((ext_h >> s) + 2 * p, (width >> s) + 2 * p),
        make_grid(width >> s, height >> s, cfg.steps).num_w * (iy[s][1] - iy[s][0]),
        init_bound(cfg, s)) for s in range(cfg.finest_scale, cfg.coarsest_scale + 1)]


def phase5_rank(dev, inputs_path: str, steps) -> dict:
    """One rank of phase 5 (``parallel.launch.spawn``, gloo, every rank on
    card 0): each step ``(label, kind, cfg, n, keys)`` of ``steps`` on a
    mesh of the first n ranks, once with the kernel counts set to 0 just
    before and read just after, then once more timed between two
    barriers, which must give the same bits.  Returns by label this
    rank's output on the CPU, its launches, the bytes ``shift`` staged
    through the host and the timed call's ms."""
    import torch.distributed as dist

    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_levels
    from dis_tpu_torch.parallel import (batch_sharding, batched_flow_epe_fn, make_mesh,
                                        row_sharding, sequence_flow_fn,
                                        sequence_pair_flow_fn, tiled_flow_fn)
    from dis_tpu_torch.parallel.mesh import shift

    wrappers = {"K3": pyramid_levels, "K2": extract_regions, "K2c": extract_regions_banded,
                "K1": iclk_search}
    x = torch.load(inputs_path, map_location="cpu")
    rank = dist.get_rank()
    out = {}
    for label, kind, cfg, n, keys in steps:
        axes = {"tiled": ("batch", "space"), "batch": ("batch",)}.get(kind, ("seq",))
        mesh = make_mesh((1, n) if kind == "tiled" else (n,), axes, device_type=dev.type)
        if rank >= n:
            continue
        group = mesh.get_group(axes[-1])
        t = [x[k] for k in keys]
        if kind == "tiled":
            h, w = t[0].shape
            fn = tiled_flow_fn(cfg, mesh, h, w)
            args = [row_sharding(mesh, v).to(dev) for v in t]
        elif kind == "seq_pair":
            clip = t[0].to(torch.float32)
            fn = sequence_pair_flow_fn(cfg, mesh)
            args = [batch_sharding(mesh, clip[:-1], "seq").to(dev), clip[-1].to(dev)]
        elif kind == "seq_frame":
            fn = sequence_flow_fn(cfg, mesh)
            args = [batch_sharding(mesh, t[0][:-1].to(torch.float32), "seq").to(dev)]
        else:
            fn = batched_flow_epe_fn(cfg, mesh)
            args = [batch_sharding(mesh, v).to(dev) for v in t]
        for w in wrappers.values():
            w.launches = 0
        shift.staged_bytes = 0
        first = fn(*args)
        torch.cuda.synchronize(dev)
        counts = {k: w.launches for k, w in wrappers.items()}
        staged = shift.staged_bytes
        dist.barrier(group)
        t0 = time.perf_counter()
        again = fn(*args)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        dist.barrier(group)
        first, again = (r if isinstance(r, tuple) else (r,) for r in (first, again))
        check(all(torch.equal(p, q) for p, q in zip(first, again)),
              f"rank {rank} {label}: a second call gave other bits")
        out[label] = {"out": [r.cpu() for r in first], "counts": counts, "staged": staged,
                      "ms": ms}
    return out


def shard_host(host_id: int, die_after: int, root: str, cfg, device) -> None:
    """Host ``host_id`` of 2 in phase 5f: its shard of pairs [1,
    SEQ_FRAMES) of ``root/frames`` through ``run_sequence_shard`` on
    ``device``, with no master address (the shards need no collective); exits with
    code 17 after ``die_after`` pairs (0: never), as a preempted host, and
    otherwise writes its summary to ``root/host{id}.json``."""
    from dis_tpu_torch.parallel.distributed import run_sequence_shard

    os.environ.update(RANK=str(host_id), WORLD_SIZE="2")
    os.environ.pop("MASTER_ADDR", None)
    done = []

    def on_pair(i, flow):
        done.append(i)
        if die_after and len(done) >= die_after:
            os._exit(17)

    summary = run_sequence_shard(os.path.join(root, "frames"), 1, SEQ_FRAMES, cfg,
                                 os.path.join(root, "ck"), out_dir=os.path.join(root, "out"),
                                 save_flo=True, on_pair=on_pair, device=device)
    with open(os.path.join(root, f"host{host_id}.json"), "w") as f:
        json.dump(summary, f)


def multi_rank_phase(dev, card, bench_cfg, ref) -> dict:
    """Phase 5: the multi-rank engines on the card, every rank a process
    on card 0 with gloo (NCCL refuses two ranks on one card), each
    result bitwise equal to the single-device flow it splits.  ``ref``
    holds the inputs and flows of the earlier phases.  Returns the
    launches by kernel of the ranks' first calls and of 5e (K2b and K1b:
    the batched ones)."""
    import multiprocessing
    import socket
    from pathlib import Path

    import torch.distributed as dist

    import dis_tpu_torch as dt
    from dis_tpu_torch.dryrun import dryrun_multichip
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_levels
    from dis_tpu_torch.parallel import (batched_flow_epe_fn, make_mesh, min_stripe_halo,
                                        tiled_flow_fn)
    from dis_tpu_torch.parallel.batch import _pair_epes
    from dis_tpu_torch.parallel.distributed import init_multi_host
    from dis_tpu_torch.parallel.launch import spawn
    from dis_tpu_torch.parallel.mesh import shift
    from dis_tpu_torch.utils.flo import load_flo
    from dis_tpu_torch.utils.io import imread_gray
    from dis_tpu_torch.utils.metrics import epe_torch

    wrappers = {"K3": pyramid_levels, "K2": extract_regions, "K2c": extract_regions_banded,
                "K1": iclk_search}
    launches = {k: 0 for k in ("K3", "K2", "K1", "K2b", "K1b", "K2c")}

    def add(counts, batched):
        for k, v in counts.items():
            launches[k + "b" if batched and k in ("K2", "K1") else k] += v

    t_phase = time.perf_counter()
    cfg3, med = ref["cfg3"], dt.DIS_MEDIUM
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dis_ranks_") as tmp:
        root = Path(tmp)
        write_sequence(root)
        decoded = [torch.from_numpy(imread_gray(str(root / "frames" / f"frame_{t:04d}.png")))
                   for t in range(1, SEQ_FRAMES + 1)]
        clip = torch.stack(decoded)
        serial = [dt.dis_flow(clip[t].to(dev, torch.float32), clip[t + 1].to(dev, torch.float32),
                              bench_cfg).cpu() for t in range(SEQ_FRAMES - 1)]
        kgt = torch.tensor([[float(sx), float(sy)] for sx, sy in KITTI_SHIFTS], device=dev)[
            :, None, None, :].expand(len(KITTI_SHIFTS), *ref["kpad"][0].shape[-2:], 2).contiguous()
        inputs = str(root / "inputs.pt")
        torch.save({"a4": ref["a4"].cpu(), "b4": ref["b4"].cpu(), "a": ref["a"].cpu(),
                    "b": ref["b"].cpu(), "clip": clip, "ka": ref["kpad"][0].cpu(),
                    "kb": ref["kpad"][1].cpu(), "kgt": kgt.cpu()}, inputs)
        halos = {n: min_stripe_halo(bench_cfg, W4K, H4K, n) for n in (2, 3)}
        check(halos[3] == 176, f"4K 3-way halo {halos[3]}")
        steps = [("5a 4K compat n=2", "tiled", bench_cfg, 2, ("a4", "b4")),
                 ("5a 4K compat n=3", "tiled", bench_cfg, 3, ("a4", "b4")),
                 ("5b 1080p medium n=3", "tiled", med, 3, ("a", "b")),
                 ("5c sequence pairs n=2", "seq_pair", bench_cfg, 2, ("clip",)),
                 ("5c sequence frames n=2", "seq_frame", bench_cfg, 2, ("clip",)),
                 ("5d KITTI batch n=2", "batch", cfg3, 2, ("ka", "kb", "kgt"))]
        t0 = time.perf_counter()
        res = spawn(3, phase5_rank, inputs, steps, device="cuda:0", timeout_s=120)
        print(f"phase5 3 ranks on cuda:0 (gloo): {len(steps)} steps in "
              f"{time.perf_counter() - t0:.2f} s, process start included", flush=True)
        single_epe = batched_flow_epe_fn(cfg3)(*ref["kpad"], kgt)
        wants = {
            "5a 4K compat n=2": ref["flow4"], "5a 4K compat n=3": ref["flow4"],
            "5b 1080p medium n=3": ref["medium"],
            "5c sequence pairs n=2": torch.stack(serial),
            "5c sequence frames n=2": torch.stack(serial[:-1] + [torch.zeros_like(serial[0])]),
        }
        for label, kind, cfg, n, _ in steps:
            got = [res[r][label] for r in range(n)]
            if kind == "tiled":
                halo = halos[n] if cfg is bench_cfg else None
                hh, ww = (H4K, W4K) if cfg is bench_cfg else (H, W)
                routes = [part_routes(cfg, ww, hh, n, i, halo) for i in range(n)]
                expect = [{"K3": 2, "K2": r.count("K2"), "K2c": r.count("K2c"), "K1": len(r)}
                          for r in routes]
            else:
                expect = [{**scale_counts(cfg), "K2c": 0}] * n
            for i, g in enumerate(got):
                check(g["counts"] == expect[i], f"{label} rank {i}: launches {g['counts']}, "
                      f"want {expect[i]}")
                add(g["counts"], kind != "tiled")
            flows = torch.cat([g["out"][0] for g in got])
            if kind == "batch":
                check(torch.equal(im.crop_padding(flows, ref["kpw"], ref["kph"], KW, KH),
                                  ref["kitti"].cpu()), f"{label}: flows differ from phase 2b's")
                check(torch.equal(flows, single_epe[0].cpu()), f"{label}: flows differ from "
                      "the single-device batched_flow_epe_fn")
                for i, g in enumerate(got):
                    check(torch.equal(g["out"][1], single_epe[1].cpu()),
                          f"{label} rank {i}: mean EPE {g['out'][1]} vs {single_epe[1]}")
            else:
                check(torch.equal(flows, wants[label].cpu()), f"{label}: the stitched flow "
                      "differs from the single-device flow")
            print(f"phase5 {label}: launches by rank {[g['counts'] for g in got]}; bytes "
                  f"staged through the host by rank {[g['staged'] for g in got]}; bitwise "
                  f"equal to the single-device flow"
                  + (f", mean EPE {float(single_epe[1])} on every rank" if kind == "batch"
                     else "")
                  + f"; a call's ms by rank {[round(g['ms'], 3) for g in got]} ({n} ranks "
                  f"sharing one H100, not a scaling figure) [{card}]", flush=True)

        # Why the mean EPE reduces each pair alone: on the card one reduction
        # over a stack of pairs may give a pair other bits than one over half
        # the stack, as the batch mesh's ranks would.  A reading, not a gate.
        fk1, half = single_epe[0], len(KITTI_SHIFTS) // 2
        whole = epe_torch(fk1, kgt)
        halves = torch.cat([epe_torch(fk1[i:i + half], kgt[i:i + half]) for i in (0, half)])
        alone_ms = time_ms(lambda: _pair_epes(fk1, kgt).mean())
        stack_ms = time_ms(lambda: epe_torch(fk1, kgt).mean())
        print(f"phase5 5d EPE forms: one reduction over the {len(KITTI_SHIFTS)} pairs' "
              f"flows against one over each {half}: per-pair EPEs "
              f"{'equal' if torch.equal(whole, halves) else 'differ'} (max |d| "
              f"{float((whole - halves).abs().max())}); each pair reduced alone "
              f"(batched_flow_epe_fn) {alone_ms:.4f} ms, one reduction over the stack "
              f"{stack_ms:.4f} ms, eager [{card}]", flush=True)

        # 5e: NCCL moves CUDA tensors directly; at world size 1 (one card).
        keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
        saved = {k: os.environ.get(k) for k in keys}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                          RANK="0", LOCAL_RANK="0")
        try:
            d = init_multi_host(backend="nccl")
            check(d == dev and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                  f"NCCL group: {d}, {dist.get_backend()}, {dist.get_world_size()}")
            shift.staged_bytes = 0
            counts = {}

            def counted(label, cfg, batched, fn, *args):
                # This call's launches alone: the counts start at 0 here.
                for w in wrappers.values():
                    w.launches = 0
                out = fn(*args)
                torch.cuda.synchronize()
                counts[label] = {k: w.launches for k, w in wrappers.items()}
                want = {**scale_counts(cfg), "K2c": 0}
                check(counts[label] == want, f"5e {label}: launches {counts[label]}, "
                      f"want {want}")
                add(counts[label], batched)
                return out

            flow = counted("tiled", bench_cfg, False,
                           tiled_flow_fn(bench_cfg, make_mesh((1, 1)), H, W), ref["a"], ref["b"])
            fk, mean = counted("batch", cfg3, True,
                               batched_flow_epe_fn(cfg3, make_mesh((1,), ("batch",))),
                               *ref["kpad"], kgt)
            check(torch.equal(flow, ref["flow1080"]), "5e: NCCL tiled flow differs")
            check(torch.equal(fk, single_epe[0]) and torch.equal(mean, single_epe[1]),
                  "5e: NCCL batch differs")
            check(shift.staged_bytes == 0, f"5e: NCCL staged {shift.staged_bytes} bytes")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(f"phase5 5e NCCL at world size 1 on {dev}: tiled_flow_fn n=1 (1080p compat) "
              f"and the KITTI batch mesh n=1 (EPE gathered by NCCL) bitwise equal to the "
              f"single-device flows; launches {counts}; 0 bytes staged", flush=True)

        # 5f: two hosts shard the sequence; host 1 is killed after one pair
        # and relaunched with the same arguments.
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")

        def host(host_id, die_after):
            p = ctx.Process(target=shard_host,
                            args=(host_id, die_after, str(root), bench_cfg, "cuda:0"))
            p.start()
            return p

        h0, h1 = host(0, 0), host(1, 1)
        for p in (h0, h1):
            p.join(timeout=300)
        check((h0.exitcode, h1.exitcode) == (0, 17), f"5f: exit codes {h0.exitcode}, "
              f"{h1.exitcode} (want 0 and 17)")
        h1 = host(1, 0)
        h1.join(timeout=300)
        check(h1.exitcode == 0, f"5f: relaunched host 1 exited {h1.exitcode}")
        s0, s1 = (json.loads((root / f"host{i}.json").read_text()) for i in (0, 1))
        check((s0["shard"], s0["pairs_done"]) == ([1, 5], 4)
              and (s1["shard"], s1["resumed_from"], s1["pairs_done"]) == ([5, 9], 6, 3),
              f"5f: summaries {s0}, {s1}")
        for t in range(1, SEQ_FRAMES):
            got = load_flo(str(root / "out" / f"frame_{t:04d}.flo"))
            check(np.array_equal(got, serial[t - 1].numpy()),
                  f"5f: pair {t} differs from the serial flow")
        print(f"phase5 5f run_sequence_shard: host 0 shard {s0['shard']}, host 1 killed after "
              f"one pair and resumed from {s1['resumed_from']}; 8 .flo files bitwise equal to "
              f"the serial flows ({time.perf_counter() - t0:.2f} s)", flush=True)

    # 5g: the dry run over 4 ranks on card 0.
    t0 = time.perf_counter()
    dryrun_multichip(4, device="cuda:0")
    print(f"phase5 5g dryrun_multichip(4) on cuda:0: {time.perf_counter() - t0:.2f} s",
          flush=True)
    print(f"phase5 took {time.perf_counter() - t_phase:.2f} s [{card}]", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build, cost
    from dis_tpu_torch.models.dis import (_stripe_plan, dis_flow_padded, init_bound,
                                          scale_extraction_route)
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level, pyramid_levels
    from dis_tpu_torch.ops.grid import init_from_coarser_flow, make_grid, scale_plan
    from dis_tpu_torch.ops.pyramid import construct_pyramid
    from dis_tpu_torch.ops.variational import variational_refinement
    from dis_tpu_torch.parallel import (batched_flow_fn, grid_tiled_flow, min_stripe_halo,
                                        stripe_bounds, tiled_flow_exact)
    from dis_tpu_torch.serving import aot_compile, export_flow, load_exported

    # -- phase 0: device, versions, build ---------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}",
          flush=True)

    i1, i2 = synth_pair()
    a = torch.from_numpy(i1).to(dev)
    b = torch.from_numpy(i2).to(dev)
    bench_cfg = dt.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                             finest_scale=0, patch_overlap=0.3,
                             patch_normalization=True, mode="compat",
                             early_exit=False)
    configs = {"compat": bench_cfg, "fast": dt.DIS_FAST}
    p = bench_cfg.img_padding
    rng = np.random.default_rng(0)

    # -- phase 1: kernels vs plain versions --------------------------------
    def k3_check(label, img):
        """One K3 launch builds the 4-level pyramid of img, bitwise equal to
        the plain level chain; returns the max abs error."""
        before = pyramid_levels.launches
        kern = construct_pyramid(img, bench_cfg.coarsest_scale, p)
        check(pyramid_levels.launches == before + 1, f"K3 {label}: not one launch")
        ref = construct_pyramid(img, bench_cfg.coarsest_scale, p, plain=True)
        torch.cuda.synchronize()
        err = 0.0
        for s, (kl, rl) in enumerate(zip(kern, ref)):
            for kp, rp in zip(kl[:3], rl[:3]):
                err = max(err, float((kp - rp).abs().max()))
                check(torch.equal(kp, rp), f"K3 {label} level {s} differs from the plain chain")
        print(f"phase1 K3 {label}: {len(kern)} levels in one launch, bitwise equal to the "
              f"plain chain; max_abs_err {err}", flush=True)
        return err

    k3_err = max(k3_check("1080p image 1", a), k3_check("1080p image 2", b))

    # The finest scale's real inputs: coarser scales through the port.
    finest = {}
    k1_err, k2_err = 0.0, 0.0
    for name, cfg in configs.items():
        finest[name] = finest_inputs(a, b, cfg, p)
        _, l2, tpl, Tn, centers, init_u, pos0, conv0 = finest[name]

        kr = extract_regions(l2.img, pos0, cfg.patch_size, p)
        kg = extract_regions(l2.img, pos0, cfg.patch_size, p, num_h=num_h_of(l2, cfg))
        pr = iclk.extract_regions_plain(l2.img, pos0, cfg.patch_size, p)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((kr[0] - pr[0]).abs().max()),
                     float((kg[0] - pr[0]).abs().max()))
        for kt, gt, pt in zip(kr, kg, pr):
            check(torch.equal(kt, pt) and torch.equal(gt, pt),
                  f"K2 {name} N={pos0.shape[0]} differs")
        args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
        kout = iclk_search(*kr, *args)
        pout = iclk.iclk_search_plain(*pr, *args)
        torch.cuda.synchronize()
        err, flips = search_gate(f"K1 {name}", kout, pout)
        k1_err = max(k1_err, err)
        print(f"phase1 {name} finest N={pos0.shape[0]}: K2 (consecutive and column "
              f"groups) and K1 bitwise (K1 max|du| {err} flips {flips})", flush=True)

    empty = torch.zeros((0, 2), dtype=torch.float32, device=dev)
    l2_img = finest["compat"][1].img
    kr = extract_regions(l2_img, empty, 8, p)
    pr = iclk.extract_regions_plain(l2_img, empty, 8, p)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(kr, pr))
          and tuple(kr[0].shape) == (0, 19, 19), "K2 at N = 0")
    print("phase1 K2 N=0 ok", flush=True)

    # K1/K2 at every supported preset patch size on a small plane.
    small = torch.from_numpy(np.ascontiguousarray(i1[:96, :128])).to(dev)
    for ps in (8, 10, 12, 16):
        for mode in ("compat", "fixed"):
            cfg = dt.DISConfig(iterations=12, patch_size=ps, coarsest_scale=0,
                               patch_overlap=0.5, mode=mode)
            lvl = pyramid_level(small, ps, base=True)
            hh, ww = lvl[0].shape[0] - 2 * ps, lvl[0].shape[1] - 2 * ps
            geom = make_grid(ww, hh, cfg.steps)
            centers = torch.from_numpy(geom.centers).to(dev)
            tpl = iclk.extract_templates_grid(*lvl, geom, ps, ps)
            init_u = torch.from_numpy(rng.uniform(-2, 2, geom.centers.shape)
                                      .astype(np.float32)).to(dev)
            pos0 = centers + init_u
            # Random start freezes on top of the out-of-bounds ones: the
            # patches of one warp freeze at different trips.
            conv0 = iclk.out_of_bounds(pos0, ps, ww, hh) | torch.from_numpy(
                rng.random(geom.centers.shape[0]) < 0.2).to(dev)
            Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
            kr = extract_regions(lvl[0], pos0, ps, ps)
            pr = iclk.extract_regions_plain(lvl[0], pos0, ps, ps)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kr, pr)), f"K2 ps={ps}")
            args = (tpl, Tn, centers, init_u, conv0, cfg, ww, hh)
            trips = []
            pout = iclk.iclk_search_plain(*pr, *args, trips=trips)
            kout = iclk_search(*kr, *args)
            torch.cuda.synchronize()
            err, flips = search_gate(f"K1 ps={ps} {mode}", kout, pout)
            print(f"phase1 ps={ps} {mode} N={pos0.shape[0]}: K2 and K1 bitwise (K1 "
                  f"max|du| {err} flips {flips}; active patches by trip {trips})", flush=True)

    # -- phase 1b: K2b and K1b at the KITTI B = 8 finest-scale shapes --------
    kpairs = [kitti_pair(i) for i in range(len(KITTI_SHIFTS))]
    ka = torch.from_numpy(np.stack([q[0] for q in kpairs])).to(dev)
    kb = torch.from_numpy(np.stack([q[1] for q in kpairs])).to(dev)
    nk = ka.shape[0]
    cfg3 = dt.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                        finest_scale=0, patch_overlap=0.3,
                        patch_normalization=True, mode="compat", early_exit=False)
    kitti_cfgs = {"config3": cfg3, "ultrafast": dt.DIS_ULTRAFAST}
    (kpad_a, (kpw, kph)), (kpad_b, _) = (im.pad_divisible(t, cfg3.coarsest_scale)
                                         for t in (ka, kb))
    kpad = (kpad_a, kpad_b)
    kfinest = {}
    k2b_err, k1b_err = 0.0, 0.0
    for name, cfg in kitti_cfgs.items():
        kfinest[name] = finest_inputs(*kpad, cfg, p)
        _, l2, tpl, Tn, centers, init_u, pos0, conv0 = kfinest[name]
        ps = cfg.patch_size
        extract_regions.launches = iclk_search.launches = 0
        kr = extract_regions(l2.img, pos0, ps, p, num_h=num_h_of(l2, cfg))
        args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
        ko = iclk_search(*kr, *args)
        check(extract_regions.launches == 1 and iclk_search.launches == 1,
              f"K2b/K1b {name}: not one launch each for the batch")
        pr = iclk.extract_regions_plain(l2.img, pos0, ps, p)
        po = iclk.iclk_search_plain(*pr, *args)
        kc = extract_regions(l2.img, pos0, ps, p)
        torch.cuda.synchronize()
        k2b_err = max(k2b_err, float((kr[0] - pr[0]).abs().max()))
        for kt, pt in zip(kc, pr):
            check(torch.equal(kt, pt), f"K2b {name}: consecutive groups differ")
        k1b_err = max(k1b_err, float((ko[0] - po[0]).abs().max()))
        for kt, pt in zip(kr + ko, pr + po):
            check(torch.equal(kt, pt), f"K2b/K1b {name}: differs from the batched plain version")
        for i in range(nk):
            sr = extract_regions(l2.img[i], pos0[i], ps, p)
            so = iclk_search(*sr, iclk.PatchTemplates(*(t[i] for t in tpl)),
                             None if Tn is None else Tn[i], centers, init_u[i],
                             conv0[i], cfg, l2.width, l2.height)
            torch.cuda.synchronize()
            for kt, st in zip(kr + ko, sr + so):
                check(torch.equal(kt[i], st), f"K2b/K1b {name}: pair {i} differs from serial K2/K1")
        print(f"phase1b {name} B={nk} N={pos0.shape[1]} ({nk * pos0.shape[1]} patches, "
              f"scale {cfg.finest_scale}): K2b and K1b bitwise equal to their batched "
              f"plain versions and to {nk} serial K2/K1 calls", flush=True)

    # -- phase 1c: K2c at the 4K finest-scale shapes -------------------------
    t0 = time.perf_counter()
    a4, b4 = (torch.from_numpy(q).to(dev) for q in synth_pair_4k())
    print(f"phase1c 4K pair made in {time.perf_counter() - t0:.2f} s", flush=True)
    k3_err = max(k3_err, k3_check("4K image 1", a4))
    route4 = [scale_extraction_route(bench_cfg, W4K, H4K, s)
              for s in range(bench_cfg.coarsest_scale + 1)]
    check(route4 == ["K2c", "K2", "K2", "K2"], f"4K routes by scale {route4}")
    bound0 = init_bound(bench_cfg, 0)

    def k2c_check(label, img, pos0, ps, pad, geom, bnd, row0=0, phase="1c"):
        """K2c bitwise equal to its plain version and to K2 (consecutive
        and column groups), in one launch; prints the share of windows
        copied from device memory instead of the staged box; returns
        (regions, bases) and the max abs error."""
        outside = torch.zeros(1, dtype=torch.int32, device=dev)
        before = extract_regions_banded.launches
        kc = extract_regions_banded(img, pos0, ps, pad, geom, bnd, row0, outside)
        check(extract_regions_banded.launches == before + 1, f"K2c {label}: not one launch")
        k2 = extract_regions(img, pos0, ps, pad, row0)
        kg = extract_regions(img, pos0, ps, pad, row0, num_h=geom.num_h)
        pr = iclk.extract_regions_plain(img, pos0, ps, pad, row0)
        torch.cuda.synchronize()
        err = float((kc[0] - pr[0]).abs().max()) if kc[0].numel() else 0.0
        for kt, k2t, kgt, pt in zip(kc, k2, kg, pr):
            check(torch.equal(kt, pt) and torch.equal(kt, k2t) and torch.equal(kgt, pt),
                  f"K2c {label}: differs from its plain version or from K2")
        n = pos0.numel() // 2
        print(f"phase{phase} K2c {label}: {tuple(pos0.shape[:-1])} patches bitwise equal to "
              f"plain and K2; windows copied from device memory: {int(outside)} "
              f"({int(outside) / max(n, 1):.6f} of {n})", flush=True)
        return kc, err

    f4 = finest_inputs(a4, b4, bench_cfg, p)
    _, l2_4, tpl4, Tn4, centers4, init4, pos04, conv04 = f4
    geom4 = make_grid(l2_4.width, l2_4.height, bench_cfg.steps)
    check(pos04.shape[0] == 331_776, f"4K finest N = {pos04.shape[0]}")
    kc4, k2c_err = k2c_check("4K B=1", l2_4.img, pos04, 8, p, geom4, bound0)

    fb4 = finest_inputs(torch.stack([a4, b4]), torch.stack([b4, a4]), bench_cfg, p)
    _, err = k2c_check("4K B=2", fb4[1].img, fb4[6], 8, p, geom4, bound0)
    k2c_err = max(k2c_err, err)
    del fb4

    # Stripe 1 of 3: the full frame's finest plane cut to the stripe's rows
    # (its row0 moves the y bases), its patch rows, and K1 with row0 > 0.
    halo = min_stripe_halo(bench_cfg, W4K, H4K, N_STRIPES)
    row0, ext_h, own_r0, own_h = stripe_bounds(bench_cfg, H4K, N_STRIPES, 1, halo)
    check(halo == 176 and row0 == 544, f"stripe 1 of 3: halo {halo}, row0 {row0}")
    iy0, iy1 = _stripe_plan(bench_cfg, H4K, own_r0, own_h)[0][0]
    geom_s = make_grid(W4K, H4K, bench_cfg.steps, iy_range=(iy0, iy1))

    def rows_of(t):
        return t.reshape(geom4.num_w, geom4.num_h, *t.shape[1:])[:, iy0:iy1].reshape(
            -1, *t.shape[1:])

    plane_s = l2_4.img[row0:row0 + ext_h + 2 * p].contiguous()
    kc_s, err = k2c_check(f"stripe 1 of {N_STRIPES} (row0 {row0})", plane_s, rows_of(pos04),
                          8, p, geom_s, bound0, row0)
    k2c_err = max(k2c_err, err)
    args_s = (iclk.PatchTemplates(*(rows_of(t) for t in tpl4)), None, rows_of(centers4),
              rows_of(init4), rows_of(conv04), bench_cfg, W4K, H4K, row0)
    ks = iclk_search(*kc_s, *args_s)
    ps_ = iclk.iclk_search_plain(*kc_s, *args_s)
    kfull = iclk_search(*kc4, tpl4, Tn4, centers4, init4, conv04, bench_cfg, W4K, H4K)
    torch.cuda.synchronize()
    err, flips = search_gate("K1 stripe row0", ks, ps_)
    k1_err = max(k1_err, err)
    for kt, ft in zip(ks, kfull):
        check(torch.equal(kt, rows_of(ft)), "K1 on the stripe differs from the full frame's rows")
    print(f"phase1c K1 stripe row0 {row0} N={ks[0].shape[0]}: bitwise equal to its plain "
          f"version (max|du| {err} flips {flips}) and to the full frame's rows", flush=True)

    lvl12 = pyramid_level(small, 12, base=True)
    hh, ww = lvl12[0].shape[0] - 24, lvl12[0].shape[1] - 24
    geom12 = make_grid(ww, hh, 6)
    init12 = torch.from_numpy(rng.uniform(-12, 12, geom12.centers.shape)
                              .astype(np.float32)).to(dev)
    _, err = k2c_check("ps 12 small plane", lvl12[0],
                       torch.from_numpy(geom12.centers).to(dev) + init12, 12, 12, geom12, 12.0)
    k2c_err = max(k2c_err, err)
    before = extract_regions_banded.launches
    kr = extract_regions_banded(lvl12[0], empty, 12, 12, make_grid(ww, hh, 6, iy_range=(3, 3)),
                                12.0)
    torch.cuda.synchronize()
    check(extract_regions_banded.launches == before and tuple(kr[0].shape) == (0, 27, 27),
          "K2c on an empty grid")
    print("phase1c K2c num_h=0 launches nothing", flush=True)

    # -- phase 1d: windows outside the staged box ------------------------------
    # Inits drawn up to the 4K finest scale's static bound (56 px) on the
    # 4K, 1080p and KITTI B = 8 finest grids: many groups' boxes outgrow the
    # stage, and their windows come from device memory.
    for label, lv, cen, cfg in (
            ("4K finest", l2_4, centers4, bench_cfg),
            ("1080p finest", finest["compat"][1], finest["compat"][4], bench_cfg),
            (f"KITTI B={nk} finest", kfinest["config3"][1], kfinest["config3"][4], cfg3)):
        lead = tuple(lv.img.shape[:-2])
        big = torch.from_numpy(rng.uniform(-bound0, bound0, lead + tuple(cen.shape))
                               .astype(np.float32)).to(dev)
        geom = make_grid(lv.width, lv.height, cfg.steps)
        _, err = k2c_check(f"{label}, init up to {bound0} px", lv.img, cen + big, 8, p, geom,
                           bound0, phase="1d")
        k2c_err = max(k2c_err, err)

    # DIS_FULL's finest scale (ps 12, stride 3; 230,400 patches) from its
    # own refined init: K2's 48-patch column groups under the fixed stage.
    # 1080 rows pad to 1088 for DIS_FULL's 2**4 (pad_divisible, as dis_flow pads).
    (fa, (fpw, fph)), (fb, _) = (im.pad_divisible(t, dt.DIS_FULL.coarsest_scale)
                                 for t in (a, b))
    full_levels, full_planes = refined_levels(fa, fb, dt.DIS_FULL)
    del fa, fb
    lf1, lf2, coarse, _, _ = full_levels[0]
    plan_f = scale_plan(lf1.width, lf1.height, dt.DIS_FULL.steps, 12, dev)
    pos_f = plan_f.centers + init_from_coarser_flow(plan_f, coarse)
    _, err = k2c_check("DIS_FULL 1080p finest (ps 12, stride 3, refined init)", lf2.img,
                       pos_f, 12, 12, plan_f.geom, 0.0, phase="1d")
    k2c_err = max(k2c_err, err)
    del pos_f

    # -- phase 2: the main path ---------------------------------------------
    wrappers = {"K3": pyramid_levels, "K2": extract_regions, "K2c": extract_regions_banded,
                "K1": iclk_search}
    launches = {"K3": 0, "K2": 0, "K1": 0}
    flows = {}
    for name, cfg in configs.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a, b, cfg)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"phase2 {name} launches {counts}", flush=True)
        check(counts == {**scale_counts(cfg), "K2c": 0}, f"{name}: launches {counts}, want "
              f"{scale_counts(cfg)} and no K2c at 1080p")
        for k in launches:
            check(counts[k] > 0, f"{name}: kernel {k} was not launched on the main path")
            launches[k] += counts[k]
        f = flow.cpu().numpy()
        check(f.shape == (H, W, 2), f"{name}: flow shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"{name}: non-finite flow")
        med = np.median(f.reshape(-1, 2), axis=0)
        epe = float(np.sqrt((f[..., 0] - SHIFT[0]) ** 2
                            + (f[..., 1] - SHIFT[1]) ** 2).mean())
        plain = dt.dis_flow(a, b, cfg, plain=True)
        d = torch.linalg.vector_norm(flow - plain, dim=-1)
        dmean, dfrac = float(d.mean()), float((d > 1e-2).float().mean())
        print(f"phase2 {name}: median {med.tolist()} epe {epe} "
              f"(jax cpu {EPE_JAX[name]}) kernel-vs-plain mean {dmean} "
              f"frac>1e-2 {dfrac}", flush=True)
        check(bool(np.all(np.abs(med - np.array(SHIFT)) <= 0.01)),
              f"{name}: median {med} not within 0.01 of {SHIFT}")
        check(abs(epe - EPE_JAX[name]) <= EPE_TOL,
              f"{name}: EPE {epe} vs JAX {EPE_JAX[name]}")
        check(dmean <= 1e-3 and dfrac <= 0.01,
              f"{name}: kernel vs plain mean {dmean} frac {dfrac}")
        flows[name] = flow

    # -- phase 2b: batched pairs on the main path ----------------------------
    kflows = {}
    kl = {"K2b": 0, "K1b": 0}
    for name, cfg in kitti_cfgs.items():
        want = scale_counts(cfg)
        fn = batched_flow_fn(cfg)
        runs = {}
        for label, call in (("batched_flow_fn", lambda: fn(*kpad)),
                            ("dis_flow", lambda: dt.dis_flow(ka, kb, cfg))):
            for w in wrappers.values():
                w.launches = 0
            runs[label] = call()
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()}
            print(f"phase2b {name} {label} B={nk} launches {counts}", flush=True)
            check(counts == {**want, "K2c": 0},
                  f"{name} {label}: launches {counts}, want {want} per batch")
            kl["K2b"] += counts["K2"]
            kl["K1b"] += counts["K1"]
        flows_b = runs["dis_flow"]
        check(tuple(flows_b.shape) == (nk, KH, KW, 2), f"{name}: flow shape {tuple(flows_b.shape)}")
        check(bool(torch.isfinite(flows_b).all()), f"{name}: non-finite flow")
        if cfg.finest_scale == 0:
            check(torch.equal(im.crop_padding(runs["batched_flow_fn"], kpw, kph, KW, KH),
                              flows_b), f"{name}: batched_flow_fn differs from dis_flow")
        for i in range(nk):
            check(torch.equal(flows_b[i], dt.dis_flow(ka[i], kb[i], cfg)),
                  f"{name}: batched pair {i} differs from its serial dis_flow")
        fb = flows_b.cpu().numpy()
        for i, (sx, sy) in enumerate(KITTI_SHIFTS):
            med = np.median(fb[i].reshape(-1, 2), axis=0)
            epe = float(np.sqrt((fb[i, ..., 0] - sx) ** 2 + (fb[i, ..., 1] - sy) ** 2).mean())
            print(f"phase2b {name} pair {i} shift ({sx}, {sy}): median {med.tolist()} "
                  f"epe {epe} (jax cpu {EPE_JAX_KITTI[name][i]})", flush=True)
            check(bool(np.all(np.abs(med - np.array([sx, sy])) <= 0.01)),
                  f"{name} pair {i}: median {med} not within 0.01 of ({sx}, {sy})")
            check(abs(epe - EPE_JAX_KITTI[name][i]) <= EPE_TOL,
                  f"{name} pair {i}: EPE {epe} vs JAX {EPE_JAX_KITTI[name][i]}")
        print(f"phase2b {name}: {nk} batched flows bitwise equal to {nk} serial "
              f"dis_flow calls", flush=True)
        kflows[name] = flows_b

    # -- phase 2c: the serving path, a CUDA graph per bucket ------------------
    served = {}
    for label, cfg, shape, inputs, eager in (
            ("1080p", bench_cfg, (H, W, None), (a, b), flows["compat"]),
            ("kitti", cfg3, (KH, KW, nk), (ka, kb), kflows["config3"])):
        t0 = time.perf_counter()
        cf = aot_compile(cfg, *shape)
        built = time.perf_counter() - t0
        want = scale_counts(cfg)
        gl = cf.graph_launches
        check(gl == {**want, "K2c": 0}, f"{label}: the graph holds launches {gl}, want {want}")
        for _ in range(2):
            out = cf(*inputs)
            torch.cuda.synchronize()
            check(torch.equal(out, eager), f"{label}: graph replay differs from the eager kernel path")
        try:
            cf(*(t[..., :-8] for t in inputs))
        except ValueError as e:
            check("compiled for" in str(e), f"{label}: wrong-shape error {e}")
        else:
            check(False, f"{label}: a wrong shape did not raise")
        print(f"phase2c {label} batch={shape[2]}: aot_compile {built:.2f} s; the graph "
              f"holds launches {gl}; 2 replays bitwise equal to the eager kernel "
              f"path; a wrong shape raises", flush=True)
        served[label] = cf

    # -- phase 2d: dis_flow at 4K ---------------------------------------------
    want4 = {"K3": 2, "K2": 3, "K2c": 1, "K1": 4}
    flows4 = {}
    for name, cfg in {**configs, "ultrafast": dt.DIS_ULTRAFAST}.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a4, b4, cfg)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"phase2d 4K {name} launches {counts}", flush=True)
        if name == "ultrafast":
            check(counts["K2c"] == 0 and counts["K2"] == 3, f"4K ultrafast: launches {counts}")
            continue
        check(counts == want4, f"4K {name}: launches {counts}, want {want4}")
        launches["K2c"] = launches.get("K2c", 0) + counts["K2c"]
        f = flow.cpu().numpy()
        check(f.shape == (H4K, W4K, 2), f"4K {name}: flow shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"4K {name}: non-finite flow")
        med = np.median(f.reshape(-1, 2), axis=0)
        epe = float(np.sqrt((f[..., 0] - SHIFT[0]) ** 2 + (f[..., 1] - SHIFT[1]) ** 2).mean())
        plain = dt.dis_flow(a4, b4, cfg, plain=True)
        d = torch.linalg.vector_norm(flow - plain, dim=-1)
        dmean, dfrac = float(d.mean()), float((d > 1e-2).float().mean())
        print(f"phase2d 4K {name}: median {med.tolist()} epe {epe} (jax cpu "
              f"{EPE_JAX_4K[name]}) kernel-vs-plain mean {dmean} frac>1e-2 {dfrac}", flush=True)
        check(bool(np.all(np.abs(med - np.array(SHIFT)) <= 0.01)),
              f"4K {name}: median {med} not within 0.01 of {SHIFT}")
        check(abs(epe - EPE_JAX_4K[name]) <= EPE_TOL, f"4K {name}: EPE {epe} vs JAX {EPE_JAX_4K[name]}")
        check(dmean <= 1e-3 and dfrac <= 0.01, f"4K {name}: kernel vs plain mean {dmean} frac {dfrac}")
        flows4[name] = flow
        del plain, d

    for w in wrappers.values():
        w.launches = 0
    fb = dt.dis_flow(torch.stack([a4, b4]), torch.stack([b4, a4]), bench_cfg)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    check(counts == want4, f"4K B=2: launches {counts}, want {want4}")
    check(torch.equal(fb[0], flows4["compat"]) and torch.equal(fb[1], dt.dis_flow(b4, a4, bench_cfg)),
          "4K B=2: the batched flows differ from 2 serial dis_flow calls")
    del fb
    print(f"phase2d 4K compat B=2 launches {counts}: bitwise equal to 2 serial calls", flush=True)

    t0 = time.perf_counter()
    cf4 = aot_compile(bench_cfg, H4K, W4K)
    built = time.perf_counter() - t0
    check(cf4.graph_launches == want4, f"4K graph holds launches {cf4.graph_launches}")
    for _ in range(2):
        out = cf4(a4, b4)
        torch.cuda.synchronize()
        check(torch.equal(out, flows4["compat"]), "4K graph replay differs from the eager kernel path")
    print(f"phase2d 4K aot_compile {built:.2f} s; the graph holds launches "
          f"{cf4.graph_launches}; 2 replays bitwise equal to the eager kernel path", flush=True)

    # -- phase 2e: exact tiling at 4K -------------------------------------------
    rows0 = [stripe_bounds(bench_cfg, H4K, N_STRIPES, i, halo)[0] for i in range(N_STRIPES)]
    check(rows0 == [0, 544, 1264], f"stripe row0s {rows0}")
    untiled = dis_flow_padded(a4, b4, bench_cfg)
    check(torch.equal(untiled, flows4["compat"]), "dis_flow_padded differs from dis_flow at 4K")
    for label, run in ((f"tiled_flow_exact {N_STRIPES} stripes halo {halo}",
                        lambda: tiled_flow_exact(a4, b4, bench_cfg, N_STRIPES, halo)),
                       (f"grid_tiled_flow {N_STRIPES} parts",
                        lambda: grid_tiled_flow(a4, b4, bench_cfg, N_STRIPES))):
        for w in wrappers.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        parts = N_STRIPES if label.startswith("tiled") else 1
        check(counts["K2c"] == N_STRIPES and counts["K2"] == 3 * N_STRIPES
              and counts["K3"] == 2 * parts, f"4K {label}: launches {counts}")
        check(torch.equal(out, untiled), f"4K {label}: differs from the untiled flow")
        print(f"phase2e 4K {label} (row0 {rows0}): launches {counts}; bitwise equal to "
              f"untiled", flush=True)
    del untiled, out

    # -- phase 2f: refinement presets at 1080p ----------------------------------
    refined = {"medium": dt.DIS_MEDIUM, "full": dt.DIS_FULL}
    want_refined = {"medium": {"K3": 2, "K2": 4, "K2c": 0, "K1": 4},
                    "full": {"K3": 4, "K2": 5, "K2c": 0, "K1": 5}}
    rflows = {}
    for name, cfg in refined.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a, b, cfg)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"phase2f {name} launches {counts}", flush=True)
        check(counts == want_refined[name] == {**scale_counts(cfg), "K2c": 0},
              f"{name}: launches {counts}, want {want_refined[name]}")
        for k in launches:
            launches[k] += counts[k]
        check(tuple(flow.shape) == (H, W, 2), f"{name}: flow shape {tuple(flow.shape)}")
        med, epe = flow_gates(name, flow.cpu().numpy(), SHIFT, EPE_JAX[name])
        plain = dt.dis_flow(a, b, cfg, plain=True)
        d = torch.linalg.vector_norm(flow - plain, dim=-1)
        dmean, dfrac = float(d.mean()), float((d > 1e-2).float().mean())
        print(f"phase2f {name}: median {med.tolist()} epe {epe} (jax cpu {EPE_JAX[name]}) "
              f"kernel-vs-plain mean {dmean} frac>1e-2 {dfrac}", flush=True)
        check(dmean <= 1e-3 and dfrac <= 0.01, f"{name}: kernel vs plain mean {dmean} frac {dfrac}")
        rflows[name] = flow
        del plain, d
    # The refinement alone, on the card and on the CPU, for the finest
    # level's inputs of each frame (the stepwise run equals dis_flow).
    med_levels, med_planes = refined_levels(a, b, dt.DIS_MEDIUM)
    rlevels = {"medium": (med_levels, med_planes), "full": (full_levels, full_planes)}
    crops = {"medium": (0, 0), "full": (fpw, fph)}
    for name, (levels, planes) in rlevels.items():
        check(torch.equal(im.crop_padding(levels[0][4], *crops[name], W, H), rflows[name]),
              f"{name}: stepwise run differs")
        args = refine_inputs(refined[name], levels, planes, 0)
        t0 = time.perf_counter()
        on_cpu = variational_refinement(*(x.cpu() if torch.is_tensor(x) else x for x in args))
        secs = time.perf_counter() - t0
        on_card = variational_refinement(*args).cpu()
        err = float((on_card - on_cpu).abs().max())
        print(f"phase2f {name} refinement of the finest level ({tuple(on_cpu.shape)}): "
              f"card vs CPU max|d| {err}, bitwise {torch.equal(on_card, on_cpu)} "
              f"(CPU call {secs:.2f} s)", flush=True)
        check(torch.equal(on_card, on_cpu), f"{name}: the card's refinement differs from the CPU's")
        check(torch.equal(on_card, levels[0][4].cpu()), f"{name}: refinement call differs")

    # -- phase 2g: refinement through the other paths (DIS_MEDIUM) ---------------
    med_cfg = dt.DIS_MEDIUM
    for label, call in (("batched_flow_fn", lambda: batched_flow_fn(med_cfg)(*kpad)),
                        ("dis_flow", lambda: dt.dis_flow(ka, kb, med_cfg))):
        for w in wrappers.values():
            w.launches = 0
        out = call()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        check(counts == {**scale_counts(med_cfg), "K2c": 0},
              f"KITTI medium {label}: launches {counts}")
        if label == "batched_flow_fn":
            kmed_padded = out
    kmed = out
    check(torch.equal(im.crop_padding(kmed_padded, kpw, kph, KW, KH), kmed),
          "KITTI medium: batched_flow_fn differs from dis_flow")
    fk = kmed.cpu().numpy()
    for i, shift in enumerate(KITTI_SHIFTS):
        check(torch.equal(kmed[i], dt.dis_flow(ka[i], kb[i], med_cfg)),
              f"KITTI medium: batched pair {i} differs from its serial dis_flow")
        med, epe = flow_gates(f"KITTI medium pair {i}", fk[i], shift)
        print(f"phase2g KITTI medium pair {i} shift {shift}: median {med.tolist()} epe {epe}",
              flush=True)
    print(f"phase2g KITTI medium B={nk} launches {counts}: batched flows bitwise equal to "
          f"{nk} serial dis_flow calls", flush=True)

    served_med = {}
    for label, shape, inputs, eager in (("1080p", (H, W, None), (a, b), rflows["medium"]),
                                        ("kitti", (KH, KW, nk), (ka, kb), kmed)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cf = aot_compile(med_cfg, *shape)
        built = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gl = cf.graph_launches
        check(gl == {**scale_counts(med_cfg), "K2c": 0}, f"medium {label}: graph holds {gl}")
        for _ in range(2):
            out = cf(*inputs)
            torch.cuda.synchronize()
            check(torch.equal(out, eager), f"medium {label}: replay differs from eager")
        print(f"phase2g medium {label} batch={shape[2]}: aot_compile {built:.2f} s, max memory "
              f"allocated {peak:.3f} GiB; the graph holds launches {gl}; 2 replays bitwise "
              f"equal to the eager kernel path", flush=True)
        served_med[label] = cf

    untiled = dis_flow_padded(a, b, med_cfg)
    check(torch.equal(untiled, rflows["medium"]), "medium: dis_flow_padded differs from dis_flow")
    halo_m = min_stripe_halo(med_cfg, W, H, N_STRIPES)
    fin_cfg = dataclasses.replace(med_cfg, refine_per_level=False)
    untiled_fin = dis_flow_padded(a, b, fin_cfg)
    halo_f = min_stripe_halo(fin_cfg, W, H, N_STRIPES)
    for label, run, want in (
            (f"grid_tiled_flow {N_STRIPES} parts",
             lambda: grid_tiled_flow(a, b, med_cfg, N_STRIPES), untiled),
            (f"tiled_flow_exact {N_STRIPES} stripes (to the grid engine)",
             lambda: tiled_flow_exact(a, b, med_cfg, N_STRIPES, halo_m), untiled),
            (f"refine_per_level=False tiled_flow_exact {N_STRIPES} stripes halo {halo_f}",
             lambda: tiled_flow_exact(a, b, fin_cfg, N_STRIPES, halo_f), untiled_fin)):
        for w in wrappers.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        check(torch.equal(out, want), f"1080p medium {label}: differs from the untiled flow")
        flow_gates(f"1080p medium {label}", out.cpu().numpy(), SHIFT)
        print(f"phase2g 1080p medium {label}: launches {counts}; bitwise equal to untiled",
              flush=True)
    del untiled, untiled_fin, out

    for label, img1, img2, cfg in (
            ("4K medium", a4, b4, med_cfg),
            ("1080p medium clamped", a, b, dataclasses.replace(med_cfg, refined_init_clamp=True)),
            ("4K medium clamped", a4, b4, dataclasses.replace(med_cfg, refined_init_clamp=True))):
        ww, hh = img1.shape[-1], img1.shape[-2]
        routes = [scale_extraction_route(cfg, ww, hh, s)
                  for s in range(cfg.finest_scale, cfg.coarsest_scale + 1)]
        n_k2c = routes.count("K2c")
        want = {**scale_counts(cfg), "K2": len(routes) - n_k2c, "K2c": n_k2c}
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(img1, img2, cfg)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        check(counts == want, f"{label}: launches {counts}, want {want} (routes {routes})")
        if label == "4K medium":
            check(n_k2c == 0, f"4K medium unclamped: routes {routes}")
        med, epe = flow_gates(label, flow.cpu().numpy(), SHIFT)
        print(f"phase2g {label}: routes by scale (finest first) {routes}, launches {counts}; "
              f"median {med.tolist()} epe {epe}", flush=True)
        if label == "4K medium":
            flow4_med = flow
        del flow

    # -- phase 2h: the saved serving artifact (torch.export) ----------------------
    t2h = time.perf_counter()
    for label, cfg, shape, inputs, eager, want in (
            ("1080p", bench_cfg, (H, W, None), (a, b), flows["compat"],
             {**scale_counts(bench_cfg), "K2c": 0}),
            ("kitti", cfg3, (KH, KW, nk), (ka, kb), kflows["config3"],
             {**scale_counts(cfg3), "K2c": 0}),
            ("4K", bench_cfg, (H4K, W4K, None), (a4, b4), flows4["compat"], want4)):
        t0 = time.perf_counter()
        data = export_flow(cfg, *shape)
        made = time.perf_counter() - t0
        if label == "1080p":
            # The fresh process runs alone: this one waits for it.
            got, flow_child, wall = fresh_process(data)
            check(torch.equal(flow_child.to(dev), served["1080p"](a, b)),
                  "1080p artifact in a fresh process: flow differs from aot_compile's replay")
            check(got["launches"] == want,
                  f"serving child: its graph holds launches {got['launches']}")
            print(f"phase2h 1080p artifact in a fresh process (no pipeline function run, "
                  f"alone on the card): imported the package in {got['import_s']:.2f} s, "
                  f"loaded it in {got['load_s']:.2f} s, {got['first_flow_s']:.2f} s from "
                  f"import to the first flow, replays {got['replay_ms']:.4f} ms/frame; "
                  f"process wall {wall:.2f} s; its flow bitwise equal to aot_compile's "
                  f"replay [{card}]", flush=True)
        t0 = time.perf_counter()
        run, program = load_exported(data)
        loaded = time.perf_counter() - t0
        ops = cost.kernel_ops(program)
        check(ops == want, f"{label} artifact: kernel ops {ops}, want {want}")
        plain = sum(n.target is torch.ops.aten.gather.default for n in program.graph.nodes)
        check(plain == 0, f"{label} artifact: {plain} gathers of a plain K2 or K1")
        for _ in range(2):
            out = run(*inputs)
            torch.cuda.synchronize()
            check(torch.equal(out, eager), f"{label} artifact: reloaded flow differs "
                  "from the eager kernel path")
        check(run.graph_launches == want,
              f"{label} artifact: graph holds {run.graph_launches}")
        line = (f"phase2h {label} batch={shape[2]}: export {made:.2f} s, {len(data)} "
                f"bytes, {len(program.graph.nodes)} graph nodes, kernel ops {ops}; loaded "
                f"in this process in {loaded:.2f} s, 2 replays bitwise equal to the eager "
                f"kernel path")
        if label == "1080p":
            turns = in_turns({"artifact": run, "aot_compile": served["1080p"]}, a, b)
            line += f"; replayed ms/frame in turns {turns}"
        print(f"{line} [{card}]", flush=True)
        del run, program, data
    served_cost = served["1080p"].cost_analysis()
    print("phase2h 1080p cost_analysis: " + json.dumps(served_cost), flush=True)
    print("phase2h 1080p memory_analysis: " + json.dumps(served["1080p"].memory_analysis()),
          flush=True)
    print(f"phase2h took {time.perf_counter() - t2h:.2f} s", flush=True)

    # -- phase 3: times -------------------------------------------------------
    times = {}
    costs = {"K3": cost.pyramid_cost(1, H, W, p, 4)}
    times["K3"] = (replay_ms(lambda: construct_pyramid(a, 3, p)),
                   time_ms(lambda: construct_pyramid(a, 3, p, plain=True)))
    cfg, l2, tpl, Tn, centers, init_u, pos0, conv0 = finest["compat"]
    nh = num_h_of(l2, cfg)
    costs["K2"] = extract_cost(l2.img, pos0, 8)
    times["K2"] = (replay_ms(lambda: extract_regions(l2.img, pos0, 8, p, num_h=nh)),
                   time_ms(lambda: iclk.extract_regions_plain(l2.img, pos0, 8, p)))
    print(f"phase3 K2 consecutive groups (no num_h): "
          f"{replay_ms(lambda: extract_regions(l2.img, pos0, 8, p)):.4f} ms replayed "
          f"[{card}]", flush=True)
    kr = extract_regions(l2.img, pos0, 8, p)
    args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
    trips = []
    iclk.iclk_search_plain(*kr, *args, trips=trips)
    costs["K1"] = search_cost(init_u, conv0, cfg, trips)
    times["K1"] = (replay_ms(lambda: iclk_search(*kr, *args)),
                   time_ms(lambda: iclk.iclk_search_plain(*kr, *args)))
    eager = {"K3": time_ms(lambda: construct_pyramid(a, 3, p)),
             "K2": time_ms(lambda: extract_regions(l2.img, pos0, 8, p, num_h=nh)),
             "K1": time_ms(lambda: iclk_search(*kr, *args))}
    for k, (km, pm) in times.items():
        print(f"phase3 {k}: kernel {km:.4f} ms replayed ({eager[k]:.4f} ms a call with its "
              f"host work), plain {pm:.4f} ms [{card}]", flush=True)
    for name, cfg in configs.items():
        fk = time_ms(lambda: dt.dis_flow(a, b, cfg), reps=10)
        fp = time_ms(lambda: dt.dis_flow(a, b, cfg, plain=True), reps=10)
        print(f"phase3 dis_flow 1080p {name}: kernels {fk:.4f} ms/frame, "
              f"plain {fp:.4f} ms/frame [{card}]", flush=True)

    # -- phase 3b: batched and replayed times ---------------------------------
    for bsz in (1, 2, 4, nk):
        xa, xb = ka[:bsz], kb[:bsz]
        cf = served["kitti"] if bsz == nk else aot_compile(cfg3, KH, KW, batch=bsz)
        check(cf.graph_launches == served["kitti"].graph_launches,
              f"B={bsz}: the graph holds {cf.graph_launches}, B={nk} holds "
              f"{served['kitti'].graph_launches}")
        e = time_ms(lambda: dt.dis_flow(xa, xb, cfg3), reps=10)
        r = time_ms(lambda: cf(xa, xb), reps=10)
        print(f"phase3b KITTI config3 B={bsz}: eager {e:.4f} ms/batch "
              f"({bsz * 1000.0 / e:.2f} pairs/s), replayed {r:.4f} ms/batch "
              f"({bsz * 1000.0 / r:.2f} pairs/s) [{card}]", flush=True)
        del cf
    e = time_ms(lambda: dt.dis_flow(a, b, bench_cfg), reps=10)
    r = time_ms(lambda: served["1080p"](a, b), reps=10)
    print(f"phase3b 1080p compat: eager {e:.4f} ms/frame, replayed {r:.4f} ms/frame "
          f"[{card}]", flush=True)
    cfg, l2, tpl, Tn, centers, init_u, pos0, conv0 = kfinest["config3"]
    nh = num_h_of(l2, cfg)
    costs["K2b"] = extract_cost(l2.img, pos0, 8)
    times["K2b"] = (replay_ms(lambda: extract_regions(l2.img, pos0, 8, p, num_h=nh)),
                    time_ms(lambda: iclk.extract_regions_plain(l2.img, pos0, 8, p), reps=10))
    kr = extract_regions(l2.img, pos0, 8, p)
    args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
    trips = []
    iclk.iclk_search_plain(*kr, *args, trips=trips)
    costs["K1b"] = search_cost(init_u, conv0, cfg, trips)
    times["K1b"] = (replay_ms(lambda: iclk_search(*kr, *args)),
                    time_ms(lambda: iclk.iclk_search_plain(*kr, *args), reps=5, warmup=1))
    for k in ("K2b", "K1b"):
        print(f"phase3b {k} B={nk} N={pos0.shape[1]}: kernel {times[k][0]:.4f} ms "
              f"plain {times[k][1]:.4f} ms [{card}]", flush=True)
    launches.update(kl)

    # -- phase 3c: 4K times ----------------------------------------------------
    costs["K2c"] = extract_cost(l2_4.img, pos04, 8)
    times["K2c"] = (replay_ms(lambda: extract_regions_banded(l2_4.img, pos04, 8, p, geom4,
                                                             bound0), calls=5),
                    time_ms(lambda: iclk.extract_regions_plain(l2_4.img, pos04, 8, p),
                            reps=PLAIN_REPS_4K, warmup=1))
    k2_4k = replay_ms(lambda: extract_regions(l2_4.img, pos04, 8, p, num_h=geom4.num_h),
                      calls=5)
    k2_4k_flat = replay_ms(lambda: extract_regions(l2_4.img, pos04, 8, p), calls=5)
    # A yardstick of the card's write rate, not a kernel of the port: one
    # fill of as many bytes as the regions.
    fill = torch.empty_like(kc4[0])
    fill_4k = replay_ms(lambda: fill.zero_(), calls=5)
    del fill
    print(f"phase3c 4K finest N={pos04.shape[0]}: K2c {times['K2c'][0]:.4f} ms, K2 "
          f"{k2_4k:.4f} ms (consecutive groups {k2_4k_flat:.4f}), plain "
          f"{times['K2c'][1]:.4f} ms, bound {bound(*costs['K2c'])[0]:.4f} ms; a fill of the "
          f"regions' bytes (zero_) {fill_4k:.4f} ms [{card}]", flush=True)
    k1_4k = replay_ms(lambda: iclk_search(*kc4, tpl4, Tn4, centers4, init4, conv04, bench_cfg,
                                          W4K, H4K), calls=5)
    k3_4k = replay_ms(lambda: (construct_pyramid(a4, 3, p), construct_pyramid(b4, 3, p)),
                      calls=5)
    print(f"phase3c 4K compat parts of a frame (replayed): K1 finest {k1_4k:.4f} ms, K3 both "
          f"4-level pyramids {k3_4k:.4f} ms [{card}]", flush=True)
    for name, cfg in configs.items():
        cf = cf4 if name == "compat" else aot_compile(cfg, H4K, W4K)
        e = time_ms(lambda: dt.dis_flow(a4, b4, cfg), reps=10)
        r = time_ms(lambda: cf(a4, b4), reps=10)
        print(f"phase3c 4K {name}: eager {e:.4f} ms/frame, replayed {r:.4f} ms/frame "
              f"[{card}]", flush=True)
        del cf
    e = time_ms(lambda: tiled_flow_exact(a4, b4, bench_cfg, N_STRIPES, halo), reps=5, warmup=1)
    print(f"phase3c 4K compat tiled_flow_exact {N_STRIPES} stripes: eager {e:.4f} ms/frame "
          f"[{card}]", flush=True)

    # -- phase 3d: refinement presets, times ------------------------------------
    frame_ms = {}
    for label, cfg, (x, y) in (("1080p medium", dt.DIS_MEDIUM, (a, b)),
                               ("1080p full", dt.DIS_FULL, (a, b)),
                               ("4K medium", dt.DIS_MEDIUM, (a4, b4))):
        cf = served_med["1080p"] if label == "1080p medium" else aot_compile(cfg, *x.shape)
        want = {"1080p medium": rflows["medium"], "1080p full": rflows["full"],
                "4K medium": flow4_med}[label]
        check(torch.equal(cf(x, y), want), f"{label}: graph replay differs from eager")
        e = time_ms(lambda: dt.dis_flow(x, y, cfg), reps=5, warmup=1)
        r = time_ms(lambda: cf(x, y), reps=10)
        frame_ms[label] = r
        print(f"phase3d {label}: eager {e:.4f} ms/frame, replayed {r:.4f} ms/frame "
              f"[{card}]", flush=True)
        del cf
    e = time_ms(lambda: dt.dis_flow(ka, kb, med_cfg), reps=5, warmup=1)
    r = time_ms(lambda: served_med["kitti"](ka, kb), reps=10)
    print(f"phase3d KITTI medium B={nk}: eager {e:.4f} ms/batch ({nk * 1000.0 / e:.2f} "
          f"pairs/s), replayed {r:.4f} ms/batch ({nk * 1000.0 / r:.2f} pairs/s) [{card}]",
          flush=True)
    for name, (levels, planes) in rlevels.items():
        total = 0.0
        for scale in sorted(levels):
            args = refine_inputs(refined[name], levels, planes, scale)
            ms = replay_ms(lambda: variational_refinement(*args), calls=2, reps=5)
            ops = torch_ops(lambda: variational_refinement(*args))
            total += ms
            print(f"phase3d 1080p {name} refinement at scale {scale} "
                  f"{tuple(args[2].shape[:-1])}: {ms:.4f} ms replayed, {ops} launches "
                  f"[{card}]", flush=True)
        # The same frame without refinement, replayed: the refinement's
        # share read inside one kind of graph (the per-level graphs above
        # hold 2 calls each, the frame's graph 1).
        cfg = refined[name]
        bare_cf = aot_compile(dataclasses.replace(cfg, refinement_iters=0), H, W)
        bare = time_ms(lambda: bare_cf(a, b), reps=10)
        del bare_cf
        frame = frame_ms[f"1080p {name}"]
        print(f"phase3d 1080p {name}: the refinement alone {total:.4f} ms replayed (sum of the "
              f"levels; {100.0 * total / frame:.1f}% of the {frame:.4f} ms replayed frame); "
              f"the frame without refinement {bare:.4f} ms replayed, so the refinement takes "
              f"{frame - bare:.4f} ms ({100.0 * (frame - bare) / frame:.1f}%) [{card}]", flush=True)

    # -- phase 4: the CLI and the runner on frame sequences -------------------
    t0 = time.perf_counter()
    for k, n in cli_phase(dev, card, bench_cfg, wrappers).items():
        launches[k] += n
    print(f"phase4 took {time.perf_counter() - t0:.2f} s", flush=True)

    # -- phase 5: the multi-rank engines, every rank on card 0 ------------------
    ref = {"cfg3": cfg3, "a": a, "b": b, "a4": a4, "b4": b4, "kpad": kpad, "kpw": kpw,
           "kph": kph, "flow4": flows4["compat"], "medium": rflows["medium"],
           "kitti": kflows["config3"], "flow1080": flows["compat"]}
    for k, n in multi_rank_phase(dev, card, bench_cfg, ref).items():
        launches[k] += n

    src = "dis_tpu_torch/csrc/"
    meta = {
        "K3": ("pyramid_level", src + "pyramid_level.cu",
               "dis_tpu/ops/pallas/pyramid_kernel.py:58", k3_err),
        "K2": ("extract_regions", src + "extract_regions.cu",
               "dis_tpu/ops/pallas/extract_kernel.py:259", k2_err),
        "K1": ("iclk_search", src + "iclk.cu",
               "dis_tpu/ops/pallas/iclk_kernel.py:93", k1_err),
        "K2b": ("extract_regions_batched", src + "extract_regions.cu",
                "dis_tpu/ops/pallas/extract_kernel.py:284", k2b_err),
        "K1b": ("iclk_search_batched", src + "iclk.cu",
                "dis_tpu/ops/pallas/iclk_kernel.py:573", k1b_err),
        "K2c": ("extract_regions_banded", src + "extract_banded.cu",
                "dis_tpu/ops/pallas/extract_kernel.py:163", k2c_err),
    }
    # cost_analysis's entries against the kernels line: K3 (one pyramid) and
    # K2 at the finest scale give the same bounds; K1 counts its fixed loop
    # and no start freezes, so its bytes differ by the raw templates of the
    # patches frozen at the start (a few hundred at 1080p).
    kc = served_cost["kernels"]
    for k, entry, tol in (("K3", kc["K3"][0], 0.0), ("K2", kc["K2"][-1], 0.0),
                          ("K1", kc["K1"][-1], 1e-3)):
        static = bound(entry["bytes accessed"], entry["flops"])
        run_bound = bound(*costs[k])
        print(f"cost_analysis {k}: bound {static[0]:.6f} ms by {static[1]}; kernels line "
              f"{run_bound[0]:.6f} ms by {run_bound[1]}", flush=True)
        check(static[1] == run_bound[1] and abs(static[0] - run_bound[0]) <= tol * run_bound[0],
              f"cost_analysis {k} bound {static} vs the kernels line {run_bound}")
    rows = []
    for k in ("K3", "K2", "K1", "K2b", "K1b", "K2c"):
        bound_ms, bound_by = bound(*costs[k])
        rows.append({"name": meta[k][0], "route": "cuda", "source": meta[k][1],
                     "replaces": meta[k][2], "launches": launches[k],
                     "max_abs_err": meta[k][3], "ms": times[k][0], "plain_ms": times[k][1],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def kernel_times(root: str) -> int:
    """Times the kernels of the ``dis_tpu_torch`` package under ``root``
    on the main-path inputs (``replay_ms`` and ``time_ms``) and prints one
    JSON line: K3 on the 1080p pyramid of one image and of both; K2 and K1
    at the 1080p finest scale (compat bench config; K1 also ``DIS_FAST``);
    K2b and K1b on the KITTI B = 8 batch (config 3); K3 on the two 4K
    pyramids, K2c and K2 on the same 4K finest inputs, and K1 there; the
    replayed 1080p and 4K compat frames (``aot_compile``).  K2
    gets the grid's column length where the tree's ``extract_regions``
    takes ``num_h``, as its main path does (``k2_num_h`` says which).
    Only functions every tree of the port has are called."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import inspect

    sys.path.insert(0, root)
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build
    from dis_tpu_torch.models.dis import init_bound
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.grid import make_grid
    from dis_tpu_torch.ops.pyramid import construct_pyramid
    from dis_tpu_torch.serving import aot_compile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    bench_cfg = dt.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                             finest_scale=0, patch_overlap=0.3,
                             patch_normalization=True, mode="compat", early_exit=False)
    p = bench_cfg.img_padding
    takes_num_h = "num_h" in inspect.signature(extract_regions).parameters
    out = {"root": root, "package": dt.__file__, "card": card, "k2_num_h": takes_num_h}

    def both(key, fn, calls=20):
        """Replayed device ms per call, and ms of one call with its host work."""
        out[key + "_replayed_ms"] = replay_ms(fn, calls=calls)
        out[key + "_call_ms"] = time_ms(fn)

    def k2_k1(k2_key, k1_key, img1, img2, cfg, calls=20):
        """K2 (under k2_key, if given) and K1 on the finest scale's inputs;
        returns the level plane, the positions and the grid."""
        _, l2, tpl, Tn, centers, init_u, pos0, conv0 = finest_inputs(img1, img2, cfg, p)
        geom = make_grid(l2.width, l2.height, cfg.steps)
        kw = {"num_h": geom.num_h} if takes_num_h else {}
        if k2_key:
            both(k2_key, lambda: extract_regions(l2.img, pos0, cfg.patch_size, p, **kw), calls)
        kr = extract_regions(l2.img, pos0, cfg.patch_size, p)
        args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
        both(k1_key, lambda: iclk_search(*kr, *args), calls)
        return l2.img, pos0, geom

    a, b = (torch.from_numpy(q).to(dev) for q in synth_pair())
    both("K3_1080p_one_pyramid", lambda: construct_pyramid(a, 3, p))
    both("K3_1080p_both_pyramids", lambda: (construct_pyramid(a, 3, p),
                                            construct_pyramid(b, 3, p)))
    k2_k1("K2_1080p_compat", "K1_1080p_compat", a, b, bench_cfg)
    k2_k1(None, "K1_1080p_fast", a, b, dt.DIS_FAST)
    kpairs = [kitti_pair(i) for i in range(len(KITTI_SHIFTS))]
    ka, kb = (im.pad_divisible(torch.from_numpy(np.stack([q[j] for q in kpairs])).to(dev), 3)[0]
              for j in (0, 1))
    k2_k1("K2b_kitti_b8", "K1b_kitti_b8", ka, kb, bench_cfg)
    a4, b4 = (torch.from_numpy(q).to(dev) for q in synth_pair_4k())
    both("K3_4k_both_pyramids", lambda: (construct_pyramid(a4, 3, p),
                                         construct_pyramid(b4, 3, p)), calls=5)
    img4, pos4, geom4 = k2_k1("K2_4k_finest", "K1_4k_compat", a4, b4, bench_cfg, calls=5)
    bound0 = init_bound(bench_cfg, 0)
    both("K2c_4k_finest", lambda: extract_regions_banded(img4, pos4, 8, p, geom4, bound0),
         calls=5)
    # Whole frames, replayed from the serving path's CUDA graph: whether a
    # kernel's gain shows end to end.
    for key, (x, y) in (("frame_1080p_compat", (a, b)), ("frame_4k_compat", (a4, b4))):
        served = aot_compile(bench_cfg, *x.shape)
        out[key + "_replayed_ms"] = time_ms(lambda: served(x, y), reps=10)
        del served
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-times":
        sys.exit(kernel_times(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-child":
        sys.exit(serve_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--kernel-times ROOT]")
    sys.exit(main())
