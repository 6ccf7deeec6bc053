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
   K1's plane mode (K1p: each window copied from the level plane, no K2)
   on each of these inputs bitwise equal to K2 then K1, in one launch;
2. drives ``dis_tpu_torch.dis_flow`` on the 1920x1080 pair of
   ``bench.synth_pair()`` (a (3, 2) px shift) under the compat bench
   config and ``DIS_FAST``: K3 launches once per image, K1 once per
   scale in its plane mode and no K2, the
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
    their batched plain versions and to 8 serial K2/K1 calls, and K1b's
    plane mode to them;
2b. ``parallel.batched_flow_fn`` and batched ``dis_flow`` on the 8 pairs:
    per batch K1 launches once per scale and K3 once per image
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
    column-banded K2, a standalone kernel the search no longer launches)
    at the 4K finest-scale shapes (N =
    331,776), bitwise equal to its plain version and to K2 at B = 1, at
    B = 2 and on stripe 1 of 3 (row0 = 544), where K1 with row0 > 0 is
    held to its plain version bitwise, and its plane mode on the stripe's
    plane to K1; K2c at ps 12 on a small plane; an empty
    grid launches nothing; K2 in each of these also with the grid's column
    length (``num_h``), so that its groups follow the columns; the share of
    windows that K2c copied from device memory, outside its group's staged
    box, is printed (a few, where the init flow spreads a group widely);
1d. windows outside the staged box: inits drawn up to the 4K finest
    scale's static bound (56 px) on the 4K, 1080p and KITTI B = 8 finest
    grids, so that many groups' boxes outgrow the fixed stage; K2c, K2
    and K2 with ``num_h`` bitwise equal to the plain version;
2d. ``dis_flow`` at 4K: per call K3 launches twice and K1 four times, all
    in its plane mode, and no K2c (K1 three times under
    ``DIS_ULTRAFAST``, whose finest scale is 1), the median
    within 0.01 px of (3, 2), the mean EPE within 0.002 px of the JAX
    package's CPU reading, the kernel path against the plain path under
    the 1080p gates, a batch of 2 bitwise equal to 2 serial calls, and
    an ``aot_compile`` 4K graph replay bitwise equal to the eager path;
2e. ``parallel.tiled_flow_exact`` with 3 stripes and ``min_stripe_halo``
    (176 rows; row0 0, 544, 1264) and ``parallel.grid_tiled_flow`` with 3
    parts, each bitwise equal to the untiled flow, K1 in its plane mode
    at every scale of every stripe (no K2c) and K3 twice per stripe;
3c. times: K2c and K2 on the same 4K finest inputs (beside a ``zero_``
    fill of as many bytes, the card's practical write rate), K2c then K1
    against K1's plane mode there (the search as the removed route ran
    it and as it runs now, three runs each way in turns, bitwise equal),
    4K ms/frame eager and replayed (compat and ``DIS_FAST``), 3-stripe
    tiled 4K ms/frame.

The refinement presets (``DIS_MEDIUM``: ps 8, stride 4, scales 3..0;
``DIS_FULL``: ps 12, stride 3, scales 4..0; both refine every level on
the intensity planes, 5 and 10 weight updates of 5 red-black SOR sweeps),
whose variational refinement runs as the kernels R0 (the level's Sobel
planes), R1 (the warp, once per level; in its setup mode it also writes
the weight update's inputs; in its warp1 mode, R1w, under
``refinement_scheme="warp1"``, it warps I2 alone and writes those inputs
from the Sobels of the warped plane and of I1, and R0 does not run), R23
(a weight update and its half-sweeps on tiles in shared memory; the last
of a level in its compose mode, which writes the flow, clipped under
``refined_init_clamp``) and R3 (a level without a half-sweep, in its
no-sweep mode), and
whose intensity planes come from F2, which no ``pallas_call`` backs (they
replace XLA's fusions of the JAX package's refinement code):

1d. (also) K2c and K2 on ``DIS_FULL``'s 1080p finest grid (230,400
    patches, ps 12) from its own refined init, with the share of windows
    copied from device memory;
1e. R0, R1's setup mode and R23 on the inputs the main path gives them
    at the finest level of the 1080p ``DIS_MEDIUM`` and ``DIS_FULL``
    frames and of the KITTI B = 8 ``DIS_MEDIUM`` batch (R0's and the setup
    mode's calls, R23's second, a weight update with nonzero increments,
    and its last, the compose mode), recorded from a refinement run
    (``refine_step_inputs``), each bitwise equal to its plain version run
    on the card's tensors and timed beside it (kernel replayed, plain
    eager and replayed) with its bound and its share of it, and again on
    inputs out of the L2 (``cold_replay_ms``); R23 also on both calls at
    every level of the 1080p ``hd1080_medium`` frame (flowbench's
    configuration) and on the finest level of the 1080p ``DIS_MEDIUM``
    frame under ``warp1``, bitwise equal to its plain version, timed a
    level; R1's setup mode also beside ``grid_sample`` (bilinear, border
    padding) on its planes and flow, the yardstick of its ``library_ms``;
    R1's warp1 mode (R1w) likewise on the finest level of the 1080p
    ``DIS_MEDIUM`` frame under ``warp1``; R23's compose mode with the clip
    on the compose mode's inputs with a bound that binds
    (``CLIP_BOUND``), and R3's no-sweep mode on that update's u0, v0, du
    and dv with and without the clip;
1f. (each scale's glue) S1 (templates, inverse Hessians, fixed mode's
    ``Tn`` and the search start: the NN init and the start test, which
    were once a kernel of their own, S2), S3 (fixed mode's
    weights) and S4 (densification) on the inputs the main path gives them
    at the finest scale of the 1080p compat and ``DIS_FAST`` frames, the
    KITTI B = 8 config 3 batch, stripe 1 of 3 of the 4K compat frame (row0
    544, a row-ranged grid, an output window and a coarser flow with its
    row offset) and the 1080p ``DIS_FULL`` frame (ps 12), and S1 also at
    the 1080p compat coarsest scale (no coarser flow), recorded from a run
    (``scale_step_inputs``), each bitwise equal to its plain version (S1:
    ``templates_plain`` then ``search_start_plain``) and timed beside it
    with its bound and its share of that bound, S1 also without the start
    (the start's added time inside S1, the ``search_start`` row of the
    ``kernels`` line) and the start's plain version alone;
    at the 1080p compat and ``DIS_FULL`` finest scales also S4 beside a
    fill of its flow's bytes, and at the ``DIS_FULL`` one S4's sweep of
    cover widths (``S4_SWEEP_PS``: the ``DIS_FULL`` grid, u and weights
    with the covers of ps 6, 8 and 12 at its stride 3, weighted and
    uniform, each bitwise equal to its plain version, with its bound);
    every path through ``models/dis.py::_scale`` launches S1 and S4 once
    per scale (and S3 in fixed mode), and no separate start kernel, which
    every launch count below includes (``glue_counts``);
1g. (the frame's glue) F1 (the divisibility padding of both images),
    F2 (the refinement's intensity levels of both) and F3 (the finest
    flow's upsample and crop) on the inputs the main path gives them
    (``frame_step_inputs``) in the ``dis_flow`` calls of the KITTI B = 8
    batch under ``DIS_MEDIUM`` and ``DIS_ULTRAFAST``, the 1080p
    ``DIS_FULL`` frame (1088 padded rows) and the 1080p ``DIS_MEDIUM``
    frame, each bitwise equal to its plain version and timed beside it
    with its bound, F1 and F3 also beside one ``F.pad`` and one
    ``F.interpolate`` (their ``library_ms``), each beside the floor of a
    fill and a copy of the bytes it moves (``fill_floor``) and timed again
    on inputs out of the L2 (``cold_replay_ms``); F2 also with five levels
    in one launch and on rows of 66 floats (its scalar path), F3 also at
    2^finest = 4 with an odd crop and at 2 with an even left edge;
1h. K1's plane mode at patch 12 (its split layout, counted in
    ``split_launches`` at every scale of a medium pair: 5 at 1080p, 6 at
    4K), on the finest scale of the benchmark's
    ``hd1080_medium`` and ``uhd4k_medium`` (N = 58,240 and 232,320) with
    the search inputs their served path gives (``served_search_inputs``):
    bitwise equal to K2 then K1 and to its plain composition, and timed
    (replayed) beside K2, K1 from K2's regions and the two in turn, each
    with its bound (one JSON line, ``search_plane``);
2f. ``dis_flow`` on the 1080p pair: per frame K3 2, K1 4 (no K2), R0 4,
    R1 4, R23 20, F2 1 (``DIS_MEDIUM``; under ``warp1`` the same
    without R0, every R1 in its warp1 mode) and K3 4, K1 5, R0 5,
    R1 5, R23 50, F1 1, F2 1 (``DIS_FULL``, whose five levels take
    two K3 launches per image, and whose 1080 rows pad to 1088), R1 and R23
    one a level in their modes and K1 in its plane mode (``mode_counts``),
    no K2 or K2c; the median within
    0.01 px of (3, 2), the mean EPE within 0.002 px of the JAX package's
    CPU reading (``tools/jax_epe_readings.py``; ``warp1``'s, ``EPE_JAX``,
    from the same call), the kernel path against
    the plain path under the phase-2 gates; the refinement of each
    frame's finest level on the card bitwise equal to the same call on
    the CPU;
2g. ``DIS_MEDIUM`` on the other paths: the 8 KITTI pairs batched
    bitwise equal to serial; ``aot_compile`` graphs at 1080p and KITTI
    B = 8 (peak memory printed) holding the eager launches, each replay
    bitwise equal to eager; ``grid_tiled_flow`` (3 parts) and
    ``tiled_flow_exact`` (3 stripes, routed to the grid engine), and
    ``refine_per_level=False`` through ``tiled_flow_exact`` (R1 1, R23
    5), bitwise equal to untiled; 4K unclamped and 1080p and 4K with
    ``refined_init_clamp`` (K1's plane mode at every scale, no K2c; R23
    clips in its compose mode, one a level, and no ``clamp`` op runs),
    each flow finite with its median
    within 0.01 px of its shift; 1080p with no weight update and the
    clamp (R3 once a level in its no-sweep mode, with its clip) equal to
    the frame without refinement;
3d. times: eager and replayed ms/frame for 1080p ``DIS_MEDIUM`` (also
    under ``warp1``, whose replay is held bitwise to its eager frame) and
    ``DIS_FULL`` and 4K ``DIS_MEDIUM``, each beside the same frame without
    refinement, replayed, which gives the refinement's share; KITTI
    ``DIS_MEDIUM`` pairs/s at B = 8; and the refinement alone, replayed,
    per level at 1080p with its launches (non-view torch ops and R0, R1,
    R23 and R3).

The saved serving artifact (``serving.export_flow``, ``torch.export``
with the kernels as ``dis_tpu_torch`` ops), after phase 2g:

2h. the compat bench config exported at 1080p (B = None), config 3 at
    KITTI size with B = 8, the compat 4K bucket and ``DIS_MEDIUM`` at
    1080p: each program holds the kernel ops in the counts of
    ``scale_counts`` (``DIS_MEDIUM`` also R0 4, R1 4, R23 20, F2 1; KITTI
    F1 1; no K2 or K2c, the 4K bucket's too) and no gather of a plain
    K2, K1 or R1; the KITTI,
    4K and ``DIS_MEDIUM`` artifacts, reloaded in this process
    (``load_exported``), replay bitwise equal to their eager kernel flows
    (``DIS_MEDIUM``'s also to ``aot_compile``'s replay), with each
    artifact's graph nodes and export and load seconds printed; the 1080p
    artifact, loaded in a fresh process
    that has the pipeline's functions replaced by ones that raise
    (``--serve-child``; this process waits for it, so nothing else runs on
    the card or the host meanwhile), gives a flow bitwise equal to phase
    2c's replay, its graph holding K3 2, K1 4; export time, bytes,
    the child's time from import to the first flow and its replayed frame
    are printed, then the 1080p artifact's replay and ``aot_compile``'s in
    turns;
    then ``cost_analysis()`` and ``memory_analysis()`` of the 1080p
    bucket, whose kernel entries give the ``kernels`` line's bounds (K3
    exactly; K1 in its plane mode, counted for its fixed loop, within
    0.1%; no K2), and the
    1080p ``DIS_MEDIUM`` bucket's ``cost_analysis()``, whose finest-level
    R0, R1 (its setup mode) and R23 (a weight update and its compose
    mode) entries and
    its F2 entry give theirs exactly.

Small frames, after phase 2h:

2i. ``dis_flow`` at 8 x 64, 9 x 64, 16 x 64, 64 x 16, 64 x 8 and 1 x 1
    (coarse planes shorter than a region, coarsest levels of one or two
    rows or columns; ``SMALL_FRAMES``, ``small_pair``) under compat, ``DIS_FAST``
    and ``DIS_MEDIUM``, and a batch of 2 under compat: the launches of
    ``scale_counts`` (adding to the kernels line's), every kernel call
    held bitwise to its plain version on its recorded inputs
    (``op_step_inputs``: K3, K1/K1b in its plane mode, S1, S3, S4, R0, R1's setup
    mode, R23, F1-F3 as they ran), the flow finite
    and within the phase-2 gates of the same call on the CPU.

The user-facing surface (phase 4, after the times): the CLI
(``dis_tpu_torch.cli.main``) and the sequence runner on a 9-frame
1920x1080 sequence (``write_sequence``: ``bench.synth_pair``'s recipe,
each frame shifted (3, 2) px from the last, quantised to 8-bit PNG by the
port's own writer, with ``.flo`` ground truth) in a temporary directory:

4.  the native I/O library builds (required); the compat bench config
    over the 8 pairs writes 8 colourised PNGs and ``.flo`` files, each
    ``.flo`` bitwise equal to the eager kernel path on the decoded
    frames, its graph capturing K3 2, K1 4 a frame (the counts move
    at the 2 warm-up calls and the capture, never at a replay), its mean
    EPE within 0.002 px of the JAX CLI's CPU reading (``EPE_JAX_CLI``);
    ``--batch 4`` (K1b), ``--preset medium``, ``draw_grid = 1``,
    ``DIS_TPU_CHECK=1``, ``--profile-dir`` (a trace naming ``pyramid``
    and ``scale_0``) and the runner stopped after pair 4 and resumed,
    each bitwise equal to the serial run; a 4K pair through the CLI
    (no K2c); and the CLI's steady-state rate with its split by phase
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
    phase 2d's, K3 twice and K1 in its plane mode at every scale on each
    rank, no K2c;
5b. 1080p ``DIS_MEDIUM`` through ``tiled_flow_fn`` (routed to
    ``grid_tiled_flow_fn``) over 3 ranks, bitwise equal to phase 2f's;
5c. ``sequence_pair_flow_fn`` (9 frames) and ``sequence_flow_fn`` (the
    first 8) over 2 ranks on phase 4's 1080p sequence, bitwise equal to
    the serial flows (K1b on each rank);
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

The port's measurement tools (phase 6, after phase 5; ``dis_tpu_torch/
tools``), each with the counts set to 0 just before and read just after:

6a. ``tools.quality_sweep`` (its CLI and ``sweep``) for ``DIS_MEDIUM`` and
    ``DIS_FULL`` over the seven ``synth`` families at 384 x 512: each
    family's EPE within EPE_TOL of the JAX tool's CPU reading
    (``EPE_JAX_SWEEP``), and each family's flow within 1e-4 px mean of
    the port's own CPU flow (computed meanwhile in a child process,
    ``--sweep-child``, while 6c times the card);
6c. ``tools.scaling_measure`` at 1080p and 4K (1088 x 1920 and 2176 x
    3840) for n = 2 and 4: every stripe and window program of the tiling
    engines timed by graph replay, every stitched flow bitwise the
    untiled one, and the projected efficiencies with their link
    assumption;
6b. ``tools.trace_budget`` of the replayed and the eager 1080p compat
    frame, the 1080p ``DIS_MEDIUM`` frame and the KITTI config 3 batch
    of 8 (K1b): the top 15 names, the scope totals, a frame's busy
    time, device time and span on the card, and the busy share; the
    budget's device ms per frame (the replay's launches from their
    first event's start to their last one's end: its ops and the idle
    time between the graph's kernels) within 10% of the same run's
    ``replay_ms`` of the frame (a graph of 5 ``dis_flow`` calls); a
    served request's time (``time_ms`` of ``aot_compile``'s graph, which
    adds the host's launches) printed beside.

Each kernel's line gives its bound: the larger of the bytes it must move
(each input read once, each output written once: K3 the raw image and
every level's planes, K1 its inputs with the raw template only for the
patches frozen at the start) over 3.35 TB/s and its operations (K1's for
the trips these inputs run) over 67 TFLOP/s, the H100 SXM's HBM3 and
float32 peaks; the formulas are the package's (``dis_tpu_torch/cost.py``).
No single PyTorch call computes K1-K3, R0, R3, R23, S1, S3, S4, F2, the
start or the modes, so their ``library_ms`` is null; R1's is
``grid_sample``'s (phase 1e), F1's one ``F.pad`` (replicate) and F3's
one ``F.interpolate`` (bilinear) (phase 1g).  Phase 6b also prints a
replayed frame's kernels and splits its ops' time into the port's
kernels, by id (``trace_budget.PORT_KERNELS``), and torch's (the glue,
copies and fills); 6a says for how many families the card flow is
bitwise the CPU flow.  Every row of the ``kernels`` line must have
launched on the main path; the modes' rows (``mode_of``) count their own
launches, which their kernel's row counts too.  K2 and K2b, which the
main path no longer launches (K1's plane mode copies their windows), have
no row: phase 1 holds them bitwise as the plane mode's gate, and the
main-path phases must count none of them.

``python3 chip_smoke.py --sweep-child OUT`` is phase 6a's CPU process, not
an entry point.

``python3 chip_smoke.py --kernel-times ROOT`` builds and times only the
kernels (K3; K2 and K1 at the 1080p finest scale; K2b and K1b at KITTI
B = 8; K2c and K2 on the same 4K finest inputs, and K1 there; at patch
12, K2, K1 and K1's plane mode at the finest scales of the benchmark's
``hd1080_medium`` and ``uhd4k_medium``; S1 and S4 at the 1080p compat
finest scale, S4 at the 1080p ``DIS_FULL`` one; the
search start with its templates, as one S1 or S1 then S2 where the tree
still has S2, at the 1080p compat finest and coarsest scales and the
KITTI B = 8 finest one), the
replayed 1080p and 4K compat frames, and the refinement of the finest
level of the 1080p ``DIS_MEDIUM`` and ``DIS_FULL`` frames (with R0-R3
and R1's and R3's modes where the tree has them), F1, F2 and F3 on phase
1g's timed inputs (also on inputs out of the L2, beside the floor of a
fill and a copy of their bytes), those frames and the 1080p ``DIS_MEDIUM``
artifact's export and load, on the same inputs, for the
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
import hashlib
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
# Phase 1f's patch sizes for S4's covers on the DIS_FULL finest grid (stride
# 3): 3, 4 and 5 grid rows and columns a pixel, DIS_FULL's own last.
S4_SWEEP_PS = (6, 8, 12)
# The kernels line's rows, each with its launches summed over the main-path
# phases (K2 and K1 with a pair axis count as K2b and K1b).  The search
# start (once a kernel of its own, S2) runs inside every S1 launch: its row follows
# LAUNCH_KEYS' and takes S1's launches.
LAUNCH_KEYS = ("K3", "K1", "K1b", "K1p", "R0", "R1s", "R1w", "R23", "R23c", "R3k", "R3n",
               "S1", "S3", "S4", "F1", "F2", "F3")
# K2, K2b and K2c, which the main path does not launch (K1's plane mode,
# K1p, searches every scale): phase 1 holds them bitwise as the plane
# mode's gate, and the main-path phases count them, which must stay 0.
OFF_PATH = ("K2", "K2b", "K2c")
# R1 and R3 as the counts name them (``graph_launches``): R1 launches only
# in its setup and warp1 modes and R3 only in its no-sweep mode, the rows
# of the kernels line.
MODE_ONLY = ("R1", "R3")
# K1's launches in its split layout (ps 12), which K1's row of the kernels
# line reports as its ``split_launches``.
COUNTED = LAUNCH_KEYS + OFF_PATH + MODE_ONLY + ("K1s",)
# The kernels that phase 2g does not add up (its batches launch K2b and K1b).
CORE = ("K3", "K2", "K1", "K2c")
# Mean EPE against the (3, 2) shift of the JAX package on CPU, same pair
# and configs; the port must land within EPE_TOL of it.  DIS_MEDIUM and
# DIS_FULL: tools/jax_epe_readings.py (64 s and 302 s on the CPU).
# DIS_MEDIUM under refinement_scheme="warp1" ("warp1"): the same jitted
# dis_tpu.dis_flow call on the CPU with dataclasses.replace(DIS_MEDIUM,
# refinement_scheme="warp1") (49 s).
EPE_JAX = {"compat": 0.1526, "fast": 0.00515,
           "medium": 0.00048054210492409766, "full": 0.0002898645179811865,
           "warp1": 0.0004975744523108006}
EPE_TOL = 0.002
REPS = 20
# Phase 1e's bound for the clip on the 1080p finest level, whose flow is
# about (3, 2) px: it binds on every u and on some v.
CLIP_BOUND = 2.5

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


def bench_config(name: str, root: str = ""):
    """The ``DISConfig`` of the benchmark's configuration ``name``
    (``flowbench/configs/<name>.json`` under ``root``, by default beside
    this file)."""
    import dis_tpu_torch as dt

    root = root or os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "flowbench", "configs", name + ".json")) as fh:
        return dt.DISConfig(**json.load(fh)["dis"])


def served_search_inputs(cfg, img1, img2):
    """The finest scale's search inputs in a ``dis_flow`` call, as the
    served path gives them (each coarser scale searched and, where the
    config says so, refined): (plane, starts, the search's other
    arguments, the grid), recorded from ``ops/iclk.py::inverse_search``."""
    import dis_tpu_torch as dt
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops.grid import make_grid

    calls = []
    inverse_search = iclk.inverse_search

    def record(*args, **kw):
        calls.append((args, kw))
        return inverse_search(*args, **kw)

    iclk.inverse_search = record
    try:
        dt.dis_flow(img1, img2, cfg)
    finally:
        iclk.inverse_search = inverse_search
    (plane, tpl, centers, init_u, _, width, height), kw = calls[-1]
    pos0, conv0 = kw["start"]
    return (plane, pos0, (tpl, kw["Tn"], centers, init_u, conv0, cfg, width, height),
            make_grid(width, height, cfg.steps))


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


def search_plane_cost(img, init_u, conv0, cfg, trips):
    """(bytes, operations) of the K1/K1b launch in its plane mode on
    these inputs, as ``search_cost`` (``dis_tpu_torch/cost.py``)."""
    from dis_tpu_torch import cost

    nb = init_u.shape[0] if init_u.ndim == 3 else 1
    return cost.search_plane_cost(nb, *img.shape[-2:], init_u.shape[-2], cfg.patch_size,
                                  cfg.mode == "fixed", cfg.patch_normalization, sum(trips),
                                  int(conv0.sum()))


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


def aten_calls(fn):
    """``fn()`` and the non-view aten ops it dispatched, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    names = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "aten" and not func.is_view:
                names[func.name()] = names.get(func.name(), 0) + 1
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn()
    return out, names


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


def refine_counts(cfg):
    """The refinement's launches in one call, whatever B is: R0 once per
    refined level (``planes6``), R1 once per outer iteration (in its setup
    mode under ``planes6``, in its warp1 mode under ``warp1``), R23 once
    per weight update (the last of each outer iteration in its compose
    mode; ``update_plan`` splits no update of up to 10 SOR sweeps), or R3
    once per outer iteration in its no-sweep mode where there is no
    half-sweep, at every scale (``refine_per_level``) or the finest, and F2
    once where the refinement reads intensity planes; none without
    refinement."""
    if cfg.refinement_iters == 0:
        return {}
    levels = cfg.coarsest_scale - cfg.finest_scale + 1 if cfg.refine_per_level else 1
    r1 = levels * cfg.refinement_iters
    r23 = r1 * cfg.refinement_inner_sweeps * (cfg.refinement_sor_sweeps > 0)
    return {**({"R0": levels} if cfg.refinement_scheme == "planes6" else {}),
            **({"R1": r1} if r1 else {}), **({"R23": r23} if r23 else {}),
            **({"R3": r1} if r1 and not r23 else {}),
            **({"F2": 1} if cfg.refinement_planes == "intensity" and cfg.coarsest_scale
               else {})}


def mode_counts(cfg):
    """The launches of K1's plane mode (``K1p``: every scale) and of K1 in
    its split layout (``K1s``: every scale at ps 12), R1's setup
    and warp1 modes (``R1s``, ``R1w``), R23's compose mode (``R23c``) and
    R3's no-sweep mode
    (``R3n``) in one call, which ``scale_counts`` and ``refine_counts``
    count as K1's, R1's, R23's and R3's, and of the launches with the clip
    on (``R3k``, R23's compose mode or R3's no-sweep mode): the last outer
    iteration of each level that ``refine_level`` clips
    (``refined_init_clamp``, per level)."""
    from dis_tpu_torch.ops.cuda.iclk_kernel import search_layout

    n = cfg.coarsest_scale - cfg.finest_scale + 1
    k, g = search_layout(cfg.patch_size)
    plane = {"K1p": n, **({"K1s": n} if k * g < cfg.patch_size ** 2 else {})}
    if cfg.refinement_iters == 0:
        return plane
    levels = plane["K1p"] if cfg.refine_per_level else 1
    r1 = levels * cfg.refinement_iters
    sweeps = cfg.refinement_inner_sweeps * cfg.refinement_sor_sweeps
    return {**plane, ("R1s" if cfg.refinement_scheme == "planes6" else "R1w"): r1,
            ("R23c" if sweeps else "R3n"): r1,
            **({"R3k": levels} if cfg.refined_init_clamp and cfg.refine_per_level else {})}


def frame_counts(cfg, height: int, width: int):
    """The frame's launches in one ``dis_flow`` call on [(B,) height,
    width] frames: F1 where they pad to ``2**coarsest_scale``, F3 where
    ``finest_scale > 0``."""
    f = 2 ** cfg.coarsest_scale
    return {**({"F1": 1} if height % f or width % f else {}),
            **({"F3": 1} if cfg.finest_scale else {})}


def glue_counts(cfg, n: int):
    """Launches of each scale's glue over ``n`` scales: S1 (the start
    included) and S4 once per scale, S3 once per scale in fixed mode."""
    return {"S1": n, **({"S3": n} if cfg.mode == "fixed" else {}), "S4": n}


def scale_counts(cfg, frame=None):
    """Launches one call must make, whatever B is: K1 (in its plane mode,
    ``mode_counts``; no K2), S1, S4 (and S3) once per scale
    (``glue_counts``); K3 once per image (or stack of images) for
    up to four levels; R0, R1, R23, R3 and F2 as ``refine_counts`` says;
    and, for a
    ``dis_flow`` call on [(B,) height, width] frames (``frame``), F1 and
    F3 as ``frame_counts`` says (the engines on padded frames launch
    neither)."""
    from dis_tpu_torch.ops.cuda.pyramid_kernel import MAX_LEVELS

    n = cfg.coarsest_scale - cfg.finest_scale + 1
    return {"K3": 2 * -(-(cfg.coarsest_scale + 1) // MAX_LEVELS), "K2": 0, "K1": n,
            **refine_counts(cfg), **glue_counts(cfg, n),
            **(frame_counts(cfg, *frame) if frame else {})}


def want_4k(cfg):
    """Launches of one 4K frame without refinement: K1 in its plane mode
    at all four scales, no K2c."""
    return {"K3": 2, "K2": 0, "K2c": 0, "K1": 4, **glue_counts(cfg, 4)}


# The wrappers of K1's plane mode, R1's setup and warp1 modes and R3's
# no-sweep mode, the counts of K1's split layout, of R23's compose mode
# and of the launches with the clip on: their launches count in K1's,
# R1's, R3's and R23's too, and read_counts leaves them out.
MODES = ("K1p", "K1s", "R1s", "R1w", "R23c", "R3k", "R3n")
# The kernel whose row of the kernels line counts a mode's launches too.
MODE_OF = {"K1p": "K1", "R23c": "R23", "R3k": "R23"}


class SplitLaunches:
    """K1's launches in its split layout (its wrapper's ``split_launches``)
    as a mode's ``launches``."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self) -> int:
        return self.wrapper.split_launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.split_launches = n


def kernel_wrappers():
    """Every kernel's wrapper, by kernel, and the modes' (``MODES``)."""
    from dis_tpu_torch.ops.cuda import frame_kernel as fkern
    from dis_tpu_torch.ops.cuda import refine_kernel as rk
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search, iclk_search_plane
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_levels
    from dis_tpu_torch.ops.cuda.scale_kernel import densify, fixed_weights, scale_templates

    return {"K3": pyramid_levels, "K2": extract_regions, "K2c": extract_regions_banded,
            "K1": iclk_search, "K1p": iclk_search_plane, "K1s": SplitLaunches(iclk_search),
            "R0": rk.refine_planes, "R3": rk.refine_nosweep, "R23": rk.refine_update,
            "S1": scale_templates, "S3": fixed_weights, "S4": densify, "F1": fkern.frame_pad,
            "F2": fkern.intensity_levels, "F3": fkern.frame_finish, "R1s": rk.refine_setup,
            "R1w": rk.refine_setup_warp1, "R23c": rk.composed, "R3k": rk.clamped,
            "R3n": rk.refine_nosweep}


def read_counts(wrappers):
    """Each wrapper's launches since its count was set to 0: K3, K2, K2c
    and K1 always, the others where they ran (as
    ``CompiledFlow.graph_launches`` and ``cost.kernel_ops`` give them; R1's
    are its setup and warp1 modes'), the modes left out."""
    counts = {k: w.launches for k, w in wrappers.items()
              if k not in MODES and (k[0] == "K" or w.launches)}
    r1 = wrappers["R1s"].launches + wrappers["R1w"].launches
    return {**counts, **({"R1": r1} if r1 else {})}


def read_modes(wrappers):
    """The modes' launches since their counts were set to 0, where they ran."""
    return {k: wrappers[k].launches for k in MODES if wrappers[k].launches}


def grid_sample_ms(planes, flow, warped, card) -> float:
    """The yardstick of R1's setup mode, not a kernel of the port: the
    device ms of one ``torch.nn.functional.grid_sample`` call (bilinear,
    border padding, corner-aligned) that samples the same planes [h, w, C]
    (made planar outside the timed call) at ``x + flow``; its largest
    difference from R1's warp ``warped`` (``refine_warp_plain``) is printed
    (its own rounding of the same blend)."""
    h, w, c = planes.shape
    nchw = planes.movedim(-1, 0)[None].contiguous()
    ys, xs = (torch.arange(n, device=planes.device, dtype=torch.float32) for n in (h, w))
    grid = torch.stack([(xs[None, :] + flow[..., 0]) * (2.0 / (w - 1)) - 1.0,
                        (ys[:, None] + flow[..., 1]) * (2.0 / (h - 1)) - 1.0], dim=-1)[None]

    def sample():
        return torch.nn.functional.grid_sample(nchw, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    diff = float((sample()[0].movedim(0, -1) - warped).abs().max())
    ms = replay_ms(sample)
    print(f"phase1e R1s yardstick: grid_sample {ms:.4f} ms replayed, max |d| {diff} from "
          f"R1's warp [{card}]", flush=True)
    return ms


def wrapper_args(k, a):
    """The arguments of the wrapper of R23 or of R3's no-sweep mode (``k``
    ``R23``, ``R3n``) from those its CUDA function took: the clip's bound,
    or none, where the function takes a flag and a bound (a tree since R3's
    clip); any other kernel's as they are."""
    if (k, len(a)) in (("R23", 21), ("R3n", 6)):
        return a[:-2] + ((a[-1],) if a[-2] else ())
    return a


def refine_step_inputs(args, picks):
    """Runs ``variational_refinement(*args)`` and returns, by kernel, the
    inputs that the ``picks[kernel]``-th calls of R0, R1's setup and warp1
    modes (``R1s``, ``R1w``), R23 and R3's no-sweep mode (``R3n``) gave
    their kernel
    (the checked arguments of the ops' CUDA functions, as the wrappers take
    them, ``wrapper_args``; those of the tree's kernels only, and of the
    calls it made): the main path's own inputs for each."""
    from dis_tpu_torch.ops.cuda import refine_kernel as rk
    from dis_tpu_torch.ops.variational import variational_refinement

    names = {k: fn for k, fn in (("R0", "_planes_cuda"), ("R1s", "_setup_cuda"),
                                 ("R1w", "_setup_warp1_cuda"), ("R23", "_update_cuda"),
                                 ("R3n", "_nosweep_cuda"))
             if k in picks and hasattr(rk, fn)}
    seen = {k: [] for k in names}
    originals = {k: getattr(rk, fn) for k, fn in names.items()}

    def recorder(k):
        def call(*a):
            seen[k].append(wrapper_args(k, a) if len(seen[k]) in picks[k] else None)
            return originals[k](*a)
        return call

    try:
        for k, fn in names.items():
            setattr(rk, fn, recorder(k))
        variational_refinement(*args)
    finally:
        for k, fn in names.items():
            setattr(rk, fn, originals[k])
    return {k: [seen[k][i] for i in picks[k] if i < len(seen[k])] for k in names}


# Phase 2i's frames (height, width): coarse planes shorter than a region,
# coarsest levels of one or two rows or columns, and the smallest frame.
SMALL_FRAMES = ((8, 64), (9, 64), (16, 64), (64, 16), (64, 8), (1, 1))


def small_pair(h: int, w: int, seed: int):
    """A smooth random frame [h, w] and the same frame shifted one column
    (a flow of (1, 0)), NumPy only."""
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    big = (r.random((h + 32, w + 33)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    for _ in range(2):
        big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    return (np.ascontiguousarray(big[16:16 + h, 17:17 + w]),
            np.ascontiguousarray(big[16:16 + h, 16:16 + w]))


def op_functions():
    """Every kernel a ``dis_flow`` call can launch: (module, its op's CUDA
    function, the plain version in the op's layout, which is the op's CPU
    function and runs on any device)."""
    from dis_tpu_torch.ops.cuda import (extract_kernel, frame_kernel, iclk_kernel,
                                        pyramid_kernel, refine_kernel, scale_kernel)

    return {"K3": (pyramid_kernel, "_pyramid_cuda", "_pyramid_cpu"),
            "K2": (extract_kernel, "_extract_cuda", "_extract_cpu"),
            "K1": (iclk_kernel, "_search_cuda", "_search_cpu"),
            "K1p": (iclk_kernel, "_search_plane_cuda", "_search_plane_cpu"),
            "S1": (scale_kernel, "_templates_cuda", "_templates_cpu"),
            "S3": (scale_kernel, "_weights_cuda", "fixed_weights_plain"),
            "S4": (scale_kernel, "_densify_cuda", "densify_plain"),
            "R0": (refine_kernel, "_planes_cuda", "_planes_cpu"),
            "R1s": (refine_kernel, "_setup_cuda", "_setup_cpu"),
            "R1w": (refine_kernel, "_setup_warp1_cuda", "_setup_warp1_cpu"),
            "R23": (refine_kernel, "_update_cuda", "_update_cpu"),
            "R3n": (refine_kernel, "_nosweep_cuda", "_nosweep_cpu"),
            "F1": (frame_kernel, "_pad_cuda", "_pad_cpu"),
            "F2": (frame_kernel, "_levels_cuda", "_levels_cpu"),
            "F3": (frame_kernel, "_finish_cuda", "_finish_cpu")}


def op_step_inputs(run, fns):
    """Runs ``run()`` with the CUDA functions of ``fns`` (``op_functions``)
    recording their arguments; returns, by kernel, every call's arguments
    (the kernels that ran), and ``run()``'s result under "out"."""
    seen = {}
    originals = {k: getattr(mod, fn) for k, (mod, fn, _) in fns.items()}

    def recorder(k):
        def call(*a):
            seen.setdefault(k, []).append(a)
            return originals[k](*a)
        return call

    try:
        for k, (mod, fn, _) in fns.items():
            setattr(mod, fn, recorder(k))
        seen["out"] = run()
    finally:
        for k, (mod, fn, _) in fns.items():
            setattr(mod, fn, originals[k])
    return seen


def frame_step_inputs(run):
    """Runs ``run()`` and returns, by kernel, the inputs that each call of
    F1, F2 and F3 gave its kernel (the checked arguments of the ops' CUDA
    functions): the main path's own inputs."""
    fns = {k: v for k, v in op_functions().items() if k[0] == "F"}
    steps = op_step_inputs(run, fns)
    del steps["out"]
    return steps


def scale_step_inputs(run):
    """Runs ``run()`` and returns, by kernel, the inputs that each call of
    S1, S3 and S4 (and S2, in a tree that still has it) gave its kernel
    (the checked arguments of the ops' CUDA functions), coarsest scale
    first: the main path's own inputs.  S3 is missing where the config is
    not in fixed mode."""
    from dis_tpu_torch.ops.cuda import scale_kernel as sk

    fns = {k: (sk, fn, None) for k, fn in (("S1", "_templates_cuda"), ("S2", "_start_cuda"),
                                          ("S3", "_weights_cuda"), ("S4", "_densify_cuda"))
           if hasattr(sk, fn)}
    steps = op_step_inputs(run, fns)
    del steps["out"]
    return steps


def flat_tensors(x):
    """The tensors of a kernel's result, in order (a PatchTemplates and its
    Tn, a tuple, or a tensor); None gives none."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in flat_tensors(item)]


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


def cold_replay_ms(fn, args, nbytes: float, calls: int = 20) -> float:
    """``replay_ms`` of ``fn`` over rotating copies of its tensor arguments,
    enough that the calls between two uses of one copy move over 100 MB,
    twice the H100's 50 MB L2: each call finds its inputs in device
    memory, as a frame's first touch does, where ``replay_ms`` of one set
    of inputs that fit the L2 reads them from it."""
    n = min(calls, max(2, -(-int(100e6) // max(int(nbytes), 1)) + 1))
    copies = [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
              for _ in range(n)]
    turn = [0]

    def step():
        fn(*copies[turn[0] % n])
        turn[0] += 1

    ms = replay_ms(step, calls=calls)
    del copies
    return ms


def fill_floor(nbytes: float, dev):
    """The floor under a kernel that moves ``nbytes``: device ms per call of
    a fill (``zero_``) of as many bytes and of a copy (``copy_``) that
    reads half of them and writes the other half, replayed.  Beside a
    bound of a few microseconds, it tells a launch's ramp apart from the
    kernel's own inefficiency."""
    buf = torch.empty(int(nbytes) // 4, dtype=torch.float32, device=dev)
    half = buf.numel() // 2
    src, dst = buf[:half], buf[half:2 * half]
    fill_ms = replay_ms(lambda: buf.zero_())
    copy_ms = replay_ms(lambda: dst.copy_(src))
    del buf
    return fill_ms, copy_ms


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

# Per-family masked EPE of the JAX package's sweep on the CPU at 384 x 512
# (the JSON lines of
#   JAX_PLATFORMS=cpu python tools/quality_sweep.py --preset medium
#   JAX_PLATFORMS=cpu python tools/quality_sweep.py --preset full
# 109 s and 272 s on the CPU); phase 6a holds the port's card
# sweep to them within EPE_TOL.
SWEEP_SIZE = (384, 512)
EPE_JAX_SWEEP = {
    "medium": {"discontinuous": 0.0005, "natural_warp": 0.0526, "rotation": 0.0155,
               "shear": 0.0139, "smooth_warp": 0.0267, "translation": 0.0004,
               "zoom": 0.0163},
    "full": {"discontinuous": 0.0005, "natural_warp": 0.0543, "rotation": 0.0159,
             "shear": 0.0123, "smooth_warp": 0.0282, "translation": 0.0003,
             "zoom": 0.0169},
}
BUDGET_FRAMES = 3


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
    from dis_tpu_torch.tools.trace_budget import device_busy_ms
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
    launches = dict.fromkeys(COUNTED, 0)

    def counted(label, argv, want, timer=None, batched=False):
        """The CLI with every count set to 0 just before and read just after;
        a graph's kernels count at the warm-up and the capture, never at a
        replay, so ``want`` (one frame's launches) comes per_capture times.
        The counts join ``launches`` (K2 and K1 as K2b and K1b where
        ``batched``)."""
        for w in wrappers.values():
            w.launches = 0
        out = run_cli(argv, timer)
        counts = read_counts(wrappers)
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

        # 4K: one pair through the CLI, K1's plane mode at every scale.
        root4 = root / "4k"
        write_sequence(root4, 2, H4K, W4K)
        counted("CLI compat 4K 1 pair", [root4 / "frames", 1, 2, 16, 8, 3, 0, 0.3, 1, 0]
                + common + ["--out-dir", root4 / "out"], want_4k(bench_cfg))
        a4, b4 = (torch.from_numpy(imread_gray(str(root4 / "frames" / f"frame_{t:04d}.png"))
                                   .astype(np.float32)).to(dev) for t in (1, 2))
        check(np.array_equal(load_flo(str(root4 / "out" / "frame_0001.flo")),
                             dt.dis_flow(a4, b4, bench_cfg).cpu().numpy()),
              "CLI 4K: .flo differs from the eager kernel path")
        print("phase4 CLI 4K: the flow bitwise equal to the eager kernel path", flush=True)
    return launches


def phase5_rank(dev, inputs_path: str, steps) -> dict:
    """One rank of phase 5 (``parallel.launch.spawn``, gloo, every rank on
    card 0): each step ``(label, kind, cfg, n, keys)`` of ``steps`` on a
    mesh of the first n ranks, once with the kernel counts set to 0 just
    before and read just after, then once more timed between two
    barriers, which must give the same bits.  Returns by label this
    rank's output on the CPU, its launches, the bytes ``shift`` staged
    through the host and the timed call's ms."""
    import torch.distributed as dist

    from dis_tpu_torch.parallel import (batch_sharding, batched_flow_epe_fn, make_mesh,
                                        row_sharding, sequence_flow_fn,
                                        sequence_pair_flow_fn, tiled_flow_fn)
    from dis_tpu_torch.parallel.mesh import shift

    wrappers = kernel_wrappers()
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
        counts = read_counts(wrappers)
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
    from dis_tpu_torch.parallel import (batched_flow_epe_fn, make_mesh, min_stripe_halo,
                                        tiled_flow_fn)
    from dis_tpu_torch.parallel.batch import _pair_epes
    from dis_tpu_torch.parallel.distributed import init_multi_host
    from dis_tpu_torch.parallel.launch import spawn
    from dis_tpu_torch.parallel.mesh import shift
    from dis_tpu_torch.utils.flo import load_flo
    from dis_tpu_torch.utils.io import imread_gray
    from dis_tpu_torch.utils.metrics import epe_torch

    wrappers = kernel_wrappers()
    launches = dict.fromkeys(COUNTED, 0)

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
                counts[label] = read_counts(wrappers)
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


def sweep_child(out: str) -> int:
    """Phase 6a's CPU process: the port's quality sweep of ``DIS_MEDIUM``
    and ``DIS_FULL`` at SWEEP_SIZE on the CPU, saved to ``out`` as
    {preset: {family: (EPE, flow)}}; prints its seconds."""
    from dis_tpu_torch import PRESETS
    from dis_tpu_torch.tools.quality_sweep import sweep

    t0 = time.perf_counter()
    got = {p: sweep(PRESETS[p], *SWEEP_SIZE, device="cpu") for p in EPE_JAX_SWEEP}
    torch.save(got, out)
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


def tools_phase(dev, card, bench_cfg, wrappers) -> dict:
    """Phase 6: the quality sweep (6a), the scaling projection (6c, while
    the sweep's CPU half runs in a child process) and the trace budget
    (6b, on a quiet host).  Returns the launches by kernel of its runs."""
    import contextlib
    import io

    import dis_tpu_torch as dt
    from dis_tpu_torch import serving
    from dis_tpu_torch.tools import quality_sweep, scaling_measure, trace_budget

    launches = dict.fromkeys(COUNTED, 0)

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def read(label, batched=False):
        torch.cuda.synchronize()
        counts = read_counts(wrappers)
        for k, n in counts.items():
            launches[k + "b" if batched and k in ("K2", "K1") else k] += n
        print(f"phase6 {label}: launches {counts}", flush=True)
        return counts

    # -- 6a: the quality sweep on the card ----------------------------------------
    t_phase = time.perf_counter()
    sh, sw = SWEEP_SIZE
    card_sweep = {}
    for preset in EPE_JAX_SWEEP:
        cfg = dt.PRESETS[preset]
        zero()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = quality_sweep.main(["--preset", preset, "--size", f"{sh}x{sw}",
                                     "--device", str(dev)])
        lines = buf.getvalue().splitlines()
        check(rc == 0, f"quality_sweep --preset {preset} exited {rc}")
        card_sweep[preset] = quality_sweep.sweep(cfg, sh, sw, device=dev)
        counts = read(f"6a quality_sweep {preset} (its CLI, then sweep())")
        want = scale_counts(cfg)
        check(counts == {**{k: 2 * len(EPE_JAX_SWEEP[preset]) * v for k, v in want.items()},
                         "K2c": 0}, f"6a {preset}: launches {counts}, want 14 x {want}")
        printed = json.loads(lines[-1])["epe"]
        for fam, want_epe in EPE_JAX_SWEEP[preset].items():
            epe = card_sweep[preset][fam][0]
            print(f"phase6 6a {preset} {fam:14s} card {epe:.6f} (printed {printed[fam]:.4f}) "
                  f"jax cpu {want_epe:.4f}", flush=True)
            check(abs(epe - want_epe) <= EPE_TOL and round(epe, 4) == printed[fam],
                  f"6a {preset} {fam}: EPE {epe} vs JAX {want_epe}, printed {printed[fam]}")
        print("phase6 6a " + lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="dis_tools_") as tmp:
        out = os.path.join(tmp, "sweep_cpu.pt")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sweep-child",
                                  out], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
        try:
            # -- 6c: the scaling projection (device-timed while the child runs) ----
            for name, (h, w) in scaling_measure.SIZES.items():
                zero()
                t0 = time.perf_counter()
                rec = scaling_measure.measure(name, h, w, (2, 4), bench_cfg, device=dev)
                counts = read(f"6c scaling_measure {name} n = 2, 4")
                check(all(counts[k] > 0 for k in ("K3", "K1")) and counts["K2"] == 0
                      and counts["K2c"] == 0, f"6c {name}: launches {counts}")
                print("phase6 6c " + json.dumps(rec), flush=True)
                for engine in ("stripe", "grid"):
                    for n, e in rec[engine].items():
                        check(e["stitched_bitwise"],
                              f"6c {name} {engine} n={n}: stitched flow differs from untiled")
                        print(f"phase6 6c {name} {engine} n={n}: ranks {e['rank_ms']} ms, "
                              f"link {e['link_bytes']} B {e['link_ms']:.4f} ms, projected "
                              f"efficiency {e['efficiency']:.3f} (T1 {rec['t1_ms']:.4f} ms); "
                              f"stitched bitwise the untiled flow [{card}]", flush=True)
                print(f"phase6 6c {name}: halo table {json.dumps(rec['halo'])}; link "
                      f"assumption: {rec['link_assumption']} ({time.perf_counter() - t0:.2f} s)",
                      flush=True)
            stdout, stderr = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        check(child.returncode == 0, f"sweep child failed:\n{stdout}{stderr}")
        cpu_sweep = torch.load(out, weights_only=False)
    for preset, fams in card_sweep.items():
        same = 0
        for fam, (epe, flow) in fams.items():
            d = float(np.abs(flow - cpu_sweep[preset][fam][1]).mean())
            same += bool(np.array_equal(flow, cpu_sweep[preset][fam][1]))
            print(f"phase6 6a {preset} {fam:14s} card vs CPU flow: mean |d| {d:.3g} px, "
                  f"bitwise {np.array_equal(flow, cpu_sweep[preset][fam][1])} "
                  f"(CPU EPE {cpu_sweep[preset][fam][0]:.6f})", flush=True)
            check(d <= 1e-4, f"6a {preset} {fam}: card flow {d} px from the CPU flow")
        # DIS_FULL (ps 12) divides its fixed-mode weight's mean by 144 as a
        # tensor since S3, so card and CPU round it alike; read, not gated.
        print(f"phase6 6a {preset}: card flow bitwise equal to the CPU flow for {same} of "
              f"{len(fams)} families", flush=True)
    print(f"phase6 6a CPU sweep child: {json.loads(stdout.splitlines()[-1])['seconds']:.2f} s",
          flush=True)

    # -- 6b: the trace budget, on a quiet host ---------------------------------------
    per_frame = serving.WARMUP_CALLS + 1 + 1 + BUDGET_FRAMES   # graph, eager warm-up, frames
    with tempfile.TemporaryDirectory(prefix="dis_budget_") as tmp:
        for label, cfg, (h, w), batch in (("1080p compat", bench_cfg, (H, W), None),
                                          ("1080p medium", dt.DIS_MEDIUM, (H, W), None),
                                          ("KITTI config 3 B=8", bench_cfg, (KH, KW), 8)):
            x, y = trace_budget.frame_inputs(h, w, batch, dev)
            zero()
            t0 = time.perf_counter()
            paths = trace_budget.capture(cfg, h, w, os.path.join(tmp, label.replace(" ", "_")),
                                         BUDGET_FRAMES, batch, dev, inputs=(x, y))
            counts = read(f"6b trace_budget {label}", batched=batch is not None)
            want = scale_counts(cfg, (h, w))
            check(counts == {**{k: per_frame * v for k, v in want.items()}, "K2c": 0},
                  f"6b {label}: launches {counts}, want {per_frame} x {want}")
            print(f"phase6 6b {label}: captured in {time.perf_counter() - t0:.2f} s", flush=True)
            got = {}
            for kind, path in paths.items():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    got[kind] = trace_budget.summarize(path, top=15)
                for line in buf.getvalue().splitlines():
                    print(f"phase6 6b {label} {kind}: {line}", flush=True)
            # The frame's device time with no host work inside (a graph of 5
            # frames), and a served request's (copies in, the replay, a copy
            # out, with the host's launches between them).
            replayed = replay_ms(lambda: dt.dis_flow(x, y, cfg), calls=5, reps=5)
            served = serving.aot_compile(cfg, h, w, batch=batch)
            request = time_ms(lambda: served(x, y), reps=10)
            del served
            # A graph's kernels may not reach a trace one by one with every
            # CUDA version; the eager trace launches the same kernels.
            read_by = "replay" if got["replay"]["kernels"] > 0 else "eager"
            b = got[read_by]
            port_ms = b["port_ms"]
            split = ", ".join(f"{k} {v:.4f}" for k, v in b["port_kernels"].items())
            print(f"phase6 6b {label}: {b['kernels']:.0f} kernels a frame; the port's kernels "
                  f"{port_ms:.4f} ms ({split}), torch glue, copies and fills "
                  f"{b['total_ms'] - port_ms:.4f} ms of the {b['total_ms']:.4f} ms of ops "
                  f"({read_by} trace) [{card}]", flush=True)
            print(f"phase6 6b {label}: budget ({read_by} trace) {b['device_ms']:.4f} device ms a "
                  f"frame: ops {b['total_ms']:.4f} ms ({b['kernels']:.0f} kernels), busy "
                  f"{b['busy_ms']:.4f} ms, idle between a graph's kernels "
                  f"{b['device_ms'] - b['busy_ms']:.4f} ms; the frame spans {b['span_ms']:.4f} ms "
                  f"on the card under the profiler; eager trace ops {got['eager']['total_ms']:.4f}"
                  f" ms ({got['eager']['kernels']:.0f} kernels), the card "
                  f"{100 * got['eager']['busy_share']:.1f}% busy; replay_ms "
                  f"{replayed:.4f} ms, a served request {request:.4f} ms [{card}]", flush=True)
            check(abs(b["device_ms"] - replayed) <= 0.1 * replayed,
                  f"6b {label}: budget {b['device_ms']} device ms a frame vs replay_ms "
                  f"{replayed} ms")
    print(f"phase6 took {time.perf_counter() - t_phase:.2f} s [{card}]", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build, cost
    from dis_tpu_torch.models.dis import (_stripe_plan, dis_flow_padded, dis_flow_stripe,
                                          motion_bound)
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search, iclk_search_plane
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level, pyramid_levels
    from dis_tpu_torch.ops.grid import init_from_coarser_flow, make_grid, scale_plan
    from dis_tpu_torch.ops.pyramid import construct_pyramid
    from dis_tpu_torch.ops.cuda import refine_kernel as rk
    from dis_tpu_torch.ops.variational import (refine_nosweep_plain, refine_planes_plain,
                                               refine_setup_plain, refine_setup_warp1_plain,
                                               refine_warp_plain, update_plan,
                                               variational_refinement)
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

    def plane_gate(label, img2, pos0, args, want, row0=0):
        """K1's plane mode on the plane and starts whose regions gave
        ``want`` (K1's result on them): one launch of K1 (K1b), no K2,
        bitwise ``want``."""
        before = (extract_regions.launches, iclk_search.launches, iclk_search_plane.launches)
        got = iclk_search_plane(img2, pos0, *args, row0)
        torch.cuda.synchronize()
        after = (extract_regions.launches, iclk_search.launches, iclk_search_plane.launches)
        check([y - x for x, y in zip(before, after)] == [0, 1, 1],
              f"K1p {label}: launches {before} -> {after}")
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"K1p {label}: differs from K2 then K1")

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
        plane_gate(f"{name} finest", l2.img, pos0, args, kout)
        print(f"phase1 {name} finest N={pos0.shape[0]}: K2 (consecutive and column "
              f"groups), K1 and K1's plane mode bitwise (K1 max|du| {err} flips {flips})",
              flush=True)

    print(f"phase1 K2 (the plane mode's gate) max_abs_err {k2_err}", flush=True)
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
            plane_gate(f"ps={ps} {mode}", lvl[0], pos0, args, kout)
            print(f"phase1 ps={ps} {mode} N={pos0.shape[0]}: K2, K1 and K1's plane mode "
                  f"bitwise (K1 max|du| {err} flips {flips}; active patches by trip {trips})",
                  flush=True)

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
        plane_gate(f"{name} B={nk}", l2.img, pos0, args, ko)
        print(f"phase1b {name} B={nk} N={pos0.shape[1]} ({nk * pos0.shape[1]} patches, "
              f"scale {cfg.finest_scale}): K2b and K1b bitwise equal to their batched "
              f"plain versions and to {nk} serial K2/K1 calls, K1b's plane mode to them",
              flush=True)

    print(f"phase1b K2b (the plane mode's gate) max_abs_err {k2b_err}", flush=True)

    # -- phase 1c: K2c at the 4K finest-scale shapes -------------------------
    # K2c, a standalone kernel the search no longer launches, with the
    # static bound of the 4K finest scale's init (twice the policing-chain
    # bound of scale 1), which the TPU kernel takes.
    t0 = time.perf_counter()
    a4, b4 = (torch.from_numpy(q).to(dev) for q in synth_pair_4k())
    print(f"phase1c 4K pair made in {time.perf_counter() - t0:.2f} s", flush=True)
    k3_err = max(k3_err, k3_check("4K image 1", a4))
    bound0 = 2.0 * motion_bound(bench_cfg, 1)

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
    plane_gate(f"stripe row0 {row0}", plane_s, rows_of(pos04), args_s[:-1], ks, row0)
    print(f"phase1c K1 stripe row0 {row0} N={ks[0].shape[0]}: bitwise equal to its plain "
          f"version (max|du| {err} flips {flips}) and to the full frame's rows, and so is "
          f"K1's plane mode on the stripe's plane", flush=True)

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
    print(f"phase1d K2c (a standalone kernel, the plane mode's gate) max_abs_err {k2c_err}",
          flush=True)

    # -- phase 1e: the refinement's kernels R0, R1, R23 and R3 -------------------
    # Each on the inputs the main path gives it at the finest level of the
    # 1080p DIS_MEDIUM and DIS_FULL frames and of the KITTI B = 8 DIS_MEDIUM
    # batch (R0's call; R1's setup mode's call; R23's second call, a weight
    # update whose increments are not 0, and its last, the compose mode),
    # bitwise equal to its plain version run on the card's tensors.  Then
    # each timed beside its plain version, at 1080p DIS_MEDIUM also on
    # inputs out of the L2.  Then R23 on every level of the 1080p
    # hd1080_medium frame (flowbench's configuration) and on the finest
    # level of the 1080p DIS_MEDIUM frame under warp1, where R1's warp1
    # mode (R1w) also runs; R23's compose mode with the clip (CLIP_BOUND,
    # which binds) and R3's no-sweep mode (with and without the clip) on
    # the 1080p DIS_MEDIUM compose mode's inputs.
    from dis_tpu_torch.ops.variational import refine_update_plain

    def r23_gate(label, args):
        """R23 on ``args`` (one launch) bitwise equal to its plain version;
        the largest difference."""
        before = rk.refine_update.launches
        got = flat_tensors(rk.refine_update(*args))
        want = flat_tensors(refine_update_plain(*args))
        torch.cuda.synchronize()
        check(rk.refine_update.launches == before + 1, f"R23 {label}: not one launch")
        for g, v in zip(got, want):
            check(g.shape == v.shape and torch.equal(g, v),
                  f"R23 {label}: differs from its plain version")
        return max(float((g - v).abs().max()) for g, v in zip(got, want))

    med_levels, med_planes = refined_levels(a, b, dt.DIS_MEDIUM)
    kmed_levels, kmed_planes = refined_levels(*kpad, dt.DIS_MEDIUM)
    r_fns = {"R0": (rk.refine_planes, refine_planes_plain, "refine_planes"),
             "R1s": (rk.refine_setup, refine_setup_plain, "refine_setup"),
             "R23": (rk.refine_update, refine_update_plain, "refine_update")}
    r_err = {k: 0.0 for k in (*r_fns, "R1w", "R23c", "R3k", "R3n")}
    rtimes, rcosts, rcold = {}, {}, {}
    r1_library = None
    for label, cfg, levels, planes in (
            ("1080p medium", dt.DIS_MEDIUM, med_levels, med_planes),
            ("1080p full", dt.DIS_FULL, full_levels, full_planes),
            (f"KITTI medium B={nk}", dt.DIS_MEDIUM, kmed_levels, kmed_planes)):
        steps = refine_step_inputs(refine_inputs(cfg, levels, planes, 0),
                                   {"R0": (0,), "R1s": (0,),
                                    "R23": (1, cfg.refinement_inner_sweeps - 1)})
        check(len(steps["R23"]) == 2, f"R23 {label}: {len(steps['R23'])} recorded calls")
        for k, (kern, plain, op) in r_fns.items():
            check(len(steps[k]) == (2 if k == "R23" else 1),
                  f"{k} {label}: {len(steps[k])} recorded calls")
            for args in steps[k]:
                if k == "R23":
                    r_err[k] = max(r_err[k], r23_gate(label, args))
                    continue
                before = kern.launches
                got, want = flat_tensors(kern(*args)), flat_tensors(plain(*args))
                torch.cuda.synchronize()
                check(kern.launches == before + 1, f"{k} {label}: not one launch")
                check(len(got) == len(want), f"{k} {label}: {len(got)} outputs, plain "
                      f"{len(want)}")
                for g, v in zip(got, want):
                    r_err[k] = max(r_err[k], float((g.float() - v.float()).abs().max()))
                    check(g.shape == v.shape and torch.equal(g, v),
                          f"{k} {label}: differs from its plain version")
            args = steps[k][0]
            km = replay_ms(lambda: kern(*args))
            pm, prm = time_ms(lambda: plain(*args)), replay_ms(lambda: plain(*args))
            nbytes, ops = cost.op_cost(op, args)
            bms, by = bound(nbytes, ops)
            cold = ""
            if label == "1080p medium":
                rtimes[k], rcosts[k] = (km, pm), (nbytes, ops)
                rcold[k] = cold_replay_ms(kern, args, nbytes)
                cold = (f", on inputs out of the L2 {rcold[k]:.4f} ms "
                        f"({100.0 * bms / rcold[k]:.0f}%)")
            if label == "1080p medium" and k == "R1s":
                r1_library = grid_sample_ms(*args[:2], refine_warp_plain(*args[:2])[0], card)
            print(f"phase1e {label} {k} {tuple(args[0].shape)}: {len(steps[k])} call(s) "
                  f"bitwise equal to the plain version; kernel {km:.4f} ms replayed "
                  f"({100.0 * bms / km:.0f}% of its bound){cold}, plain {pm:.4f} ms "
                  f"({prm:.4f} ms replayed), bound {bms:.4f} ms by {by} [{card}]", flush=True)
        if label == "1080p medium":
            compose_args = steps["R23"][1]
            u0v0dudv = compose_args[9:13]   # u0, v0 and the last update's du, dv
        del steps
    del kmed_levels, kmed_planes
    # R23 at each level of the benchmark's 1080p hd1080_medium frame (1080
    # rows padded to 1088 for its coarsest scale 5).
    hd_cfg = bench_config("hd1080_medium")
    (ha, _), (hb, _) = (im.pad_divisible(t, hd_cfg.coarsest_scale) for t in (a, b))
    hd_levels, hd_planes = refined_levels(ha, hb, hd_cfg)
    del ha, hb
    for scale in range(hd_cfg.coarsest_scale, hd_cfg.finest_scale - 1, -1):
        calls = refine_step_inputs(refine_inputs(hd_cfg, hd_levels, hd_planes, scale),
                                   {"R23": (1, hd_cfg.refinement_inner_sweeps - 1)})["R23"]
        check(len(calls) == 2, f"R23 hd1080_medium level {scale}: {len(calls)} calls")
        for args in calls:
            r_err["R23"] = max(r_err["R23"], r23_gate(f"hd1080_medium level {scale}", args))
        args = calls[0]
        km = replay_ms(lambda: rk.refine_update(*args))
        bms, by = bound(*cost.op_cost("refine_update", args))
        print(f"phase1e hd1080_medium level {scale} R23 {tuple(args[0].shape)}: 2 calls "
              f"bitwise equal to the plain version; kernel {km:.4f} ms replayed "
              f"({100.0 * bms / km:.0f}% of its bound), tiles "
              f"{update_plan(1, *args[0].shape[-2:], 5)} [{card}]", flush=True)
    del hd_levels, hd_planes, calls, args
    warp1_cfg = dataclasses.replace(dt.DIS_MEDIUM, refinement_scheme="warp1")
    w1_levels, w1_planes = refined_levels(a, b, warp1_cfg)
    w1_steps = refine_step_inputs(refine_inputs(warp1_cfg, w1_levels, w1_planes, 0),
                                  {"R1w": (0,), "R23": (1, warp1_cfg.refinement_inner_sweeps - 1)})
    w1_args = w1_steps["R1w"]
    check(len(w1_args) == 1 and len(w1_steps["R23"]) == 2,
          f"1080p medium warp1: {len(w1_args)} R1w, {len(w1_steps['R23'])} R23 calls")
    for args in w1_steps["R23"]:
        r_err["R23"] = max(r_err["R23"], r23_gate("1080p medium warp1", args))
    print("phase1e 1080p medium warp1 R23: 2 calls bitwise equal to the plain version",
          flush=True)
    del w1_steps
    # name: (wrapper, plain version, op, op's arguments beside the
    # wrapper's, the wrapper's arguments checked, the timed ones first)
    modes = {"R1w": (rk.refine_setup_warp1, refine_setup_warp1_plain, "refine_setup_warp1",
                     (), [w1_args[0]]),
             "R23c": (rk.refine_update, refine_update_plain, "refine_update", (),
                      [compose_args]),
             "R3k": (rk.refine_update, refine_update_plain, "refine_update", (True,),
                     [(*compose_args, CLIP_BOUND)]),
             "R3n": (rk.refine_nosweep, refine_nosweep_plain, "refine_nosweep", (False, 0.0),
                     [u0v0dudv, (*u0v0dudv, CLIP_BOUND)])}
    for k, (kern, plain, op, flags, calls) in modes.items():
        for args in calls:
            before = kern.launches
            got, want = flat_tensors(kern(*args)), flat_tensors(plain(*args))
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{k}: not one launch")
            check(len(got) == len(want), f"{k}: {len(got)} outputs, plain {len(want)}")
            for g, v in zip(got, want):
                r_err[k] = max(r_err[k], float((g - v).abs().max()))
                check(g.shape == v.shape and torch.equal(g, v),
                      f"{k} {tuple(g.shape)}: differs from its plain version")
            if isinstance(args[-1], float) and args[-1] == CLIP_BOUND:
                check(bool((got[0].abs() == CLIP_BOUND).any()), f"{k}: the clip never binds")
        args = calls[0]
        op_args = args[:-1] + flags + args[-1:] if k == "R3k" else args + flags
        km = replay_ms(lambda: kern(*args))
        pm, prm = time_ms(lambda: plain(*args)), replay_ms(lambda: plain(*args))
        nbytes, ops = cost.op_cost(op, op_args)
        bms, by = bound(nbytes, ops)
        rtimes[k], rcosts[k] = (km, pm), (nbytes, ops)
        rcold[k] = cold_replay_ms(kern, args, nbytes)
        print(f"phase1e 1080p medium {k} {tuple(args[0].shape)}: {len(calls)} call(s) bitwise "
              f"equal to the plain version; kernel {km:.4f} ms replayed ({100.0 * bms / km:.0f}% "
              f"of its bound), on inputs out of the L2 {rcold[k]:.4f} ms "
              f"({100.0 * bms / rcold[k]:.0f}%), plain {pm:.4f} ms ({prm:.4f} ms replayed), "
              f"bound {bms:.4f} ms by {by} [{card}]", flush=True)
    del w1_args, compose_args, u0v0dudv, modes

    # -- phase 1f: each scale's glue, S1, S3 and S4 ------------------------------
    # Each on the inputs the main path gives it at the finest scale (its last
    # call in a run, recorded by scale_step_inputs) of the 1080p compat and
    # DIS_FAST frames, the KITTI B = 8 config 3 batch, stripe 1 of 3 of the
    # 4K compat frame (row0 544: its patch rows, output window and coarser
    # flow's row offset) and the 1080p DIS_FULL frame (ps 12, stride 3), and
    # S1 also at the 1080p compat coarsest scale (its first call: no coarser
    # flow), bitwise equal to its plain version (S1: templates_plain, then
    # search_start_plain for the start it writes); then timed beside it
    # (kernel replayed, plain eager and replayed) with its bound, and S1 also
    # without the start and the start's plain version alone.
    from dis_tpu_torch.ops.cuda import scale_kernel as sk
    from dis_tpu_torch.ops.densify import densify_plain, fixed_weights_plain

    s_fns = {"S1": (sk.scale_templates, iclk.scale_templates_plain, "scale_templates"),
             "S3": (sk.fixed_weights, fixed_weights_plain, "fixed_weights"),
             "S4": (sk.densify, densify_plain, "densify")}
    s_err = dict.fromkeys(("S1", "S2", "S3", "S4"), 0.0)
    stimes, scosts = {}, {}
    srow0, sext, sown0, sownh = stripe_bounds(bench_cfg, H4K, N_STRIPES, 1, halo)
    for label, cfg, run in (
            ("1080p compat", bench_cfg, lambda: dt.dis_flow(a, b, bench_cfg)),
            ("1080p fast", dt.DIS_FAST, lambda: dt.dis_flow(a, b, dt.DIS_FAST)),
            (f"KITTI config3 B={nk}", cfg3, lambda: dt.dis_flow(ka, kb, cfg3)),
            (f"4K compat stripe 1 of {N_STRIPES} (row0 {srow0})", bench_cfg,
             lambda: dis_flow_stripe(a4[srow0:srow0 + sext], b4[srow0:srow0 + sext], bench_cfg,
                                     srow0, sown0, sownh, H4K)),
            ("1080p full", dt.DIS_FULL, lambda: dt.dis_flow(a, b, dt.DIS_FULL))):
        steps = scale_step_inputs(run)
        levels = cfg.coarsest_scale - cfg.finest_scale + 1
        check(sorted(steps) == sorted(glue_counts(cfg, 1))
              and all(len(v) == levels for v in steps.values()),
              f"1f {label}: calls {({k: len(v) for k, v in steps.items()})}")
        cases = [(k, label, v[-1]) for k, v in sorted(steps.items())]
        if label == "1080p compat":
            cases.insert(0, ("S1", f"{label} coarsest", steps["S1"][0]))
        for k, case, args in cases:
            kern, plain, op = s_fns[k]
            if k == "S1":   # the start: from the coarser flow (none at the coarsest scale)
                coarsest = case.endswith("coarsest")
                check(args[14] is not None and (args[10] is None) == coarsest
                      and (args[13] > 0) == ("stripe" in case),
                      f"S1 {case}: start inputs flow {args[10] is not None}, row offset "
                      f"{args[13]}")
            before = kern.launches
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{k} {case}: not one launch")
            parts = [(k, got, want)]
            if k == "S1":
                parts = [("S1", got[:2], want[:2]), ("S2", got[2], want[2])]
            for part, g_, w_ in parts:
                g_, w_ = flat_tensors(g_), flat_tensors(w_)
                check(len(g_) == len(w_), f"{part} {case}: {len(g_)} outputs, plain {len(w_)}")
                for g, v in zip(g_, w_):
                    s_err[part] = max(s_err[part], float((g.float() - v.float()).abs().max())
                                      if g.numel() else 0.0)
                    check(g.shape == v.shape and torch.equal(g, v),
                          f"{part} {case}: differs from its plain version")
            km = replay_ms(lambda: kern(*args))
            pm, prm = time_ms(lambda: plain(*args)), replay_ms(lambda: plain(*args))
            nbytes, ops = cost.op_cost(op, args)
            bms, by = bound(nbytes, ops)
            if case == ("1080p fast" if k == "S3" else "1080p compat"):
                stimes[k], scosts[k] = (km, pm), (nbytes, ops)
            shape = tuple(args[0].shape) if args[0] is not None else ''
            print(f"phase1f {case} {k} {shape} -> {tuple(flat_tensors(got)[0].shape)}: bitwise "
                  f"equal to the plain version; kernel {km:.4f} ms replayed "
                  f"({100.0 * bms / km:.0f}% of its bound), plain {pm:.4f} ms ({prm:.4f} ms "
                  f"replayed), bound {bms:.4f} ms by {by} [{card}]", flush=True)
            if k == "S1":
                # The start's share of S1: S1 on the same inputs without it,
                # and the start's plain version alone.
                bare_args = args[:10] + (None, None, None, 0, None, 0, 0)
                bare = replay_ms(lambda: kern(*bare_args))
                nb = args[0].shape[0] if args[0].ndim == 3 else 0
                start_args = args[10:15] + (args[8], args[15], args[16], nb)
                spm = time_ms(lambda: iclk.search_start_plain(*start_args))
                sbytes, sops = cost.start_cost(max(nb, 1), args[3], args[4],
                                               args[10] is not None)
                sbms, sby = bound(sbytes, sops)
                if case == "1080p compat":
                    stimes["S2"], scosts["S2"] = (km - bare, spm), (sbytes, sops)
                print(f"phase1f {case} S1 without the start {bare:.4f} ms replayed, so the "
                      f"start adds {km - bare:.4f} ms inside S1 (its own bound {sbms:.4f} ms "
                      f"by {sby}); the start's plain version {spm:.4f} ms [{card}]",
                      flush=True)
        if label in ("1080p compat", "1080p full"):
            # S4 beside a fill of its flow's bytes: the card's stores alone.
            flow = sk.densify(*steps["S4"][-1])
            print(f"phase1f {label} S4 beside a fill of its flow's bytes (zero_) "
                  f"{replay_ms(flow.zero_):.4f} ms [{card}]", flush=True)
        if label == "1080p full":
            # S4 on the same grid, u and weights with wider covers: its bytes
            # barely move while each pixel's staged sums grow with kr * kc
            # (4 x 4 takes the kernel's generic instance, 3 x 3 and 5 x 5
            # its unrolled ones).
            from dis_tpu_torch.ops.grid import scale_plan

            u, wts, crows, ccols, _, num_w, num_h = steps["S4"][-1]
            sweep = []
            for ps in S4_SWEEP_PS:
                plan = scale_plan(ccols.shape[0], crows.shape[0], cfg.steps, ps, u.device)
                check((plan.geom.num_w, plan.geom.num_h) == (num_w, num_h)
                      and (ps != cfg.patch_size or (torch.equal(plan.cover_rows, crows)
                                                    and torch.equal(plan.cover_cols, ccols))),
                      f"S4 sweep {label} ps {ps}: not the recorded grid")
                kr, kc = plan.cover_rows.shape[1], plan.cover_cols.shape[1]
                for weights in (wts, None):
                    args = (u, weights, plan.cover_rows, plan.cover_cols, plan.uniform_wsum,
                            num_w, num_h)
                    weighting = "uniform" if weights is None else "weighted"
                    check(torch.equal(sk.densify(*args), densify_plain(*args)),
                          f"S4 {label} {kr} x {kc} {weighting}: differs from its plain version")
                    km = replay_ms(lambda: sk.densify(*args))
                    bms, by = bound(*cost.op_cost("densify", args))
                    sweep.append(f"{kr} x {kc} {weighting} {km:.4f} ({100.0 * bms / km:.0f}% of "
                                 f"{bms:.4f} by {by})")
            print(f"phase1f {label} S4 by covers (grid rows x columns a pixel, ms replayed, "
                  f"each bitwise equal to its plain version): {'; '.join(sweep)} [{card}]",
                  flush=True)
        del steps

    # -- phase 1g: the frame's glue, F1, F2 and F3 --------------------------------
    # Each on the inputs the main path gives it (frame_step_inputs) in the
    # dis_flow calls of the KITTI B = 8 batch under DIS_MEDIUM (F1, F2) and
    # DIS_ULTRAFAST (F1, F3), the 1080p DIS_FULL frame (F1: 1080 rows padded
    # to 1088; F2 on the padded frame) and the 1080p DIS_MEDIUM frame (F2),
    # bitwise equal to its plain version (the op's CPU function, the plain
    # torch code in the op's layout, run on the card); then timed beside it
    # with its bound, F1 and F3 also beside the library call that computes
    # the same function on the same inputs (one F.pad, replicate, of both
    # images stacked; one F.interpolate, bilinear, of the scaled flow made
    # planar, the uncropped frame).
    from dis_tpu_torch.ops.cuda import frame_kernel as fkern

    f_fns = {"F1": (fkern._pad_cuda, fkern._pad_cpu, "frame_pad"),
             "F2": (fkern._levels_cuda, fkern._levels_cpu, "intensity_levels"),
             "F3": (fkern._finish_cuda, fkern._finish_cpu, "frame_finish")}
    f_err = dict.fromkeys(f_fns, 0.0)
    ftimes, fcosts, f_library, f_floor, f_cold = {}, {}, {}, {}, {}
    for label, cfg, x, y, want, timed in (
            (f"KITTI medium B={nk}", dt.DIS_MEDIUM, ka, kb, ("F1", "F2"), ("F1",)),
            (f"KITTI ultrafast B={nk}", dt.DIS_ULTRAFAST, ka, kb, ("F1", "F3"), ("F3",)),
            ("1080p full", dt.DIS_FULL, a, b, ("F1", "F2"), ()),
            ("1080p medium", dt.DIS_MEDIUM, a, b, ("F2",), ("F2",))):
        steps = frame_step_inputs(lambda: dt.dis_flow(x, y, cfg))
        check(sorted(steps) == sorted(want) and all(len(v) == 1 for v in steps.values()),
              f"1g {label}: calls {({k: len(v) for k, v in steps.items()})}")
        for k in want:
            kern, plain, op = f_fns[k]
            args = steps[k][0]
            got, ref = flat_tensors(kern(*args)), flat_tensors(plain(*args))
            torch.cuda.synchronize()
            check(len(got) == len(ref), f"{k} {label}: {len(got)} outputs, plain {len(ref)}")
            for g, v in zip(got, ref):
                f_err[k] = max(f_err[k], float((g - v).abs().max()))
                check(g.shape == v.shape and torch.equal(g, v),
                      f"{k} {label}: differs from its plain version")
            km = replay_ms(lambda: kern(*args))
            pm, prm = time_ms(lambda: plain(*args)), replay_ms(lambda: plain(*args))
            nbytes, ops = cost.op_cost(op, args)
            bms, by = bound(nbytes, ops)
            lib = ""
            if k == "F1":
                stacked = torch.stack(args[:2])
                pads = (args[4], args[5], args[2], args[3])
                lms = replay_ms(lambda: torch.nn.functional.pad(stacked, pads,
                                                                mode="replicate"))
                lib = f", F.pad {lms:.4f} ms replayed"
            elif k == "F3":
                flow, f = args[0], args[1]
                planar = (flow * float(2 ** f)).movedim(-1, -3).contiguous()
                planar = planar if planar.ndim == 4 else planar[None]
                size = (flow.shape[-3] << f, flow.shape[-2] << f)

                def upsample():
                    return torch.nn.functional.interpolate(planar, size=size, mode="bilinear",
                                                           align_corners=False)

                t, l, hh, ww = args[2:6]
                up = upsample()[..., t:t + hh, l:l + ww].movedim(-3, -1)
                lms = replay_ms(upsample)
                lib = (f", F.interpolate {lms:.4f} ms replayed (max |d| "
                       f"{float((up - got[0].reshape(up.shape)).abs().max())} from F3)")
            if k in timed:
                ftimes[k], fcosts[k] = (km, pm), (nbytes, ops)
                f_library[k] = lms if k in ("F1", "F3") else None
                f_floor[k] = fill_floor(nbytes, dev)
                f_cold[k] = cold_replay_ms(kern, args, nbytes)
                lib += (f", floor: a fill of its {nbytes / 1e6:.2f} MB {f_floor[k][0]:.4f} ms, a "
                        f"copy of them {f_floor[k][1]:.4f} ms, replayed; kernel on inputs out "
                        f"of the L2 {f_cold[k]:.4f} ms ({100.0 * bms / f_cold[k]:.0f}%)")
            print(f"phase1g {label} {k} {tuple(args[0].shape)} -> {tuple(got[0].shape)}: "
                  f"bitwise equal to the plain version; kernel {km:.4f} ms replayed "
                  f"({100.0 * bms / km:.0f}% of its bound), plain {pm:.4f} ms ({prm:.4f} ms "
                  f"replayed){lib}, bound {bms:.4f} ms by {by} [{card}]", flush=True)
        del steps
    # F2's levels 4 and 5 in one launch and its scalar path (a row of 66
    # floats), F3 at 2^finest = 4 with an odd crop and at 2 with an even
    # left edge (its float2 stores): shapes no main-path call above gives
    # them, on random inputs.
    gen = torch.Generator().manual_seed(16)

    def rand(*shape, scale=255.0):
        return (torch.rand(shape, generator=gen) * scale).to(dev)

    for k, label, args in (
            ("F2", "5 levels of 1088x1920", (rand(1088, 1920), rand(1088, 1920), 5)),
            ("F2", "1 level of 2x64x66", (rand(2, 64, 66), rand(2, 64, 66), 1)),
            ("F3", "x4, crop 185x621 at (1, 3)", (rand(3, 47, 157, 2, scale=8.0), 2, 1, 3, 185,
                                                  621)),
            ("F3", "x2, crop 90x300 at (0, 2)", (rand(2, 48, 160, 2, scale=8.0), 1, 0, 2, 90,
                                                 300))):
        kern, plain, _ = f_fns[k]
        got, ref = flat_tensors(kern(*args)), flat_tensors(plain(*args))
        torch.cuda.synchronize()
        for g, v in zip(got, ref, strict=True):
            f_err[k] = max(f_err[k], float((g - v).abs().max()))
            check(g.shape == v.shape and torch.equal(g, v),
                  f"{k} {label}: differs from its plain version")
        print(f"phase1g {k} {label}: bitwise equal to the plain version", flush=True)

    # -- phase 1h: K1's plane mode against K2 then K1 at patch 12 ------------
    # The finest scale of the benchmark's medium configurations (OpenCV's
    # PRESET_MEDIUM at 1920x1080 and 3840x2160), on the inputs their served
    # path gives the search: K1's plane mode bitwise equal to K2 then K1
    # and to its plain composition, each timed with its bound.
    plane_rows = []
    for name, (x, y) in (("hd1080_medium", (a, b)), ("uhd4k_medium", (a4, b4))):
        cfg = bench_config(name)
        iclk_search.split_launches = iclk_search_plane.split_launches = 0
        plane, pos0, args, geom = served_search_inputs(cfg, x, y)
        # A medium pair takes K1's split layout at every scale.
        split = (iclk_search.split_launches, iclk_search_plane.split_launches)
        scales = cfg.coarsest_scale - cfg.finest_scale + 1
        print(f"phase1h {name} pair: split_launches {split}, scales {scales}", flush=True)
        check(split == (scales, scales), f"{name}: split_launches {split}, want {scales}")
        ps, n = cfg.patch_size, pos0.shape[-2]
        kr = extract_regions(plane, pos0, ps, ps, num_h=geom.num_h)
        k1 = iclk_search(*kr, *args)
        trips = []
        pr = iclk.extract_regions_plain(plane, pos0, ps, ps)
        po = iclk.iclk_search_plain(*pr, *args, trips=trips)
        torch.cuda.synchronize()
        for kt, pt in zip(kr + k1, pr + po):
            check(torch.equal(kt, pt), f"K2/K1 {name} finest: differ from their plain versions")
        plane_gate(f"{name} finest", plane, pos0, args, po)
        del pr, po
        calls = 5 if n > 100_000 else 20
        k2_cost = extract_cost(plane, pos0, ps)
        k1_cost = search_cost(args[3], args[4], cfg, trips)
        kp_cost = search_plane_cost(plane, args[3], args[4], cfg, trips)
        row = {"name": f"{name} finest", "ps": ps, "n": n, "plane": list(plane.shape),
               "trips": sum(trips), "bitwise": True,
               "K2_ms": replay_ms(lambda: extract_regions(plane, pos0, ps, ps,
                                                          num_h=geom.num_h), calls=calls),
               "K1_ms": replay_ms(lambda: iclk_search(*kr, *args), calls=calls),
               "K2_K1_ms": replay_ms(lambda: iclk_search(
                   *extract_regions(plane, pos0, ps, ps, num_h=geom.num_h), *args),
                   calls=calls),
               "K1p_ms": replay_ms(lambda: iclk_search_plane(plane, pos0, *args),
                                   calls=calls),
               "K1p_plain_ms": time_ms(lambda: iclk.iclk_search_plain(
                   *iclk.extract_regions_plain(plane, pos0, ps, ps), *args), reps=3, warmup=1)}
        for k, c in (("K2", k2_cost), ("K1", k1_cost), ("K1p", kp_cost)):
            row[k + "_bound_ms"], row[k + "_bound_by"] = bound(*c)
        plane_rows.append(row)
        del kr, k1
    print("phase1h " + json.dumps({"search_plane": plane_rows}) + f" [{card}]", flush=True)

    # -- phase 2: the main path ---------------------------------------------
    wrappers = kernel_wrappers()
    launches = dict.fromkeys(COUNTED, 0)
    flows = {}
    for name, cfg in configs.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a, b, cfg)
        torch.cuda.synchronize()
        counts = read_counts(wrappers)
        print(f"phase2 {name} launches {counts}", flush=True)
        check(counts == {**scale_counts(cfg), "K2c": 0}, f"{name}: launches {counts}, want "
              f"{scale_counts(cfg)} and no K2c at 1080p")
        modes = read_modes(wrappers)
        check(modes == mode_counts(cfg), f"{name}: modes {modes}, want {mode_counts(cfg)}")
        for k in ("K3", "K1", *glue_counts(cfg, 1), *modes):
            check({**counts, **modes}[k] > 0,
                  f"{name}: kernel {k} was not launched on the main path")
            launches[k] += {**counts, **modes}[k]
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
        fn = batched_flow_fn(cfg)
        runs = {}
        for label, call, frame in (("batched_flow_fn", lambda: fn(*kpad), None),
                                   ("dis_flow", lambda: dt.dis_flow(ka, kb, cfg), (KH, KW))):
            want = scale_counts(cfg, frame)
            for w in wrappers.values():
                w.launches = 0
            runs[label] = call()
            torch.cuda.synchronize()
            counts = read_counts(wrappers)
            print(f"phase2b {name} {label} B={nk} launches {counts}", flush=True)
            check(counts == {**want, "K2c": 0},
                  f"{name} {label}: launches {counts}, want {want} per batch")
            kl["K2b"] += counts["K2"]
            kl["K1b"] += counts["K1"]
            launches["K1p"] += read_modes(wrappers).get("K1p", 0)
            for k in (*glue_counts(cfg, 1), *(frame_counts(cfg, *frame) if frame else ())):
                launches[k] += counts[k]
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
        want = scale_counts(cfg, shape[:2])
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
    want4 = want_4k(bench_cfg)
    flows4 = {}
    for name, cfg in {**configs, "ultrafast": dt.DIS_ULTRAFAST}.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a4, b4, cfg)
        torch.cuda.synchronize()
        counts = read_counts(wrappers)
        print(f"phase2d 4K {name} launches {counts}", flush=True)
        if name == "ultrafast":
            check(counts["K2c"] == counts["K2"] == 0 and counts["K1"] == 3,
                  f"4K ultrafast: launches {counts}")
            continue
        check(counts == want_4k(cfg), f"4K {name}: launches {counts}, want {want_4k(cfg)}")
        for k in ("K2c", *glue_counts(cfg, 1)):
            launches[k] += counts[k]
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
    counts = read_counts(wrappers)
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
        counts = read_counts(wrappers)
        parts = N_STRIPES if label.startswith("tiled") else 1
        check(counts["K2c"] == counts["K2"] == 0 and counts["K1"] == 4 * N_STRIPES
              and read_modes(wrappers)["K1p"] == 4 * N_STRIPES and counts["K3"] == 2 * parts,
              f"4K {label}: launches {counts}")
        check(torch.equal(out, untiled), f"4K {label}: differs from the untiled flow")
        print(f"phase2e 4K {label} (row0 {rows0}): launches {counts}; bitwise equal to "
              f"untiled", flush=True)
    del untiled, out

    # -- phase 2f: refinement presets at 1080p ----------------------------------
    refined = {"medium": dt.DIS_MEDIUM, "full": dt.DIS_FULL, "warp1": warp1_cfg}
    want_refined = {"medium": {"K3": 2, "K2": 0, "K2c": 0, "K1": 4,
                               "R0": 4, "R1": 4, "R23": 20,
                               "S1": 4, "S3": 4, "S4": 4, "F2": 1},
                    "warp1": {"K3": 2, "K2": 0, "K2c": 0, "K1": 4,
                              "R1": 4, "R23": 20,
                              "S1": 4, "S3": 4, "S4": 4, "F2": 1},
                    "full": {"K3": 4, "K2": 0, "K2c": 0, "K1": 5,
                             "R0": 5, "R1": 5, "R23": 50,
                             "S1": 5, "S3": 5, "S4": 5, "F1": 1, "F2": 1}}
    rflows = {}
    for name, cfg in refined.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a, b, cfg)
        torch.cuda.synchronize()
        counts, modes = read_counts(wrappers), read_modes(wrappers)
        print(f"phase2f {name} launches {counts}, modes {modes}", flush=True)
        check(counts == want_refined[name] == {**scale_counts(cfg, (H, W)), "K2c": 0},
              f"{name}: launches {counts}, want {want_refined[name]}")
        check(modes == mode_counts(cfg), f"{name}: modes {modes}, want {mode_counts(cfg)}")
        for k in launches:
            launches[k] += {**counts, **modes}.get(k, 0)
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
    rlevels = {"medium": (med_levels, med_planes), "full": (full_levels, full_planes),
               "warp1": (w1_levels, w1_planes)}
    crops = {"medium": (0, 0), "full": (fpw, fph), "warp1": (0, 0)}
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
    for label, call, frame in (
            ("batched_flow_fn", lambda: batched_flow_fn(med_cfg)(*kpad), None),
            ("dis_flow", lambda: dt.dis_flow(ka, kb, med_cfg), (KH, KW))):
        for w in wrappers.values():
            w.launches = 0
        out = call()
        torch.cuda.synchronize()
        counts, modes = read_counts(wrappers), read_modes(wrappers)
        check(counts == {**scale_counts(med_cfg, frame), "K2c": 0}
              and modes == mode_counts(med_cfg), f"KITTI medium {label}: launches {counts}, "
              f"modes {modes}")
        for k, n in {**counts, **modes}.items():
            if k in launches and k not in CORE:
                launches[k] += n
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
        check(gl == {**scale_counts(med_cfg, shape[:2]), "K2c": 0},
              f"medium {label}: graph holds {gl}")
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
        counts = read_counts(wrappers)
        rc = refine_counts(fin_cfg if "refine_per_level=False" in label else med_cfg)
        check({k: counts.get(k, 0) for k in rc} == rc,
              f"1080p medium {label}: launches {counts}, want {rc}")
        check(torch.equal(out, want), f"1080p medium {label}: differs from the untiled flow")
        flow_gates(f"1080p medium {label}", out.cpu().numpy(), SHIFT)
        print(f"phase2g 1080p medium {label}: launches {counts}; bitwise equal to untiled",
              flush=True)
    del untiled, untiled_fin, out

    # The clamped frames clip in R23's compose mode, or in R3's no-sweep mode
    # where a level makes no weight update: no clamp op runs.
    clamped_cfg = dataclasses.replace(med_cfg, refined_init_clamp=True)
    nosweep_cfg = dataclasses.replace(clamped_cfg, refinement_inner_sweeps=0)
    for label, img1, img2, cfg in (
            ("4K medium", a4, b4, med_cfg),
            ("1080p medium clamped", a, b, clamped_cfg),
            ("4K medium clamped", a4, b4, clamped_cfg),
            ("1080p medium clamped, no weight update", a, b, nosweep_cfg)):
        want = {**scale_counts(cfg), "K2c": 0}
        for w in wrappers.values():
            w.launches = 0
        flow, aten = aten_calls(lambda: dt.dis_flow(img1, img2, cfg))
        torch.cuda.synchronize()
        counts, modes = read_counts(wrappers), read_modes(wrappers)
        check(counts == want, f"{label}: launches {counts}, want {want}")
        check(modes == mode_counts(cfg), f"{label}: modes {modes}, want {mode_counts(cfg)}")
        clamps = {n: c for n, c in aten.items() if "clamp" in n or "clip" in n}
        check(not clamps, f"{label}: torch clamps {clamps}")
        for k, n in {**counts, **modes}.items():
            if k in launches and k not in CORE:
                launches[k] += n
        med, epe = flow_gates(label, flow.cpu().numpy(), SHIFT)
        print(f"phase2g {label}: launches {counts}, modes {modes}, {sum(aten.values())} torch "
              f"ops, none a clamp; median {med.tolist()} epe {epe}", flush=True)
        if label == "4K medium":
            flow4_med = flow
        if cfg is nosweep_cfg:
            bare = dt.dis_flow(a, b, dataclasses.replace(cfg, refinement_iters=0))
            check(torch.equal(flow, bare), f"{label}: differs from the frame without refinement")
            print(f"phase2g {label}: equal to the frame without refinement", flush=True)
            del bare
        del flow

    # -- phase 2h: the saved serving artifact (torch.export) ----------------------
    t2h = time.perf_counter()
    for label, cfg, shape, inputs, eager, want in (
            ("1080p", bench_cfg, (H, W, None), (a, b), flows["compat"],
             {**scale_counts(bench_cfg), "K2c": 0}),
            ("kitti", cfg3, (KH, KW, nk), (ka, kb), kflows["config3"],
             {**scale_counts(cfg3, (KH, KW)), "K2c": 0}),
            ("4K", bench_cfg, (H4K, W4K, None), (a4, b4), flows4["compat"], want4),
            ("1080p medium", med_cfg, (H, W, None), (a, b), rflows["medium"],
             {**scale_counts(med_cfg), "K2c": 0})):
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
        check(plain == 0, f"{label} artifact: {plain} gathers of a plain K2, K1 or R1")
        for _ in range(2):
            out = run(*inputs)
            torch.cuda.synchronize()
            check(torch.equal(out, eager), f"{label} artifact: reloaded flow differs "
                  "from the eager kernel path")
        if label == "1080p medium":
            check(torch.equal(out, served_med["1080p"](a, b)),
                  "1080p medium artifact: its replay differs from aot_compile's")
        check(run.graph_launches == want,
              f"{label} artifact: graph holds {run.graph_launches}")
        line = (f"phase2h {label} batch={shape[2]}: export {made:.2f} s, {len(data)} "
                f"bytes, {len(program.graph.nodes)} graph nodes, kernel ops {ops}; loaded "
                f"in this process in {loaded:.2f} s, 2 replays bitwise equal to the eager "
                f"kernel path")
        if label == "1080p":
            turns = in_turns({"artifact": run, "aot_compile": served["1080p"]}, a, b)
            line += f"; replayed ms/frame in turns {turns}"
        if label == "1080p medium":
            line += "; its replay bitwise equal to aot_compile's"
        print(f"{line} [{card}]", flush=True)
        del run, program, data
    served_cost = served["1080p"].cost_analysis()
    print("phase2h 1080p cost_analysis: " + json.dumps(served_cost), flush=True)
    med_cost = served_med["1080p"].cost_analysis()
    print("phase2h 1080p medium cost_analysis: " + json.dumps(
        {k: v for k, v in med_cost.items() if k != "kernels"}) + "; launches by kernel "
        + json.dumps({k: len(v) for k, v in med_cost["kernels"].items()}), flush=True)
    print("phase2h 1080p memory_analysis: " + json.dumps(served["1080p"].memory_analysis()),
          flush=True)
    print(f"phase2h took {time.perf_counter() - t2h:.2f} s", flush=True)

    # -- phase 2i: small frames -------------------------------------------------
    # dis_flow on the card at frames whose coarse planes are shorter than a
    # region (rc = 19 at ps 8) and whose coarsest level is under 2 x 2:
    # 8 x 64 (level 3 one row), 9 x 64 and 16 x 64 (two rows; 9 rows pad to
    # 16), 64 x 16 (two columns), 64 x 8 (one) and 1 x 1 (padded to 8 x 8),
    # under compat, DIS_FAST
    # and DIS_MEDIUM, and a batch of 2 under compat (K2b, K1b).  Each
    # call's launches are counted from 0 and add to the kernels line's;
    # every kernel call it makes (the ops' CUDA functions, recorded) is
    # held bitwise to its plain version on the same inputs; the flow,
    # finite, to the same call's on the CPU under the phase-2 gates.
    small_fns = op_functions()
    small_calls = 0
    t_small = time.perf_counter()
    for sh_, sw_ in SMALL_FRAMES:
        for name, cfg, nb_ in (("compat", dt.DIS_COMPAT_DEFAULT, 0),
                               ("compat", dt.DIS_COMPAT_DEFAULT, 2),
                               ("fast", dt.DIS_FAST, 0), ("medium", dt.DIS_MEDIUM, 0)):
            pairs = [small_pair(sh_, sw_, seed) for seed in range(max(nb_, 1))]
            x, y = (torch.from_numpy(np.stack([q[j] for q in pairs]) if nb_ else pairs[0][j])
                    for j in (0, 1))
            label = f"{sh_}x{sw_} {name}" + (f" B={nb_}" if nb_ else "")
            for w in wrappers.values():
                w.launches = 0
            steps = op_step_inputs(lambda: dt.dis_flow(x.to(dev), y.to(dev), cfg), small_fns)
            flow = steps.pop("out")
            torch.cuda.synchronize()
            counts, modes = read_counts(wrappers), read_modes(wrappers)
            want = {**scale_counts(cfg, (sh_, sw_)), "K2c": 0}
            check(counts == want and modes == mode_counts(cfg),
                  f"2i {label}: launches {counts} {modes}, want {want} {mode_counts(cfg)}")
            for k, n in {**counts, **modes}.items():
                launches[k + "b" if nb_ and k in ("K2", "K1") else k] += n
            for k, calls in steps.items():
                mod, kern, plain = small_fns[k]
                for args in calls:
                    got = flat_tensors(getattr(mod, kern)(*args))
                    ref = flat_tensors(getattr(mod, plain)(*args))
                    check(len(got) == len(ref) and all(
                        g.shape == v.shape and torch.equal(g, v) for g, v in zip(got, ref)),
                        f"2i {label} {k}: differs from its plain version")
                    small_calls += 1
            cpu = dt.dis_flow(x, y, cfg)
            f = flow.cpu()
            check(f.shape == cpu.shape == (*x.shape, 2) and bool(torch.isfinite(f).all()),
                  f"2i {label}: flow {tuple(f.shape)}, finite {bool(torch.isfinite(f).all())}")
            d = torch.linalg.vector_norm(f - cpu, dim=-1)
            dmean, dfrac = float(d.mean()), float((d > 1e-2).float().mean())
            check(dmean <= 1e-3 and dfrac <= 0.01,
                  f"2i {label}: card vs CPU mean {dmean} frac {dfrac}")
            print(f"phase2i {label}: launches {counts}, every kernel call bitwise equal to its "
                  f"plain version ({sorted(steps)}); card vs CPU flow mean {dmean} frac>1e-2 "
                  f"{dfrac} (bitwise {torch.equal(f, cpu)})", flush=True)
            del steps
    print(f"phase2i: {small_calls} kernel calls held to their plain versions, "
          f"{time.perf_counter() - t_small:.2f} s [{card}]", flush=True)

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
    costs["K1p"] = search_plane_cost(l2.img, init_u, conv0, cfg, trips)
    times["K1p"] = (replay_ms(lambda: iclk_search_plane(l2.img, pos0, *args)),
                    time_ms(lambda: iclk.iclk_search_plain(
                        *iclk.extract_regions_plain(l2.img, pos0, 8, p), *args)))
    eager = {"K3": time_ms(lambda: construct_pyramid(a, 3, p)),
             "K2": time_ms(lambda: extract_regions(l2.img, pos0, 8, p, num_h=nh)),
             "K1": time_ms(lambda: iclk_search(*kr, *args)),
             "K1p": time_ms(lambda: iclk_search_plane(l2.img, pos0, *args))}
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
    # The 4K compat finest scale's search as the extraction route once ran
    # it (K2c, then K1 on its regions) and as it runs now (K1's plane
    # mode), bitwise equal, timed three runs each way in turns.
    search4 = (tpl4, Tn4, centers4, init4, conv04, bench_cfg, W4K, H4K)

    def banded_then_k1():
        return iclk_search(*extract_regions_banded(l2_4.img, pos04, 8, p, geom4, bound0),
                           *search4)

    def plane_mode():
        return iclk_search_plane(l2_4.img, pos04, *search4)

    for g, v in zip(banded_then_k1(), plane_mode()):
        check(torch.equal(g, v), "4K compat finest: K2c then K1 differs from the plane mode")
    runs = {"K2c then K1": [], "plane mode": []}
    for _ in range(3):
        for key, fn in (("K2c then K1", banded_then_k1), ("plane mode", plane_mode)):
            runs[key].append(replay_ms(fn, calls=5))
    print(f"phase3c 4K compat finest N={pos04.shape[0]} ps 8: K2c then K1 "
          f"{[round(t, 4) for t in runs['K2c then K1']]} ms, K1's plane mode "
          f"{[round(t, 4) for t in runs['plane mode']]} ms (replayed, 3 runs each in turns, "
          f"bitwise equal) [{card}]", flush=True)
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
    frame_ms, bare_ms = {}, {}
    for label, cfg, (x, y) in (("1080p medium", dt.DIS_MEDIUM, (a, b)),
                               ("1080p full", dt.DIS_FULL, (a, b)),
                               ("1080p warp1", warp1_cfg, (a, b)),
                               ("4K medium", dt.DIS_MEDIUM, (a4, b4))):
        cf = served_med["1080p"] if label == "1080p medium" else aot_compile(cfg, *x.shape)
        want = {"1080p medium": rflows["medium"], "1080p full": rflows["full"],
                "1080p warp1": rflows["warp1"], "4K medium": flow4_med}[label]
        check(torch.equal(cf(x, y), want), f"{label}: graph replay differs from eager")
        e = time_ms(lambda: dt.dis_flow(x, y, cfg), reps=5, warmup=1)
        r = time_ms(lambda: cf(x, y), reps=10)
        del cf
        # The same frame without refinement, replayed: the refinement's
        # share read inside one kind of graph.
        bare_cf = aot_compile(dataclasses.replace(cfg, refinement_iters=0), *x.shape)
        bare = time_ms(lambda: bare_cf(x, y), reps=10)
        del bare_cf
        frame_ms[label], bare_ms[label] = r, bare
        print(f"phase3d {label}: eager {e:.4f} ms/frame, replayed {r:.4f} ms/frame; "
              f"without refinement {bare:.4f} ms replayed, so the refinement takes "
              f"{r - bare:.4f} ms ({100.0 * (r - bare) / r:.1f}%) [{card}]", flush=True)
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
            for w in wrappers.values():
                w.launches = 0
            ops = torch_ops(lambda: variational_refinement(*args))
            rl = {k: v for k, v in read_counts(wrappers).items() if k[0] == "R"}
            total += ms
            print(f"phase3d 1080p {name} refinement at scale {scale} "
                  f"{tuple(args[2].shape[:-1])}: {ms:.4f} ms replayed; launches: "
                  f"{ops} torch ops and the kernels {rl} [{card}]", flush=True)
        # The per-level graphs hold 2 calls each, the frame's graph 1.
        frame, bare = frame_ms[f"1080p {name}"], bare_ms[f"1080p {name}"]
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

    # -- phase 6: the measurement tools ------------------------------------------
    for k, n in tools_phase(dev, card, bench_cfg, wrappers).items():
        launches[k] += n

    src = "dis_tpu_torch/csrc/"
    meta = {
        "K3": ("pyramid_level", src + "pyramid_level.cu",
               "dis_tpu/ops/pallas/pyramid_kernel.py:58", k3_err),
        "K1": ("iclk_search", src + "iclk.cu",
               "dis_tpu/ops/pallas/iclk_kernel.py:93", k1_err),
        "K1b": ("iclk_search_batched", src + "iclk.cu",
                "dis_tpu/ops/pallas/iclk_kernel.py:573", k1b_err),
        # K1 and K2 in one launch: K1 copies each region from the plane as
        # extract_kernel.py:259 does (bitwise K2 then K1, phase 1).
        "K1p": ("iclk_search_plane", src + "iclk.cu",
                "dis_tpu/ops/pallas/iclk_kernel.py:93", k1_err),
        # No pallas_call backs the refinement's kernels: they replace XLA's
        # fusions of the JAX package's refinement code (the level's Sobel
        # planes, _warp_bilinear and the setup of outer, inner, half_sweep
        # and the flow of outer).
        "R0": ("refine_planes", src + "refine_planes.cu", "dis_tpu/ops/variational.py:188",
               r_err["R0"]),
        "R1s": ("refine_setup", src + "variational.cu", "dis_tpu/ops/variational.py:220",
                r_err["R1s"]),
        "R1w": ("refine_setup_warp1", src + "refine_planes.cu",
                "dis_tpu/ops/variational.py:223", r_err["R1w"]),
        "R23": ("refine_update", src + "variational.cu", "dis_tpu/ops/variational.py:252",
                r_err["R23"]),
        "R23c": ("refine_update_compose", src + "variational.cu",
                 "dis_tpu/ops/variational.py:314", r_err["R23c"]),
        "R3k": ("refine_update_compose_clamp", src + "variational.cu",
                "dis_tpu/models/dis.py:101", r_err["R3k"]),
        "R3n": ("refine_nosweep", src + "variational.cu", "dis_tpu/ops/variational.py:314",
                r_err["R3n"]),
        # Nor S1, S3, S4 and the start: they replace XLA's fusions of each
        # scale's jnp code.  The start (once S2) runs inside S1.
        "S1": ("scale_templates", src + "scale_glue.cu", "dis_tpu/ops/iclk.py:155",
               s_err["S1"]),
        "S2": ("search_start", src + "scale_glue.cu", "dis_tpu/ops/grid.py:52", s_err["S2"]),
        "S3": ("fixed_weights", src + "scale_glue.cu", "dis_tpu/models/dis.py:27",
               s_err["S3"]),
        "S4": ("densify", src + "scale_glue.cu", "dis_tpu/ops/densify.py:58", s_err["S4"]),
        # Nor F1-F3: the frame's jnp code around the pipeline.
        "F1": ("frame_pad", src + "frame_glue.cu", "dis_tpu/ops/image.py:146", f_err["F1"]),
        "F2": ("intensity_levels", src + "frame_glue.cu", "dis_tpu/ops/pyramid.py:162",
               f_err["F2"]),
        "F3": ("frame_finish", src + "frame_glue.cu", "dis_tpu/models/dis.py:468",
               f_err["F3"]),
    }
    times.update(rtimes)
    costs.update(rcosts)
    times.update(stimes)
    costs.update(scosts)
    times.update(ftimes)
    costs.update(fcosts)
    library = {"R1s": r1_library, **f_library}
    # cost_analysis's entries against the kernels line: K3 (one pyramid)
    # gives the same bound; K1 in its plane mode at the finest scale counts
    # its fixed loop and no start freezes, so its bytes differ by the raw
    # templates of the patches frozen at the start (a few hundred at 1080p).  The 1080p
    # DIS_MEDIUM bucket's last R0, R1 (its setup mode) and R23 (the last
    # two: a weight update, then its compose mode) are the finest level's,
    # and its F2 the frame's, which the kernels line times.
    kc, kcm = served_cost["kernels"], med_cost["kernels"]
    check(not kc["K2"] and not kcm["K2"], "cost_analysis: a served bucket launches K2")
    for k, entry, tol in (("K3", kc["K3"][0], 0.0), ("K1p", kc["K1"][-1], 1e-3),
                          ("R0", kcm["R0"][-1], 0.0),
                          ("R1s", kcm["R1"][-1], 0.0), ("R23", kcm["R23"][-2], 0.0),
                          ("R23c", kcm["R23"][-1], 0.0),
                          ("S1", kc["S1"][-1], 0.0), ("S4", kc["S4"][-1], 0.0),
                          ("F2", kcm["F2"][-1], 0.0)):
        static = bound(entry["bytes accessed"], entry["flops"])
        run_bound = bound(*costs[k])
        print(f"cost_analysis {k}: bound {static[0]:.6f} ms by {static[1]}; kernels line "
              f"{run_bound[0]:.6f} ms by {run_bound[1]}", flush=True)
        check(static[1] == run_bound[1] and abs(static[0] - run_bound[0]) <= tol * run_bound[0],
              f"cost_analysis {k} bound {static} vs the kernels line {run_bound}")
    check(all(launches[k] == 0 for k in OFF_PATH),
          f"the main path launched K2, K2b or K2c: {[launches[k] for k in OFF_PATH]}")
    rows = []
    for k in (*LAUNCH_KEYS, "S2"):
        bound_ms, bound_by = bound(*costs[k])
        check(launches["S1" if k == "S2" else k] > 0,
              f"{k} was launched no time on the main path")
        rows.append({"name": meta[k][0], "route": "cuda", "source": meta[k][1],
                     "replaces": meta[k][2], "launches": launches["S1" if k == "S2" else k],
                     "max_abs_err": meta[k][3], "ms": times[k][0], "plain_ms": times[k][1],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library.get(k)})
        if k in rcold or k in f_cold:
            rows[-1]["cold_ms"] = rcold.get(k, f_cold.get(k))
        if k in MODE_OF:
            # K1's and R23's modes: the same kernel, whose row's launches
            # count this mode's too (R3k the launches with the clip flag,
            # timed in R23's compose mode).
            rows[-1]["mode_of"] = meta[MODE_OF[k]][0]
        if k == "K1":
            rows[-1]["split_launches"] = launches["K1s"]
    # The start's row: fused into S1 (scale_templates), it launches
    # with S1, and its ms is what it adds inside S1 on the same inputs.
    rows[-1]["fused_into"] = "scale_templates"
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
    at patch 12, the finest scale of the benchmark's ``hd1080_medium`` and
    ``uhd4k_medium`` on their served path's search inputs: K2, K1 from
    its regions, the two in turn and, in a tree that has it, K1's plane
    mode (``k1_plane_mode`` says which);
    K2b and K1b on the KITTI B = 8 batch (config 3); K3 on the two 4K
    pyramids, K2c and K2 on the same 4K finest inputs, and K1 there; S1
    and S4 on the 1080p compat finest scale's inputs and S4 on the 1080p
    ``DIS_FULL`` one's; the search start with its templates, one S1 or S1
    then S2 where the tree still has S2 (``s2_separate``), at the 1080p
    compat finest and coarsest scales and the KITTI B = 8 finest one; the
    replayed 1080p and 4K compat frames (``aot_compile``), the eager 1080p
    compat frame and the KITTI B = 8 batch, eager and replayed; the refinement
    of the finest level of the 1080p ``DIS_MEDIUM`` and ``DIS_FULL`` frames
    and those frames, replayed and eager, the same of the 1080p
    ``DIS_MEDIUM`` frame under ``warp1``, a hash of the flow of each of
    eleven configs and inputs (``flow_sha256``: the clamped 1080p and 4K
    and the ``warp1`` ``DIS_MEDIUM`` frames among them), and, in a tree
    that has them, R0, R1's setup and warp1 modes and R23 (its second
    call) on that level's inputs; the 1080p ``DIS_MEDIUM`` artifact's
    export and load seconds, nodes and bytes.  K2
    gets the grid's column length where the tree's ``extract_regions``
    takes ``num_h``, as its main path does (``k2_num_h`` says which).
    Only functions every tree of the port has are called."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import importlib.util
    import inspect

    sys.path.insert(0, root)
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build
    from dis_tpu_torch.models.dis import motion_bound
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.grid import make_grid
    from dis_tpu_torch.ops.pyramid import construct_pyramid
    from dis_tpu_torch.serving import aot_compile, export_flow, load_exported

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
    # Patch 12: the finest scale of the benchmark's medium configurations
    # on the search inputs their served path gives (this file's
    # served_search_inputs), K2 and K1 from its regions, both in turn, and
    # K1's plane mode where the tree has it.
    ik = importlib.import_module("dis_tpu_torch.ops.cuda.iclk_kernel")
    out["k1_plane_mode"] = hasattr(ik, "iclk_search_plane")
    for name, (x, y) in (("hd1080_medium", (a, b)), ("uhd4k_medium", (a4, b4))):
        cfg = bench_config(name, root)
        plane, pos0, args, geom = served_search_inputs(cfg, x, y)
        ps, calls = cfg.patch_size, 5 if name.startswith("uhd4k") else 20
        kw = {"num_h": geom.num_h} if takes_num_h else {}
        regions = extract_regions(plane, pos0, ps, ps, **kw)
        both(f"K2_{name}_finest", lambda: extract_regions(plane, pos0, ps, ps, **kw), calls)
        both(f"K1_{name}_finest", lambda: iclk_search(*regions, *args), calls)
        both(f"K2_K1_{name}_finest",
             lambda: iclk_search(*extract_regions(plane, pos0, ps, ps, **kw), *args), calls)
        if out["k1_plane_mode"]:
            both(f"K1p_{name}_finest", lambda: ik.iclk_search_plane(plane, pos0, *args), calls)
        del plane, pos0, args, regions
    bound0 = 2.0 * motion_bound(bench_cfg, 1)
    both("K2c_4k_finest", lambda: extract_regions_banded(img4, pos4, 8, p, geom4, bound0),
         calls=5)
    # S1 and S4 on the finest scale's inputs of the 1080p compat frame (S4
    # also of the DIS_FULL frame), through the wrappers of every tree since
    # S1-S4 (scale_step_inputs records them); and the search start with its
    # templates, as the tree launches them: one S1, or S1 then S2 where the
    # tree still has S2, at the 1080p compat finest and coarsest scales and
    # the KITTI B = 8 finest one.
    from dis_tpu_torch.ops.cuda import scale_kernel as sk

    start = getattr(sk, "search_start", None)
    out["s2_separate"] = start is not None
    for key, cfg, (x, y), names in (("1080p_compat", bench_cfg, (a, b), ("S1", "S4")),
                                    ("kitti_b8_compat", bench_cfg, (ka, kb), ()),
                                    ("1080p_full", dt.DIS_FULL, (a, b), ("S4",))):
        steps = scale_step_inputs(lambda: dt.dis_flow(x, y, cfg))
        for k in names:
            fn = {"S1": sk.scale_templates, "S4": sk.densify}[k]
            out[f"{k}_{key}_finest_replayed_ms"] = replay_ms(lambda: fn(*steps[k][-1]))
        for where, i in (("finest", -1), ("coarsest", 0)):
            if key == "1080p_full" or (key == "kitti_b8_compat" and where == "coarsest"):
                continue
            calls = [(sk.scale_templates, steps["S1"][i])]
            if start is not None:
                calls.append((start, steps["S2"][i]))
            out[f"S1_start_{key}_{where}_replayed_ms"] = replay_ms(
                lambda: [fn(*args) for fn, args in calls])
        del steps
    # Whole frames, replayed from the serving path's CUDA graph: whether a
    # kernel's gain shows end to end.
    for key, (x, y) in (("frame_1080p_compat", (a, b)), ("frame_4k_compat", (a4, b4))):
        served = aot_compile(bench_cfg, *x.shape)
        out[key + "_replayed_ms"] = time_ms(lambda: served(x, y), reps=10)
        del served
    out["frame_1080p_compat_eager_ms"] = time_ms(lambda: dt.dis_flow(a, b, bench_cfg), reps=10)
    served = aot_compile(bench_cfg, *ka.shape[-2:], batch=ka.shape[0])
    out["batch_kitti_b8_compat_replayed_ms"] = time_ms(lambda: served(ka, kb), reps=10)
    del served
    out["batch_kitti_b8_compat_eager_ms"] = time_ms(lambda: dt.dis_flow(ka, kb, bench_cfg),
                                                    reps=10)
    # The refinement: torch ops in a tree without its kernels.  Its finest
    # level alone and the whole frame, replayed, for the 1080p DIS_MEDIUM
    # and DIS_FULL frames; its kernels alone where the tree has them.
    from dis_tpu_torch.ops.variational import variational_refinement

    kernels = importlib.util.find_spec("dis_tpu_torch.ops.cuda.refine_kernel") is not None
    out["refine_kernels"] = kernels
    warp1_cfg = dataclasses.replace(dt.DIS_MEDIUM, refinement_scheme="warp1")
    for key, cfg in (("medium", dt.DIS_MEDIUM), ("full", dt.DIS_FULL), ("warp1", warp1_cfg)):
        x, y = (im.pad_divisible(t, cfg.coarsest_scale)[0] for t in (a, b))
        levels, planes = refined_levels(x, y, cfg)
        args = refine_inputs(cfg, levels, planes, 0)
        out[f"refine_1080p_{key}_finest_replayed_ms"] = replay_ms(
            lambda: variational_refinement(*args), calls=5, reps=5)
        if kernels:
            from dis_tpu_torch.ops.cuda import refine_kernel as rk

            # R0, R1's modes and R23 where the tree has them.
            steps = refine_step_inputs(args, {"R0": (0,), "R1s": (0,), "R1w": (0,),
                                              "R23": (1,)})
            for k, name in (("R0", "refine_planes"), ("R1s", "refine_setup"),
                            ("R1w", "refine_setup_warp1"), ("R23", "refine_update")):
                if steps.get(k):
                    fn = getattr(rk, name)
                    out[f"{k}_1080p_{key}_finest_replayed_ms"] = replay_ms(
                        lambda: fn(*steps[k][0]))
            del steps
        del levels, planes, args
        served = aot_compile(cfg, H, W)
        out[f"frame_1080p_{key}_replayed_ms"] = time_ms(lambda: served(a, b), reps=10)
        del served
        out[f"frame_1080p_{key}_eager_ms"] = time_ms(lambda: dt.dis_flow(a, b, cfg), reps=5,
                                                     warmup=1)
    # F1, F2 and F3 on the inputs the main path gives them (phase 1g's
    # timed calls), each beside the floor of a fill and a copy of the bytes
    # it moves (the same in every tree).
    from dis_tpu_torch import cost
    from dis_tpu_torch.ops.cuda import frame_kernel as fkern

    kraw = [torch.from_numpy(np.stack([q[j] for q in kpairs])).to(dev) for j in (0, 1)]
    for k, key, cfg, (x, y) in (("F1", "kitti_b8_medium", dt.DIS_MEDIUM, kraw),
                                ("F2", "1080p_medium", dt.DIS_MEDIUM, (a, b)),
                                ("F3", "kitti_b8_ultrafast", dt.DIS_ULTRAFAST, kraw)):
        steps = frame_step_inputs(lambda: dt.dis_flow(x, y, cfg))
        fn, op = {"F1": (fkern._pad_cuda, "frame_pad"),
                  "F2": (fkern._levels_cuda, "intensity_levels"),
                  "F3": (fkern._finish_cuda, "frame_finish")}[k]
        out[f"{k}_{key}_replayed_ms"] = replay_ms(lambda: fn(*steps[k][0]))
        nbytes = cost.op_cost(op, steps[k][0])[0]
        out[f"{k}_{key}_cold_replayed_ms"] = cold_replay_ms(fn, steps[k][0], nbytes)
        out[f"{k}_{key}_fill_ms"], out[f"{k}_{key}_copy_ms"] = fill_floor(nbytes, dev)
        del steps
    # The flows' bits, to hold two trees' flows to each other: a hash of
    # each config's flow on the same inputs.
    clamped = dataclasses.replace(dt.DIS_MEDIUM, refined_init_clamp=True)
    out["flow_sha256"] = {
        key: hashlib.sha256(dt.dis_flow(x, y, cfg).cpu().numpy().tobytes()).hexdigest()[:16]
        for key, (cfg, x, y) in {
            "compat_1080p": (bench_cfg, a, b), "fast_1080p": (dt.DIS_FAST, a, b),
            "medium_1080p": (dt.DIS_MEDIUM, a, b), "full_1080p": (dt.DIS_FULL, a, b),
            "compat_4k": (bench_cfg, a4, b4), "fast_4k": (dt.DIS_FAST, a4, b4),
            "compat_kitti_b8": (bench_cfg, ka, kb),
            "ultrafast_kitti_b8": (dt.DIS_ULTRAFAST, ka, kb),
            "medium_warp1_1080p": (warp1_cfg, a, b),
            "medium_clamped_1080p": (clamped, a, b), "medium_clamped_4k": (clamped, a4, b4)
        }.items()}
    # The 1080p DIS_MEDIUM artifact: its size, export and load in this process.
    t0 = time.perf_counter()
    data = export_flow(dt.DIS_MEDIUM, H, W)
    out["artifact_1080p_medium_export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, program = load_exported(data)
    out["artifact_1080p_medium_load_s"] = time.perf_counter() - t0
    out["artifact_1080p_medium_nodes"] = len(program.graph.nodes)
    out["artifact_1080p_medium_bytes"] = len(data)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-times":
        sys.exit(kernel_times(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-child":
        sys.exit(serve_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sweep-child":
        sys.exit(sweep_child(sys.argv[2]))
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--kernel-times ROOT]")
    sys.exit(main())
