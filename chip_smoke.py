#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``dis_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dis_tpu_torch/csrc`` and then:

0. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, both TF32 flags (set off) and the build time;
1. holds each kernel against its plain PyTorch version on the card, at
   the 1080p main-path shapes (K3 and K2 bitwise, K2 also at N = 0; K1 to
   1e-3 px on patches whose freeze state agrees, with < 2% flips), and
   K1/K2 at ps 8, 10, 12, 16 on a small plane with random init;
2. drives ``dis_tpu_torch.dis_flow`` on the 1920x1080 pair of
   ``bench.synth_pair()`` (a (3, 2) px shift) under the compat bench
   config and ``DIS_FAST``: every kernel's launch count must be > 0, the
   flow finite, its median within 0.01 px of (3, 2), its mean EPE within
   0.002 px of the JAX package's CPU reading, and the kernel path within
   1e-3 px mean (<= 1% of pixels over 1e-2 px) of the plain path;
3. times each kernel and its plain version at the main-path shapes, and
   ``dis_flow`` per frame, with CUDA events (median of 20 after warm-up).

Batched pairs and the serving path, on 8 KITTI-size pairs (375 x 1242,
padded to 376 x 1248 inside; ``kitti_pair``, NumPy only, a known integer
shift per pair) under config 3 of ``benchmarks/suite.py`` (compat,
iterations 16, patch 8, overlap 0.3, scales 3..0) and ``DIS_ULTRAFAST``
(fixed mode, scales 3..1, so the batched upsample and crop run):

1b. K2b and K1b (K2 and K1 with the pair axis) at each config's B = 8
    finest-scale shapes (152,000 patches for config 3), bitwise equal to
    their batched plain versions and to 8 serial K2/K1 calls;
2b. ``parallel.batched_flow_fn`` and batched ``dis_flow`` on the 8 pairs:
    per batch K2 and K1 launch once per scale and K3 at most twice per
    level, whatever B is; the flows equal 8 serial ``dis_flow`` calls
    bitwise; each pair's median is within 0.01 px of its shift and its
    mean EPE within 0.002 px of the JAX package's CPU reading;
2c. ``serving.aot_compile`` (a CUDA graph) for the 1080p compat config at
    B = None and config 3 at KITTI size with B = 8: the captured graph
    holds the same launches as one eager call, each replay is bitwise
    equal to the eager kernel path, and a wrong shape raises;
3b. times (CUDA events, median after warm-up): KITTI pairs/s at B = 1, 2,
    4, 8, eager and replayed; 1080p ms/frame eager and replayed; K2b and
    K1b against their plain versions at B = 8.

It prints one JSON line of kernel results, then the card line, then
``{"ok": true, "device": {...}}`` last.  Any failed check raises, so the
script exits nonzero before the last line.  Without a CUDA device, or
without the repository beside it, it fails the same way.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
SHIFT = (3.0, 2.0)
# Mean EPE against the (3, 2) shift of the JAX package on CPU, same pair
# and configs; the port must land within EPE_TOL of it.
EPE_JAX = {"compat": 0.1526, "fast": 0.00515}
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


def search_gate(name, ku, kc, pu, pc):
    """K1 equivalence class: u within 1e-3 px where the freeze state
    agrees, and freeze flips < 2%.  Returns (max |du| over all patches,
    flip share)."""
    agree = kc == pc
    du = (ku - pu).abs().max(dim=1).values
    flips = float((~agree).float().mean()) if agree.numel() else 0.0
    worst = float(du[agree].max()) if bool(agree.any()) else 0.0
    check(worst <= 1e-3, f"{name}: |du| {worst} > 1e-3 on agreeing patches")
    check(flips < 0.02, f"{name}: freeze flips {flips} >= 2%")
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
        flow, _, _ = dis_scale_window(pyr1[scale], pyr2[scale], flow, cfg)
    l1, l2 = pyr1[cfg.finest_scale], pyr2[cfg.finest_scale]
    plan = scale_plan(l1.width, l1.height, cfg.steps, cfg.patch_size, img1.device)
    tpl = iclk.extract_templates_grid(l1.img, l1.dx, l1.dy, plan.geom,
                                      cfg.patch_size, p)
    init_u = init_from_coarser_flow(plan, flow)
    pos0 = plan.centers + init_u
    conv0 = iclk.out_of_bounds(pos0, cfg.patch_size, l1.width, l1.height)
    Tn = iclk.residual_template(tpl, cfg) if cfg.mode == "fixed" else None
    return cfg, l2, tpl, Tn, plan.centers, init_u, pos0, conv0


def scale_counts(cfg):
    """Launches one call must make, whatever B is: K2 and K1 once per
    scale; K3 once per pyramid level and image."""
    n = cfg.coarsest_scale - cfg.finest_scale + 1
    return {"K3": 2 * (cfg.coarsest_scale + 1), "K2": n, "K1": n}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level
    from dis_tpu_torch.ops.grid import make_grid
    from dis_tpu_torch.ops.pyramid import construct_pyramid, pyramid_level_plain
    from dis_tpu_torch.parallel import batched_flow_fn
    from dis_tpu_torch.serving import aot_compile

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
    # K3 at the 1080p levels, both images, bitwise.
    k3_err = 0.0
    for img in (a, b):
        src = img
        for s in range(bench_cfg.coarsest_scale + 1):
            kern = pyramid_level(src, p, base=(s == 0))
            ref = pyramid_level_plain(src, p, base=(s == 0))
            torch.cuda.synchronize()
            for kp, rp in zip(kern, ref):
                k3_err = max(k3_err, float((kp - rp).abs().max()))
                check(torch.equal(kp, rp), f"K3 level {s} differs from plain")
            src = kern[0]
    print(f"phase1 K3 1080p levels bitwise: max_abs_err {k3_err}", flush=True)

    # The finest scale's real inputs: coarser scales through the port.
    finest = {}
    k1_err, k2_err = 0.0, 0.0
    for name, cfg in configs.items():
        finest[name] = finest_inputs(a, b, cfg, p)
        _, l2, tpl, Tn, centers, init_u, pos0, conv0 = finest[name]

        kr = extract_regions(l2.img, pos0, cfg.patch_size, p)
        pr = iclk.extract_regions_plain(l2.img, pos0, cfg.patch_size, p)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((kr[0] - pr[0]).abs().max()))
        for kt, pt in zip(kr, pr):
            check(torch.equal(kt, pt), f"K2 {name} N={pos0.shape[0]} differs")
        args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
        ku, kq, kc = iclk_search(*kr, *args)
        pu, pq, pc = iclk.iclk_search_plain(*pr, *args)
        torch.cuda.synchronize()
        err, flips = search_gate(f"K1 {name}", ku, kc, pu, pc)
        k1_err = max(k1_err, err)
        print(f"phase1 {name} finest N={pos0.shape[0]}: K2 bitwise; K1 max|du| "
              f"{err} flips {flips} bitwise {torch.equal(ku, pu) and torch.equal(kq, pq) and torch.equal(kc, pc)}",
              flush=True)

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
            conv0 = iclk.out_of_bounds(pos0, ps, ww, hh)
            Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
            kr = extract_regions(lvl[0], pos0, ps, ps)
            pr = iclk.extract_regions_plain(lvl[0], pos0, ps, ps)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(kr, pr)), f"K2 ps={ps}")
            args = (tpl, Tn, centers, init_u, conv0, cfg, ww, hh)
            ku, kq, kc = iclk_search(*kr, *args)
            pu, pq, pc = iclk.iclk_search_plain(*pr, *args)
            torch.cuda.synchronize()
            err, flips = search_gate(f"K1 ps={ps} {mode}", ku, kc, pu, pc)
            print(f"phase1 ps={ps} {mode} N={pos0.shape[0]}: K2 bitwise; K1 "
                  f"max|du| {err} flips {flips}", flush=True)

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
        kr = extract_regions(l2.img, pos0, ps, p)
        args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
        ko = iclk_search(*kr, *args)
        check(extract_regions.launches == 1 and iclk_search.launches == 1,
              f"K2b/K1b {name}: not one launch each for the batch")
        pr = iclk.extract_regions_plain(l2.img, pos0, ps, p)
        po = iclk.iclk_search_plain(*pr, *args)
        torch.cuda.synchronize()
        k2b_err = max(k2b_err, float((kr[0] - pr[0]).abs().max()))
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

    # -- phase 2: the main path ---------------------------------------------
    wrappers = {"K3": pyramid_level, "K2": extract_regions, "K1": iclk_search}
    launches = {k: 0 for k in wrappers}
    flows = {}
    for name, cfg in configs.items():
        for w in wrappers.values():
            w.launches = 0
        flow = dt.dis_flow(a, b, cfg)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"phase2 {name} launches {counts}", flush=True)
        for k, c in counts.items():
            check(c > 0, f"{name}: kernel {k} was not launched on the main path")
            launches[k] += c
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
            check(counts["K2"] == want["K2"] and counts["K1"] == want["K1"]
                  and 0 < counts["K3"] <= want["K3"],
                  f"{name} {label}: launches {counts}, want K2 = K1 = "
                  f"{want['K2']} and K3 <= {want['K3']} per batch")
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
        check(gl["K2"] == want["K2"] and gl["K1"] == want["K1"] and 0 < gl["K3"] <= want["K3"],
              f"{label}: the graph holds launches {gl}")
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

    # -- phase 3: times -------------------------------------------------------
    times = {}
    times["K3"] = (time_ms(lambda: construct_pyramid(a, 3, p)),
                   time_ms(lambda: construct_pyramid(a, 3, p, plain=True)))
    cfg, l2, tpl, Tn, centers, init_u, pos0, conv0 = finest["compat"]
    times["K2"] = (time_ms(lambda: extract_regions(l2.img, pos0, 8, p)),
                   time_ms(lambda: iclk.extract_regions_plain(l2.img, pos0, 8, p)))
    kr = extract_regions(l2.img, pos0, 8, p)
    args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
    times["K1"] = (time_ms(lambda: iclk_search(*kr, *args)),
                   time_ms(lambda: iclk.iclk_search_plain(*kr, *args)))
    for k, (km, pm) in times.items():
        print(f"phase3 {k}: kernel {km:.4f} ms plain {pm:.4f} ms [{card}]",
              flush=True)
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
    times["K2b"] = (time_ms(lambda: extract_regions(l2.img, pos0, 8, p)),
                    time_ms(lambda: iclk.extract_regions_plain(l2.img, pos0, 8, p), reps=10))
    kr = extract_regions(l2.img, pos0, 8, p)
    args = (tpl, Tn, centers, init_u, conv0, cfg, l2.width, l2.height)
    times["K1b"] = (time_ms(lambda: iclk_search(*kr, *args)),
                    time_ms(lambda: iclk.iclk_search_plain(*kr, *args), reps=5, warmup=1))
    for k in ("K2b", "K1b"):
        print(f"phase3b {k} B={nk} N={pos0.shape[1]}: kernel {times[k][0]:.4f} ms "
              f"plain {times[k][1]:.4f} ms [{card}]", flush=True)
    launches.update(kl)

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
    }
    print(json.dumps({"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": launches[k],
         "max_abs_err": meta[k][3], "ms": times[k][0], "plain_ms": times[k][1]}
        for k in ("K3", "K2", "K1", "K2b", "K1b")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
