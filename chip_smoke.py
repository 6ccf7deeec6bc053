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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA GPU only")
    import dis_tpu_torch as dt
    from bench import synth_pair
    from dis_tpu_torch import _build
    from dis_tpu_torch.models.dis import dis_scale_window
    from dis_tpu_torch.ops import iclk
    from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
    from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
    from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level
    from dis_tpu_torch.ops.grid import init_from_coarser_flow, make_grid
    from dis_tpu_torch.ops.pyramid import construct_pyramid, pyramid_level_plain

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
        pyr1 = construct_pyramid(a, cfg.coarsest_scale, p)
        pyr2 = construct_pyramid(b, cfg.coarsest_scale, p)
        flow = None
        for scale in range(cfg.coarsest_scale, 0, -1):
            flow, _, _ = dis_scale_window(pyr1[scale], pyr2[scale], flow, cfg)
        l1, l2 = pyr1[0], pyr2[0]
        geom = make_grid(l1.width, l1.height, cfg.steps)
        centers = torch.from_numpy(geom.centers).to(dev)
        tpl = iclk.extract_templates_grid(l1.img, l1.dx, l1.dy, geom,
                                          cfg.patch_size, p)
        init_u = init_from_coarser_flow(geom, flow)
        pos0 = centers + init_u
        conv0 = iclk.out_of_bounds(pos0, cfg.patch_size, l1.width, l1.height)
        Tn = iclk.residual_template(tpl, cfg) if cfg.mode == "fixed" else None
        finest[name] = (cfg, l2, tpl, Tn, centers, init_u, pos0, conv0)

        kr = extract_regions(l2.img, pos0, cfg.patch_size, p)
        pr = iclk.extract_regions_plain(l2.img, pos0, cfg.patch_size, p)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((kr[0] - pr[0]).abs().max()))
        for kt, pt in zip(kr, pr):
            check(torch.equal(kt, pt), f"K2 {name} N={pos0.shape[0]} differs")
        args = (tpl, Tn, centers, init_u, conv0, cfg, l1.width, l1.height)
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

    src = "dis_tpu_torch/csrc/"
    meta = {
        "K3": ("pyramid_level", src + "pyramid_level.cu",
               "dis_tpu/ops/pallas/pyramid_kernel.py:58", k3_err),
        "K2": ("extract_regions", src + "extract_regions.cu",
               "dis_tpu/ops/pallas/extract_kernel.py:259", k2_err),
        "K1": ("iclk_search", src + "iclk.cu",
               "dis_tpu/ops/pallas/iclk_kernel.py:93", k1_err),
    }
    print(json.dumps({"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": launches[k],
         "max_abs_err": meta[k][3], "ms": times[k][0], "plain_ms": times[k][1]}
        for k in ("K3", "K2", "K1")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
