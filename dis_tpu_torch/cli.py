"""Command-line front end mirroring the reference CLI (main.cpp:60-209);
counterpart of ``dis_tpu/cli.py``.

The reference accepts 0, 3 or 10 positional args:

    dis-tpu-torch [folder start end [max_iter patch_size coarsest finest
                   overlap norm draw]]

and loops over consecutive pairs ``<folder>/frame_%04d.png``, writing
colorized flow to ``OF_<folder>/``.  This CLI reproduces that surface
(minus the Win32 imshow windows) with the JAX CLI's named flags (mode,
refinement, .flo output, EPE scoring against ground truth, batching,
profile, JSON log) and one more, ``--device`` (default ``cuda``): the
pipeline runs there, and without a CUDA device the CLI exits non-zero
unless ``--device cpu`` is given.  Frames are decoded, colourised and
written on the host (``utils/``; the native I/O library is required on a
CUDA device); each frame shape is captured once into a CUDA graph
(``serving.aot_compile``, as the JAX CLI's ``jax.jit`` compiles once) and
replayed per pair.  ``draw_grid = 1``, ``DIS_TPU_CHECK=1`` and
``--profile-dir`` run the pipeline eagerly instead, with the same bits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np


# (name, type, reference default) of the ten positional parameters, in
# the reference's order (main.cpp:63-72).
_POSITIONALS = (
    ("folder", str, "alley_1"),
    ("start_num_img", int, 1),
    ("end_num_img", int, 50),
    ("max_iter", int, 1000),
    ("patch_size", int, 8),
    ("coarsest_scale", int, 3),
    ("finest_scale", int, 0),
    ("patch_overlap", float, 0.7),
    ("patch_norm", int, 1),
    ("draw_grid", int, 0),
)

USAGE = (
    "usage: dis-tpu-torch [folder start_num_img end_num_img [max_iter "
    "patch_size coarsest_scale finest_scale patch_overlap patch_norm "
    "draw_grid]]\n"
    "positional parameters must be given as exactly 0, 3 or 10 values "
    "(reference arity rule, main.cpp:73-101)"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dis-tpu-torch",
        description="DIS optical flow on a CUDA GPU (reference-compatible CLI)",
    )
    # The reference's ten positional parameters, collected as one list so
    # the 0/3/10 arity rule (main.cpp:73-101) can be enforced: any other
    # count is rejected with a usage message, like the reference.
    p.add_argument("params", nargs="*", metavar="PARAM",
                   help="0, 3 or 10 positional parameters: folder "
                        "start end [max_iter patch_size coarsest finest "
                        "overlap norm draw]")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on (default cuda; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    p.add_argument("--preset", choices=["ultrafast", "fast", "medium",
                                        "full", "compat"], default=None,
                   help="paper-style preset; overrides the positional params")
    p.add_argument("--mode", choices=["compat", "fixed"], default="compat")
    p.add_argument("--refine", type=int, default=0, metavar="ITERS",
                   help="variational refinement iterations (paper step)")
    p.add_argument("--refine-planes", choices=["q1", "intensity"],
                   default=None,
                   help="refinement data term: the pipeline's Q1 "
                        "gradient-magnitude levels, or the raw-intensity "
                        "resize chain the DIS paper reads "
                        "(config.py::refinement_planes).  Unless "
                        "--refine-alpha is given, 'intensity' rebalances "
                        "alpha 10 -> 40, as the quality presets pair them.  "
                        "No-op without --refine (a warning is printed).")
    p.add_argument("--refine-alpha", type=float, default=None,
                   metavar="ALPHA",
                   help="smoothness weight for the refinement data term "
                        "(config.py::refinement_alpha; default 10.0 for "
                        "q1 planes, 40.0 for intensity planes)")
    p.add_argument("--save-flo", action="store_true",
                   help="also write Middlebury .flo files")
    p.add_argument("--gt-dir", default=None,
                   help="directory of ground-truth frame_%%04d.flo (or KITTI "
                        "16-bit .png) for EPE")
    p.add_argument("--out-dir", default=None,
                   help="output dir (default OF_<folder>, like the reference)")
    p.add_argument("--no-early-exit", action="store_true")
    p.add_argument("--batch", type=int, default=1, metavar="N",
                   help="process N consecutive frame pairs per call (one "
                        "CUDA graph over [N, H, W]; each pair gets the bits "
                        "it gets alone)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace to this "
                        "directory (the pipeline then runs eagerly, so the "
                        "trace names its stages)")
    p.add_argument("--json-log", default=None,
                   help="append JSON-lines run records to this file")
    return p


def main(argv: Optional[List[str]] = None, timer=None) -> int:
    """Run the CLI on ``argv``; returns the exit code.  ``timer``, a
    ``utils.profiling.PhaseTimer``, receives the host phases of every
    pair (decode, flow, colorize, encode, flo, overlay, score)."""
    args = build_parser().parse_args(argv)

    # Reference arity rule: exactly 0, 3 or 10 positionals; anything
    # else prints usage and fails (main.cpp:73-101).
    if len(args.params) not in (0, 3, 10):
        print(USAGE, file=sys.stderr)
        return 2
    for (name, typ, default), val in zip(
            _POSITIONALS, args.params + [None] * (10 - len(args.params))):
        try:
            setattr(args, name, typ(val) if val is not None else default)
        except ValueError:
            print(f"invalid value for {name}: {val!r}\n{USAGE}",
                  file=sys.stderr)
            return 2

    import torch

    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        print(f"invalid --device {args.device!r}: {e}", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"--device takes a CUDA device or cpu, got {dev}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print(f"dis-tpu-torch: --device {dev} needs a CUDA GPU and "
                  "torch.cuda.is_available() is False; pass --device cpu to "
                  "run on the CPU", file=sys.stderr)
            return 1
        from .utils import native
        try:
            native.require()
        except RuntimeError as e:
            print(f"dis-tpu-torch: {e}", file=sys.stderr)
            return 1

    from .config import DISConfig
    from .runner import flow_function
    from .utils import checks, color, flo, io as uio, metrics
    from .utils.profiling import PhaseTimer, trace

    if args.preset:
        from .config import PRESETS

        cfg = PRESETS[args.preset]
        if args.refine:
            import dataclasses

            cfg = dataclasses.replace(cfg, refinement_iters=args.refine)
    else:
        cfg = DISConfig(
            iterations=args.max_iter,
            patch_size=args.patch_size,
            coarsest_scale=args.coarsest_scale,
            finest_scale=args.finest_scale,
            patch_overlap=args.patch_overlap,
            patch_normalization=bool(args.patch_norm),
            mode=args.mode,
            refinement_iters=args.refine,
            early_exit=not args.no_early_exit,
        )
    if args.refine_planes:
        import dataclasses

        cfg = dataclasses.replace(cfg, refinement_planes=args.refine_planes)
        if cfg.refinement_iters == 0:
            print("warning: --refine-planes has no effect without "
                  "--refine (refinement is disabled)", file=sys.stderr)
        elif (args.refine_planes == "intensity"
              and args.refine_alpha is None
              and cfg.refinement_alpha == 10.0):
            # Intensity planes carry ~4x the Q1 dynamic range; the JAX
            # package's quality sweep found alpha=40 optimal, and the
            # presets pair them the same way.
            cfg = dataclasses.replace(cfg, refinement_alpha=40.0)
            print("note: --refine-planes intensity rebalances "
                  "refinement alpha 10 -> 40 (pass --refine-alpha to "
                  "override)", file=sys.stderr)
    if args.refine_alpha is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, refinement_alpha=args.refine_alpha)

    out_dir = args.out_dir or f"OF_{args.folder}"
    os.makedirs(out_dir, exist_ok=True)

    timer = timer if timer is not None else PhaseTimer(device=dev)
    draw_grid = bool(args.draw_grid)
    bsz = args.batch
    flow_fn = flow_function(cfg, dev, batch=bsz if bsz > 1 else None,
                            eager=draw_grid or bool(args.profile_dir))

    if draw_grid:
        from .models.dis import dis_flow_padded
        from .ops.cuda.frame_kernel import frame_finish, frame_pad
        from .utils.overlay import draw_grid_overlay

        def flow_debug(a, b):
            # One pipeline run yields BOTH the flow and the per-scale
            # overlay data, like the reference draws the overlay from
            # the same run (optical_flow.cpp:92-123); the same steps as
            # dis_flow (F1 and F3 on a card), so the same flow bits.
            h, w = a.shape
            p1, p2, (padw, padh) = frame_pad(a, b, cfg.coarsest_scale)
            fl, dbg = dis_flow_padded(p1, p2, cfg, return_debug=True)
            return frame_finish(fl, cfg.finest_scale, padw, padh, w, h), dbg

        if checks.enabled():
            flow_debug = checks.checked(flow_debug)

        def flow_debug_fn(a, b):
            return flow_debug(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))

        def debug_fn(a, b):
            p1, p2, _ = frame_pad(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                                  cfg.coarsest_scale)
            return dis_flow_padded(p1, p2, cfg, return_debug=True)

    epes = []
    times = []
    rc = 0

    def emit_pair(img_i, first, i1, i2, flow, dt, dbg=None):
        """Per-pair output: colorized PNG, optional overlays/.flo/EPE,
        the reference's finish line.  Shared by the serial and batched
        loops so --batch changes only the dispatch, not the outputs.
        ``dbg`` carries the overlay data from the same pipeline run
        (serial path); the batched path recomputes it per pair."""
        times.append(dt)
        with timer.phase("colorize", frame=img_i):
            dst = color.draw_optical_flow(flow)
        base = f"frame_{img_i:04d}"
        with timer.phase("encode", frame=img_i):
            uio.imwrite(os.path.join(out_dir, base + ".png"), dst)
        if draw_grid:
            with timer.phase("overlay", frame=img_i):
                if dbg is None:
                    _, dbg = debug_fn(i1, i2)
                for scale, centers, u_s, lvl in dbg:
                    ov = draw_grid_overlay(lvl.cpu().numpy(), np.asarray(centers),
                                           u_s.cpu().numpy(), scale, cfg.patch_size)
                    uio.imwrite(os.path.join(
                        out_dir, f"{base}_grid_s{scale}.png"), ov)
        if args.save_flo:
            with timer.phase("flo", frame=img_i):
                flo.save_flo(os.path.join(out_dir, base + ".flo"), flow)
        rec = {"frame": img_i, "seconds": dt}
        if args.gt_dir:
            # GT in either benchmark format: Middlebury/Sintel .flo or
            # KITTI 16-bit PNG ((u,v)*64 + 2^15 with a validity channel).
            from .utils.kitti import load_gt_any

            with timer.phase("score", frame=img_i):
                gt, valid = load_gt_any(os.path.join(args.gt_dir, base))
                if gt is not None:
                    rec["epe"] = metrics.epe(flow, gt, valid=valid)
                    epes.append(rec["epe"])
        if args.json_log:
            with open(args.json_log, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print(f"finish {first} ({dt:.3f}s"
              + (f", EPE {rec['epe']:.3f}" if "epe" in rec else "") + ")")

    def read_frame(img_i):
        with timer.phase("decode", frame=img_i):
            return uio.imread_gray(
                os.path.join(args.folder, f"frame_{img_i:04d}.png")
            ).astype(np.float32)

    profile = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with profile:
        if bsz > 1:
            # Batched dispatch: N consecutive pairs per call (pairs (i,
            # i+1) .. (i+N-1, i+N) share frames, so one frame read feeds
            # two pairs).  Short tail chunks repeat the last pair up to N
            # to keep a single captured shape; the duplicate outputs are
            # discarded.
            pair_ids = list(range(args.start_num_img, args.end_num_img))
            pos = 0
            while pos < len(pair_ids):
                chunk = pair_ids[pos:pos + bsz]
                pos += bsz
                frames = {}
                kept = []
                for img_i in chunk:
                    print(f"start {args.folder}/frame_{img_i:04d}.png")
                    try:
                        for j in (img_i, img_i + 1):
                            if j not in frames:
                                frames[j] = read_frame(j)
                        kept.append(img_i)
                    except FileNotFoundError:
                        print("No image data")
                        rc = 1
                        break
                if not kept:
                    break
                a = np.stack([frames[i] for i in kept]
                             + [frames[kept[-1]]] * (bsz - len(kept)))
                b = np.stack([frames[i + 1] for i in kept]
                             + [frames[kept[-1] + 1]] * (bsz - len(kept)))
                t0 = time.perf_counter()
                with timer.phase("flow", frame=kept[0]):
                    flows = flow_fn(a, b).cpu().numpy()
                # Per-pair cost of the call: divide by the batch size
                # actually computed, not len(kept) — a padded tail chunk
                # still does bsz pairs of work.
                dt = (time.perf_counter() - t0) / bsz
                for k, img_i in enumerate(kept):
                    emit_pair(img_i, f"{args.folder}/frame_{img_i:04d}.png",
                              frames[img_i], frames[img_i + 1], flows[k], dt)
                if rc:
                    break
        else:
            for img_i in range(args.start_num_img, args.end_num_img):
                first = os.path.join(args.folder, f"frame_{img_i:04d}.png")
                print(f"start {first}")
                try:
                    i1 = read_frame(img_i)
                    i2 = read_frame(img_i + 1)
                except FileNotFoundError:
                    print("No image data")
                    rc = 1
                    break
                t0 = time.perf_counter()
                dbg = None
                with timer.phase("flow", frame=img_i):
                    if draw_grid:
                        flow, dbg = flow_debug_fn(i1, i2)
                        flow = flow.cpu().numpy()
                    else:
                        flow = flow_fn(i1, i2).cpu().numpy()
                dt = time.perf_counter() - t0
                emit_pair(img_i, first, i1, i2, flow, dt, dbg=dbg)

    if times:
        steady = times[1:] or times
        print(f"frames: {len(times)}  mean {np.mean(steady):.3f}s "
              f"({1.0 / np.mean(steady):.2f} fps steady-state)")
    if epes:
        print(f"avg EPE: {np.mean(epes):.4f}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
