"""Sequence runner: resumable multi-frame flow computation; counterpart
of ``dis_tpu/runner.py``.

Wraps the per-pair pipeline with sequence-progress checkpointing
(SURVEY.md section 5, failure detection): progress persists after every
pair, so a preempted or killed worker rejoins where it stopped.  Each
frame shape is captured once into a CUDA graph (``serving.aot_compile``,
the counterpart of the JAX package's ``jax.jit``) and replayed for every
pair of that shape; on ``device="cpu"`` the same executable is the eager
CPU pipeline.  Under ``DIS_TPU_CHECK=1`` the pairs run eagerly under
``utils.checks.checked`` instead, so the guard sites are live.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import DISConfig
from .utils import color, flo
from .utils import io as uio
from .utils.checkpoint import SequenceCheckpoint
from .utils.profiling import PhaseTimer


def flow_function(cfg: DISConfig, device, batch: Optional[int] = None,
                  eager: bool = False):
    """fn(img1, img2) -> flow [(B,) H, W, 2] on ``device`` for host frames
    [(B,) H, W] float32 (NumPy or CPU tensors): a CUDA graph per frame
    shape (``serving.aot_compile``, captured at the first pair of a
    shape), or, with ``eager`` or under ``DIS_TPU_CHECK=1``, eager
    ``dis_flow`` (under ``checks.checked`` when checks are on).  ``batch``
    is the leading dim of every call (None for single pairs).  The graph
    and the eager path give the same bits.  On a CUDA device, raises
    RuntimeError unless a card and the native I/O library are there."""
    from .models.dis import dis_flow
    from .serving import aot_compile
    from .utils import checks

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass device='cpu' "
                           "to run on the CPU")
    if dev.type == "cuda":
        # The card's frames are decoded and written natively: without the
        # library the NumPy decoder takes seconds a frame (kitti.py).
        from .utils import native

        native.require()
    if eager or checks.enabled():
        run = lambda a, b: dis_flow(a, b, cfg)
        if checks.enabled():
            run = checks.checked(run)
        return lambda a, b: run(torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev))
    compiled: Dict[Tuple[int, int], object] = {}

    def fn(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        hw = tuple(a.shape[-2:])
        if hw not in compiled:
            compiled[hw] = aot_compile(cfg, *hw, batch=batch, device=dev)
        return compiled[hw](a, b)

    return fn


def run_sequence(
    folder: str,
    start: int,
    end: int,
    cfg: DISConfig,
    out_dir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    save_flo: bool = False,
    gt_dir: Optional[str] = None,
    frame_pattern: str = "frame_{:04d}.png",
    on_pair=None,
    device="cuda",
) -> dict:
    """Flow all consecutive pairs [start, end) on ``device``; returns a
    summary dict.

    With ``ckpt_dir``, previously completed pairs (same config) are
    skipped on restart and progress is recorded after each pair.  On a
    CUDA device with no card or no native I/O library available, raises
    RuntimeError (it never falls back to the CPU or to the NumPy codecs).
    """
    out_dir = out_dir or f"OF_{os.path.basename(folder)}"
    os.makedirs(out_dir, exist_ok=True)
    flow_fn = flow_function(cfg, device)

    first = start
    ck = None
    if ckpt_dir:
        ck = SequenceCheckpoint(ckpt_dir, cfg)
        resume_idx, _ = ck.resume()
        first = max(start, resume_idx)

    timer = PhaseTimer(device=device)
    epes: List[float] = []
    done = 0
    # pair (i, i+1) for i in [start, end) — the reference's loop bounds
    # (main.cpp:102)
    for i in range(first, end):
        p1 = os.path.join(folder, frame_pattern.format(i))
        p2 = os.path.join(folder, frame_pattern.format(i + 1))
        i1 = uio.imread_gray(p1).astype(np.float32)
        i2 = uio.imread_gray(p2).astype(np.float32)
        with timer.phase("pair", frame=i):
            flow = flow_fn(i1, i2).cpu().numpy()
        base = frame_pattern.format(i).rsplit(".", 1)[0]
        uio.imwrite(os.path.join(out_dir, base + ".png"),
                    color.draw_optical_flow(flow))
        if save_flo:
            flo.save_flo(os.path.join(out_dir, base + ".flo"), flow)
        if gt_dir:
            gtp = os.path.join(gt_dir, base + ".flo")
            if os.path.exists(gtp):
                from .utils.metrics import epe
                epes.append(epe(flow, flo.load_flo(gtp)))
        if ck:
            ck.save(i, flow)
        if on_pair:
            on_pair(i, flow)
        done += 1

    secs = [r["seconds"] for r in timer.records]
    return {
        "pairs_done": done,
        "resumed_from": first,
        "mean_seconds": float(np.mean(secs)) if secs else 0.0,
        "avg_epe": float(np.mean(epes)) if epes else None,
    }
