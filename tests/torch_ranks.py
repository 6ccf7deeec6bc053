"""Rank functions of the port's multi-rank tests.

``dis_tpu_torch.parallel.launch.spawn`` pickles its target by import
path and each rank imports it afresh, so the targets live here, in a
module that imports torch and the port only (a test module would pull
JAX and the suite's conftest into every rank).  Each takes the rank's
device first and returns CPU tensors or plain values.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from dis_tpu_torch.parallel import (batch_sharding, batched_flow_epe_fn, batched_flow_fn,
                                    exchange_halo, grid_tiled_flow_fn, make_mesh,
                                    row_sharding, sequence_flow_fn, sequence_pair_flow_fn,
                                    tiled_flow_fn)
from dis_tpu_torch.parallel.mesh import all_gather_rows, axis_group, shift


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def halo_world(dev, frame: np.ndarray, halo: int) -> dict:
    """``shift`` (a ring shift and a partial one), ``exchange_halo`` and
    the gather of row blocks of ``frame`` over all ranks of the group."""
    n = dist.get_world_size()
    mesh = make_mesh((n,), ("space",), device_type=dev.type)
    group = axis_group(mesh, "space")[0]
    x = row_sharding(mesh, torch.from_numpy(frame)).to(dev)
    return {
        "ring": shift(x, group, [(j, (j + 1) % n) for j in range(n)]).cpu(),
        "down": shift(x[:2], group, [(j, j + 1) for j in range(n - 1)]).cpu(),
        "ext": exchange_halo(x, halo, group).cpu(),
        "gathered": all_gather_rows(x, group).cpu(),
        "too_wide": _refusal(lambda: exchange_halo(x, x.shape[0] + 1, group)),
    }


def tiling_world(dev, cases) -> dict:
    """Each case ``(label, engine, cfg, n, halo, i1, i2)`` through
    ``tiled_flow_fn`` or ``grid_tiled_flow_fn`` on a mesh of the first n
    ranks: this rank's flow rows by label, and under "staged_bytes" what
    ``shift`` copied through the host."""
    rank = dist.get_rank()
    shift.staged_bytes = 0
    out = {}
    for label, engine, cfg, n, halo, i1, i2 in cases:
        mesh = make_mesh((1, n), ("batch", "space"), device_type=dev.type)
        if rank >= n:
            continue
        h, w = i1.shape
        fn = (tiled_flow_fn(cfg, mesh, h, w, halo=halo) if engine == "tiled"
              else grid_tiled_flow_fn(cfg, mesh, h, w))
        a, b = (row_sharding(mesh, torch.from_numpy(x)).to(dev) for x in (i1, i2))
        out[label] = fn(a, b).cpu()
    out["staged_bytes"] = shift.staged_bytes
    return out


def tiling_refusals(dev, cfg) -> dict:
    """The engines' refusals on a space axis of the first 2 ranks."""
    mesh = make_mesh((2,), ("space",), device_type=dev.type)
    if dist.get_rank() >= 2:
        return {}
    f = 2 ** cfg.coarsest_scale
    blk = torch.zeros((3 * f, 8 * f), device=dev)
    return {
        "stripe_height": _refusal(lambda: tiled_flow_fn(cfg, mesh, 6 * f + 2, 8 * f)),
        "grid_height": _refusal(lambda: grid_tiled_flow_fn(cfg, mesh, 6 * f + 1, 8 * f)),
        "block_shape": _refusal(lambda: grid_tiled_flow_fn(cfg, mesh, 8 * f, 8 * f)(blk, blk)),
    }


def batch_world(dev, cfg, a, b, gt, shape) -> dict:
    """The batch axis of a mesh of ``shape`` (("batch",) or ("batch",
    "space")): this rank's flows and the mean EPE."""
    names = ("batch", "space")[:len(shape)]
    mesh = make_mesh(shape, names, device_type=dev.type)
    aa, bb, gg = (batch_sharding(mesh, torch.from_numpy(x)).to(dev) for x in (a, b, gt))
    flows, mean = batched_flow_epe_fn(cfg, mesh)(aa, bb, gg)
    plain = batched_flow_fn(cfg, mesh)(aa, bb)
    return {"flows": flows.cpu(), "mean_epe": mean.cpu(), "plain": plain.cpu(),
            "odd_batch": _refusal(lambda: batch_sharding(mesh, torch.from_numpy(a[:-1])))}


def sequence_world(dev, cfg, pair_clip, frame_clip) -> dict:
    """Both sequence forms over all ranks: this rank's flows, and the
    refusals of clips that do not shard evenly."""
    n = dist.get_world_size()
    mesh = make_mesh((n,), ("seq",), device_type=dev.type)
    pc, fc = torch.from_numpy(pair_clip), torch.from_numpy(frame_clip)
    body = batch_sharding(mesh, pc[:-1], "seq").to(dev)
    pair_fn = sequence_pair_flow_fn(cfg, mesh)
    rank = dist.get_rank()
    return {
        "pair": pair_fn(body, pc[-1].to(dev)).cpu(),
        "frame": sequence_flow_fn(cfg, mesh)(batch_sharding(mesh, fc, "seq").to(dev)).cpu(),
        "pair_length": _refusal(lambda: batch_sharding(mesh, pc, "seq")),
        "frame_length": _refusal(lambda: batch_sharding(mesh, fc[:-1], "seq")),
        # Only the last rank reads `last`, and refuses before any shift.
        "no_last": _refusal(lambda: pair_fn(body, None)) if rank == n - 1 else "",
    }


def shard_worker(folder: str, start: int, end: int, ckpt_root: str, out_dir: str,
                 die_after: int) -> None:
    """One host of a sharded sequence run on the CPU (``RANK`` and
    ``WORLD_SIZE`` from the environment, no master address): exits with
    code 17 after ``die_after`` pairs (0: never), as a preempted host."""
    from dis_tpu_torch.config import DISConfig
    from dis_tpu_torch.parallel.distributed import run_sequence_shard

    torch.set_num_threads(1)
    cfg = DISConfig(iterations=4, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
    done = []

    def on_pair(i, flow):
        done.append(i)
        if die_after and len(done) >= die_after:
            os._exit(17)

    summary = run_sequence_shard(folder, start, end, cfg, ckpt_root, out_dir=out_dir,
                                 save_flo=True, on_pair=on_pair, device="cpu")
    print("SUMMARY", summary["shard"][0], summary["shard"][1], summary["resumed_from"],
          summary["pairs_done"], flush=True)


def several(dev, calls) -> dict:
    """Each ``(name, fn, args)`` of ``calls`` in order, ``fn(dev, *args)``
    by name: one world for a test file's cases."""
    return {name: fn(dev, *args) for name, fn, args in calls}
