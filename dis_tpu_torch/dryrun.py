"""Entry points: a one-device forward step and a multi-rank dry run;
counterpart of the repository's ``__graft_entry__.py``.

``python -m dis_tpu_torch.dryrun N [--device D]`` runs
:func:`dryrun_multichip` on N ranks and prints ``dryrun_multichip OK
...``.  ``--device`` is read as ``parallel.launch.rank_device`` reads it:
``cuda`` (the default) puts rank r on card r with NCCL, ``cuda:0`` every
rank on card 0 with gloo, ``cpu`` every rank on the CPU with gloo.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from .config import DISConfig

# The entry() step: fixed mode with refinement on a single pair.
ENTRY_CFG = DISConfig(iterations=8, patch_size=8, coarsest_scale=3, finest_scale=0,
                      patch_overlap=0.3, mode="fixed", refinement_iters=2,
                      early_exit=False)
DRY_CFG = DISConfig(iterations=2, coarsest_scale=2, patch_overlap=0.5,
                    early_exit=False, mode="fixed", refinement_iters=1)
DRY_GRID_CFG = DISConfig(iterations=2, coarsest_scale=2, patch_overlap=0.5,
                         early_exit=False, mode="fixed", refinement_iters=1,
                         refine_per_level=True, refinement_inner_sweeps=2,
                         refinement_sor_sweeps=1)


def entry(device="cuda"):
    """(fn, (img1, img2)): ``dis_flow_padded`` under the fixed-mode config
    with refinement, on a random 128x160 pair (NumPy seed 0) on
    ``device``."""
    from .models.dis import dis_flow_padded

    def fn(i1, i2):
        return dis_flow_padded(i1, i2, ENTRY_CFG)

    r = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(r.random((128, 160)).astype(np.float32) * 255.0).to(device)
              for _ in range(2))
    return fn, (i1, i2)


def _dryrun_rank(dev: torch.device) -> dict:
    """One rank of :func:`dryrun_multichip`: every step on 32-row frames,
    the shapes checked; returns what it ran."""
    from .parallel import (batch_sharding, batched_flow_fn, make_mesh, row_sharding,
                           sequence_flow_fn, tiled_flow_fn)

    n = dist.get_world_size()
    rank = dist.get_rank()
    r = np.random.default_rng(0)
    h, w = 32, 32

    def frames(*shape):
        return torch.from_numpy(r.random(shape).astype(np.float32))

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"rank {rank}: {what}")

    # batch x space mesh: pairs over 'batch', rows over 'space'
    n_space = 2 if n % 2 == 0 else 1
    n_batch = n // n_space
    mesh = make_mesh((n_batch, n_space), ("batch", "space"), device_type=dev.type)

    # 1) the batch axis
    a, b = frames(n_batch, h, w), frames(n_batch, h, w)
    out = batched_flow_fn(DRY_CFG, mesh)(batch_sharding(mesh, a).to(dev),
                                         batch_sharding(mesh, b).to(dev))
    check(tuple(out.shape) == (1, h, w, 2), f"batch: shape {tuple(out.shape)}")

    # 2) stripes over 'space' 2 and 4 (at 32 rows a rank the 4-way split
    # takes the gather halo), on meshes of the first ranks
    spaces = sorted({2, min(4, n)} & set(range(2, n + 1)))
    for n_t in spaces:
        th = n_t * 32
        smesh = make_mesh((1, n_t), ("batch", "space"), device_type=dev.type)
        t1, t2 = frames(th, w), frames(th, w)
        if rank < n_t:
            tout = tiled_flow_fn(DRY_CFG, smesh, th, w)(row_sharding(smesh, t1).to(dev),
                                                        row_sharding(smesh, t2).to(dev))
            check(tuple(tout.shape) == (32, w, 2), f"space {n_t}: shape {tuple(tout.shape)}")

    # 2b) grid tiling with per-level refinement
    if n_space > 1:
        th = n_space * 32
        gmesh = make_mesh((1, n_space), ("batch", "space"), device_type=dev.type)
        g1, g2 = frames(th, w), frames(th, w)
        if rank < n_space:
            gout = tiled_flow_fn(DRY_GRID_CFG, gmesh, th, w)(row_sharding(gmesh, g1).to(dev),
                                                             row_sharding(gmesh, g2).to(dev))
            check(tuple(gout.shape) == (32, w, 2), f"grid: shape {tuple(gout.shape)}")

    # 3) a clip over 'seq' with a one-frame halo
    qmesh = make_mesh((n,), ("seq",), device_type=dev.type)
    clip = frames(2 * n, h, w)
    qout = sequence_flow_fn(DRY_CFG, qmesh)(batch_sharding(qmesh, clip, "seq").to(dev))
    check(tuple(qout.shape) == (2, h, w, 2), f"seq: shape {tuple(qout.shape)}")
    return {"batch": n_batch, "space": spaces, "grid_tiled_space": n_space, "seq": n}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Spawn ``n_devices`` ranks (``parallel.launch.spawn``) and run one
    step of every multi-rank engine on tiny shapes: the batch axis, stripe
    tiling over 2 and 4 ranks, grid tiling with per-level refinement and a
    sequence over all ranks.  Prints ``dryrun_multichip OK ...`` and
    returns rank 0's summary; a failed rank raises."""
    from .parallel.launch import spawn

    summary = spawn(n_devices, _dryrun_rank, device=device)[0]
    print(f"dryrun_multichip OK on {n_devices} ranks on {device} "
          f"(batch={summary['batch']}, space={summary['space']}, "
          f"grid_tiled_space={summary['grid_tiled_space']}, seq={summary['seq']})")
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dis_tpu_torch.dryrun",
                                description="Multi-rank dry run of the tiling, batch "
                                            "and sequence engines on tiny shapes.")
    p.add_argument("n", type=int, help="number of ranks")
    p.add_argument("--device", default="cuda",
                   help="cuda (a card a rank, NCCL), cuda:K (every rank on card K, "
                        "gloo) or cpu (gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
