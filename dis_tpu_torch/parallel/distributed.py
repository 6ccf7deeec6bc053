"""Multi-host initialisation, sequence shards and the scaling harness;
counterpart of ``dis_tpu/parallel/distributed.py``.

``init_multi_host`` starts the ``torch.distributed`` default group from
torch's launcher variables (``torchrun`` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``) and is a
no-op on a single host, so the same entry point serves one card, one
host and many hosts.  ``run_sequence_shard`` is one host's checkpointed
share of a sequence: it needs no collective, so a killed host relaunches
with the same command line and resumes alone.  ``scaling_report``
measures batched-flow throughput at growing rank counts, one rank per
card.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .launch import default_backend, rank_device, spawn


def init_multi_host(backend: Optional[str] = None, master_addr: Optional[str] = None,
                    master_port: Optional[int] = None, world_size: Optional[int] = None,
                    rank: Optional[int] = None, local_rank: Optional[int] = None,
                    device=None) -> torch.device:
    """Start the default process group when running on several hosts (or
    ranks), and return this rank's device.

    Arguments default from ``MASTER_ADDR``, ``MASTER_PORT`` (29500),
    ``WORLD_SIZE`` (1), ``RANK`` (0) and ``LOCAL_RANK`` (0); explicit
    arguments win.  ``device`` defaults to ``cuda:<LOCAL_RANK>``;
    ``backend`` to NCCL for a CUDA device and gloo for the CPU.  Without a
    master address, or at world size 1 with no ``backend`` named, it
    starts no group (the JAX package's rule: no coordinator, no group);
    naming a backend starts a group of one.  An existing default group is
    kept."""
    env = os.environ
    master_addr = master_addr or env.get("MASTER_ADDR")
    master_port = int(master_port or env.get("MASTER_PORT", "29500"))
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else env.get("RANK", "0"))
    local_rank = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank)
    if not master_addr or (world_size == 1 and backend is None) or dist.is_initialized():
        return dev
    dev = rank_device(dev, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()   # so DeviceMesh keeps this device
    dist.init_process_group(backend or default_backend(dev.type),
                            init_method=f"tcp://{master_addr}:{master_port}",
                            world_size=world_size, rank=rank)
    return dev


def shard_frame_range(start: int, end: int, num_hosts: int,
                      host_id: int) -> tuple:
    """Contiguous split of the pair indices [start, end) across hosts.

    Pair i uses frames (i, i+1); a host's shard is self-contained
    because frame files are read from shared storage (the one-frame
    neighbor halo is a file read, not a device transfer).  Remainder
    pairs go to the leading hosts.
    """
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    total = max(0, end - start)
    base = total // num_hosts
    rem = total % num_hosts
    lo = start + host_id * base + min(host_id, rem)
    hi = lo + base + (1 if host_id < rem else 0)
    return lo, hi


def run_sequence_shard(folder: str, start: int, end: int, cfg,
                       ckpt_root: str, host_id: Optional[int] = None,
                       num_hosts: Optional[int] = None, **kwargs) -> dict:
    """One host's share of a sequence run (``runner.run_sequence``),
    checkpointed per shard in ``ckpt_root/host_{id:03d}``, so a killed
    host relaunches with the same command line and continues where it
    stopped.  ``host_id`` and ``num_hosts`` default to ``RANK`` and
    ``WORLD_SIZE``; the device (``device=`` among ``kwargs``) to
    :func:`init_multi_host`'s."""
    from ..runner import run_sequence

    dev = init_multi_host(device=kwargs.pop("device", None))
    if num_hosts is None:
        num_hosts = int(os.environ.get("WORLD_SIZE", "1"))
    if host_id is None:
        host_id = int(os.environ.get("RANK", "0"))
    lo, hi = shard_frame_range(start, end, num_hosts, host_id)
    summary = run_sequence(folder, lo, hi, cfg,
                           ckpt_dir=os.path.join(ckpt_root, f"host_{host_id:03d}"),
                           device=dev, **kwargs)
    summary.update(host_id=host_id, num_hosts=num_hosts, shard=(lo, hi))
    return summary


def _throughput_rank(dev: torch.device, cfg, h: int, w: int, reps: int) -> float:
    """Seconds a call of the batched flow on this rank's one pair takes,
    the mean over ``reps`` calls after one warm-up, the ranks in step."""
    from .batch import batched_flow_fn
    from .mesh import batch_sharding, make_mesh

    n = dist.get_world_size()
    mesh = make_mesh((n,), ("batch",), device_type=dev.type)
    fn = batched_flow_fn(cfg, mesh)
    r = np.random.default_rng(0)
    a, b = (batch_sharding(mesh, torch.from_numpy(r.random((n, h, w)).astype(np.float32)))
            .to(dev) for _ in range(2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    fn(a, b)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(a, b)
    sync()
    return (time.perf_counter() - t0) / reps


def measure_throughput(cfg, h: int, w: int, n_devices: int, reps: int = 3,
                       device="cuda") -> float:
    """Pairs/s of a batch of ``n_devices`` pairs sharded over as many
    ranks (:func:`launch.spawn`), one card a rank by default: n over the
    slowest rank's seconds a call."""
    secs = spawn(n_devices, _throughput_rank, cfg, h, w, reps, device=device)
    return n_devices / max(secs)


def scaling_report(cfg=None, h: int = 128, w: int = 160,
                   device_counts: Optional[List[int]] = None, device="cuda") -> dict:
    """Throughput and parallel efficiency across rank counts (default:
    1, 2, 4, ... up to ``torch.cuda.device_count()``, one rank a card)."""
    from ..config import DISConfig

    cfg = cfg or DISConfig(iterations=8, coarsest_scale=2,
                           patch_overlap=0.5, mode="fixed",
                           early_exit=False)
    if device_counts is None:
        n = torch.cuda.device_count()
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    rows = []
    base = None
    for c in device_counts:
        tp = measure_throughput(cfg, h, w, c, device=device)
        if base is None:
            base = tp
        rows.append({
            "devices": c,
            "pairs_per_sec": round(tp, 3),
            "efficiency": round(tp / (base * c), 4),
        })
    platform = "gpu" if torch.device(device).type == "cuda" else "cpu"
    return {"platform": platform, "rows": rows}
