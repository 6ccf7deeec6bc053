"""A small launcher: n ranks of one ``torch.distributed`` group, each a
process spawned by ``torch.multiprocessing``, for the dry run, the tests
and ``chip_smoke.py``.  Production runs launch with ``torchrun`` and
:func:`dis_tpu_torch.parallel.distributed.init_multi_host` instead.

The group meets through a ``file://`` rendezvous in a temporary
directory (no TCP port, so several worlds can start side by side), and
each rank runs one intra-op thread (the ranks share the host's cores).
A spawned target is pickled by its import path: pass a module-level
function of an importable module.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: ``"cuda"`` (no index)
    means ``cuda:<local_rank>``, one card a rank; ``"cuda:K"`` puts every
    rank on card K; ``"cpu"`` is the CPU.  A card that does not exist
    raises; no other device is chosen."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available "
                               "(torch.cuda.is_available() is False); pass device='cpu'")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev}: this machine has "
                               f"{torch.cuda.device_count()} CUDA device(s); pass "
                               "device='cuda:0' to put every rank on card 0 (gloo)")
    return dev


def default_backend(device) -> str:
    """NCCL where each rank has a card of its own (``"cuda"`` without an
    index), else gloo: NCCL refuses two ranks on one card, and the CPU
    has gloo only."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"


def _rank_main(rank: int, n: int, init_file: str, out_dir: str, backend: str,
               device: str, timeout_s: float, fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n))
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        # Initialised here, the device is kept by DeviceMesh, which would
        # otherwise pick card LOCAL_RANK.
        torch.cuda.set_device(dev)
        torch.cuda.init()
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn: Callable, *args, device="cuda", timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(device, *args)`` on n ranks of a new group and return
    each rank's result, rank order (moved to the CPU: results travel
    through ``torch.save``).  ``device`` is as :func:`rank_device` reads
    it, and so is the backend, by :func:`default_backend`.  A rank that
    raises or dies fails the call (``torch.multiprocessing`` stops the
    others and raises its error); a collective that waits longer than
    ``timeout_s`` raises in its rank."""
    tmp = tempfile.mkdtemp(prefix="dis_tpu_torch_spawn_")
    try:
        mp.start_processes(_rank_main, nprocs=n, join=True, start_method="spawn",
                           args=(n, os.path.join(tmp, "rendezvous"), tmp,
                                 default_backend(device), str(device), timeout_s, fn, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
