"""Device meshes and the two collectives the multi-rank engines use;
counterpart of ``dis_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``jax.sharding.Mesh``; here each
rank is a process of a ``torch.distributed`` group that runs plain
functions on its own local tensors, and a
``torch.distributed.device_mesh.DeviceMesh`` names the axes:

- ``batch``: independent frame pairs (data parallelism);
- ``space``: row-wise frame tiling with a halo exchange;
- ``seq``: the frames of one long video, sharded by time with a
  one-frame neighbour halo.

Every engine moves data through :func:`shift` (the ``lax.ppermute``
counterpart) and :func:`all_gather_rows` (the tiled ``lax.all_gather``),
so the transport rules live here.  NCCL moves CUDA tensors directly.
Gloo's point-to-point ops take host tensors only, so under gloo a CUDA
tensor is copied to the host for them and the result copied back; the
choice is made by ``dist.get_backend(group)`` and the bytes copied each
way are counted in ``shift.staged_bytes`` (callers may reset it).  Gloo's
``all_gather`` takes CUDA tensors itself, and they are passed as they are.
Nothing here changes a value: the engines keep the single-device bits.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("batch", "space"),
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of the given shape and dim names over the first
    ``prod(shape)`` ranks of the initialised default group (default: all
    ranks on the first axis, the others of size 1).  Collective: every
    rank of the default group calls it, also the ranks a smaller mesh
    leaves out (their ``get_coordinate()`` is None)."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    need = 1
    for s in shape:
        need *= s
    if need > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} ranks, have {n}")
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's index) of ``mesh``'s ``axis``."""
    size = mesh.shape[mesh.mesh_dim_names.index(axis)]
    return mesh.get_group(axis), size, mesh.get_local_rank(axis)


def _local_block(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    _, n, i = axis_group(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} of {tuple(x.shape)} is not "
                         f"divisible by the {axis!r} axis size {n}")
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k].contiguous()


def batch_sharding(mesh: DeviceMesh, x: torch.Tensor, axis: str = "batch") -> torch.Tensor:
    """This rank's block of a ``[B, ...]`` stack along ``axis`` (the
    ``Shard(0)`` placement's local tensor): pairs ``[i B/n, (i+1) B/n)``
    for index i of n.  B must be divisible by n (ValueError)."""
    return _local_block(mesh, x, axis)


def row_sharding(mesh: DeviceMesh, x: torch.Tensor, axis: str = "space") -> torch.Tensor:
    """This rank's row block ``[H/n, W]`` of an ``[H, W]`` frame along
    ``axis`` (the ``Shard(0)`` placement's local tensor).  H must be
    divisible by n (ValueError)."""
    return _local_block(mesh, x, axis)


def shift(x: torch.Tensor, group, pairs: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: for each ``(src, dst)`` of
    ``pairs`` (indices in the group) rank ``src`` sends ``x`` to rank
    ``dst``.  Returns what this rank received, or zeros where it receives
    nothing.  Collective over the ranks named in ``pairs``."""
    me = dist.get_rank(group)
    sends = [dst for src, dst in pairs if src == me]
    recvs = [src for src, dst in pairs if dst == me]
    if not sends and not recvs:
        return torch.zeros_like(x)
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    where = torch.device("cpu") if stage else x.device
    out = torch.zeros(x.shape, dtype=x.dtype, device=where)
    ops = []
    if sends:
        data = x.to(where).contiguous()
        ops += [dist.P2POp(dist.isend, data, dist.get_global_rank(group, dst), group)
                for dst in sends]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)
            for src in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        shift.staged_bytes += x.nbytes * (bool(sends) + bool(recvs))
        return out.to(x.device) if recvs else torch.zeros_like(x)
    return out


shift.staged_bytes = 0


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled ``lax.all_gather`` along dim 0 over ``group``: the ranks'
    equal-shape shards concatenated in group order."""
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, x, group=group)
    return torch.cat(outs, dim=0)
