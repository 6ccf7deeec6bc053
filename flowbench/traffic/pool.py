"""The pool of distinct pairs a cell's client sends, made on the device
from ``--seed`` by the one generator every traffic mix goes through.

A mix (``flowbench/mixes/<traffic>.json``) lists the pool's entries,
each a name, a family of ``families.FAMILIES``, a number of pairs and
the family's parameters; every seed gets the same entries in the same
numbers, so the work is the same from seed to seed, in another order and
on other textures.  The seed draws the order and one texture seed a pair
(a second for the disk of ``discontinuous``), each of which seeds a
``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from . import families


@dataclasses.dataclass
class Pool:
    """P pairs of one frame size, on one device."""

    names: List[str]           # the entry of each pair
    img1: torch.Tensor         # [P, H, W] float32
    img2: torch.Tensor         # [P, H, W] float32
    gt: torch.Tensor           # [P, H, W, 2] float32
    valid: torch.Tensor        # [P, H, W] bool

    def __len__(self) -> int:
        return len(self.names)


def _device_rand(seed: int, device) -> families.Rand:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return lambda shape: torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def make_pool(entries: List[Dict], seed: int, height: int, width: int,
              device) -> Pool:
    """The pool of a mix's ``entries`` ({"name", "family", "pairs",
    "params"}) at [height, width]."""
    if len({e["name"] for e in entries}) != len(entries):
        raise ValueError("two entries of a mix share a name")
    order = [e for e in entries for _ in range(e["pairs"])]
    host = torch.Generator()
    host.manual_seed(seed)
    perm = torch.randperm(len(order), generator=host).tolist()
    tex_seeds = torch.randint(0, 2 ** 62, (len(order), 2), generator=host).tolist()
    names, img1, img2, gt, valid = [], [], [], [], []
    for k, i in enumerate(perm):
        e = order[i]
        kw = dict(e.get("params", {}))
        if e["family"] == "discontinuous":
            kw["fg_rand"] = _device_rand(tex_seeds[k][1], device)
        a, b, f, v = families.FAMILIES[e["family"]](_device_rand(tex_seeds[k][0], device),
                                                    height, width, device, **kw)
        names.append(e["name"])
        img1.append(a)
        img2.append(b)
        gt.append(f)
        valid.append(v)
    return Pool(names, torch.stack(img1), torch.stack(img2), torch.stack(gt),
                torch.stack(valid))
