"""A saved serving artifact of a refinement config on the CPU: its
unrolled sweeps round trip through ``export_flow`` and ``load_exported``
bitwise.  (On its own: at tens of thousands of graph nodes, its export,
save and load take most of a minute.)"""

import dataclasses

import torch

import dis_tpu_torch
from dis_tpu_torch import serving

from conftest import synthetic_pair
from torch_threads import one_thread


def test_cpu_roundtrip_refinement_is_bitwise():
    """``DIS_MEDIUM``'s options (fixed mode, per-level refinement on the
    intensity planes, 5 x 5 sweeps) with two scales and one weight
    update: the unrolled sweeps round trip bitwise."""
    cfg = dataclasses.replace(dis_tpu_torch.DIS_MEDIUM, coarsest_scale=1,
                              refinement_iters=1)
    i1, i2 = synthetic_pair(40, 48)
    with one_thread():
        run, _ = serving.load_exported(serving.export_flow(cfg, 40, 48, device="cpu"))
        assert torch.equal(run(i1, i2), dis_tpu_torch.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg))
