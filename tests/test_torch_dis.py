"""Port parity end to end: ``dis_tpu_torch.dis_flow`` vs ``dis_tpu.dis_flow``.

Two of the synthetic motion families of ``dis_tpu_torch.utils.synth`` and the
translated pair of ``conftest.synthetic_pair``, in compat and fixed
mode, on CPU (the port's plain paths of kernels K1-K3).

Gates: mean |flow_port - flow_jax| <= 1e-3 px, at most 1% of pixels
over 1e-2 px, and |EPE_port - EPE_jax| <= 1e-3 px.  Bitwise agreement is
not the contract: the two differ by about an ulp in the pyramid (XLA's
CPU fusion, the decimation's association) and in the search's sums, and
one ulp can flip a near-threshold policing decision (PARITY.md:62-67).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu_torch.utils import synth
from dis_tpu_torch import interop

from conftest import synthetic_pair

H, W = 64, 96
CONFIGS = {
    "compat": JConfig(iterations=16, patch_size=8, coarsest_scale=2, finest_scale=0,
                      patch_overlap=0.3, mode="compat", early_exit=False),
    "fixed": JConfig(iterations=16, patch_size=8, coarsest_scale=2, finest_scale=0,
                     patch_overlap=0.3, mode="fixed"),
    "fixed_finest1": JConfig(iterations=12, patch_size=8, coarsest_scale=3,
                             finest_scale=1, patch_overlap=0.3, mode="fixed"),
}


def _pair(name):
    if name == "synthetic_pair":
        i1, i2 = synthetic_pair(H, W, shift=(2.0, 1.0))
        gt = np.broadcast_to(np.float32([2.0, 1.0]), (H, W, 2))
        return i1, i2, gt, np.ones((H, W), bool)
    return synth.make_pair(name, H, W)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("pair", ["translation", "rotation", "synthetic_pair"])
def test_dis_flow_matches_jax(pair, cfg_name):
    jcfg = CONFIGS[cfg_name]
    i1, i2, gt, valid = _pair(pair)
    ref = np.asarray(jdis.dis_flow(jnp.asarray(i1), jnp.asarray(i2), jcfg))
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    got = dis_tpu_torch.dis_flow(torch.from_numpy(np.ascontiguousarray(i1)),
                                 torch.from_numpy(np.ascontiguousarray(i2)), tcfg)
    got = got.numpy()
    assert got.shape == ref.shape == (H, W, 2)
    assert np.isfinite(got).all()
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()
    epe_port = synth.masked_epe(got, gt, valid)
    epe_jax = synth.masked_epe(ref, gt, valid)
    assert abs(epe_port - epe_jax) <= 1e-3, (epe_port, epe_jax)
