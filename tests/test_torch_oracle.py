"""The port against the NumPy oracles of ``dis_tpu/oracle``, the
references that stand behind the JAX package.

- The refinement (``dis_tpu_torch/ops/variational.py``) against
  ``variational_oracle``, under the settings and bounds that
  ``tests/test_variational_oracle.py`` holds the JAX package to: the
  inner red-black fixed point satisfies the independently assembled
  Euler-Lagrange residual of the warp-linearized energy (alpha 0, omega
  1.0 and 1.6), and outer iterations do not raise the true warped
  energy.
- ``dis_flow_padded`` without refinement, compat and fixed mode, against
  ``reference_semantics.dis_flow_oracle`` with max |d| < 1e-2 px, as
  ``tests/test_pipeline_parity.py`` holds the JAX package.
"""

import numpy as np
import pytest
import torch

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.oracle import reference_semantics as spec
from dis_tpu.oracle import variational_oracle as vo
from dis_tpu_torch import DISConfig, dis_flow_padded
from dis_tpu_torch.ops.variational import variational_refinement

from conftest import synthetic_pair
from torch_threads import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _padded(img, pad):
    return torch.from_numpy(np.pad(img, pad, mode="edge"))


def _smooth_noise(h, w, seed, amp=0.3):
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    k = np.ones((5, 5), np.float32) / 25
    n = convolve2d(r.standard_normal((h, w)).astype(np.float32), k, "same", "symm")
    return (amp * n).astype(np.float32)


@pytest.mark.parametrize("omega,inner,sor", [(1.0, 200, 1), (1.6, 100, 5)])
def test_refinement_satisfies_euler_lagrange(omega, inner, sor):
    h, w = 16, 20
    i1, i2 = synthetic_pair(h, w, shift=(0.6, 0.3), seed=31)
    i2 = i2 + _smooth_noise(h, w, 99, amp=25.0)
    kw = dict(refinement_iters=1, refinement_inner_sweeps=inner, refinement_sor_sweeps=sor,
              refinement_alpha=0.0, mode="fixed", refinement_omega=omega)
    cfg, jcfg = DISConfig(**kw), JConfig(**kw)
    flow0 = np.zeros((h, w, 2), np.float32)
    flow0[..., 0] = 0.5 + _smooth_noise(h, w, 1, 0.1)
    flow0[..., 1] = 0.25 + _smooth_noise(h, w, 2, 0.1)
    p = cfg.img_padding
    out = variational_refinement(_padded(i1, p), _padded(i2, p), torch.from_numpy(flow0),
                                 cfg).numpy()
    du = out[..., 0] - flow0[..., 0]
    dv = out[..., 1] - flow0[..., 1]
    res_u, res_v = vo.el_residual(i1, i2, flow0, du, dv, jcfg)
    res0_u, res0_v = vo.el_residual(i1, i2, flow0, np.zeros_like(du), np.zeros_like(dv), jcfg)
    r0 = max(np.abs(res0_u).max(), np.abs(res0_v).max())
    r1 = max(np.abs(res_u).max(), np.abs(res_v).max())
    assert r1 < 0.005 * r0 and r1 < 0.1, (r0, r1)


def test_outer_iterations_do_not_increase_energy():
    h, w = 32, 40
    i1, i2 = synthetic_pair(h, w, shift=(1.0, 0.5), seed=33)
    kw = dict(refinement_iters=1, refinement_inner_sweeps=30, mode="fixed")
    cfg, jcfg = DISConfig(**kw), JConfig(**kw)
    p = cfg.img_padding
    i1p, i2p = _padded(i1, p), _padded(i2, p)
    flow = np.zeros((h, w, 2), np.float32)
    flow[..., 0] = 1.0 + _smooth_noise(h, w, 3)
    flow[..., 1] = 0.5 + _smooth_noise(h, w, 4)
    energies = [vo.energy(i1, i2, flow, jcfg)]
    for _ in range(4):
        flow = variational_refinement(i1p, i2p, torch.from_numpy(flow), cfg).numpy()
        energies.append(vo.energy(i1, i2, flow, jcfg))
    for a, b in zip(energies, energies[1:]):
        assert b <= a * 1.02 + 1e-6, energies
    assert energies[-1] < 0.75 * energies[0], energies


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_dis_flow_padded_matches_oracle(small_pair, mode):
    i1, i2 = small_pair
    kw = dict(iterations=12, coarsest_scale=2, patch_overlap=0.5, early_exit=False, mode=mode)
    want = spec.dis_flow_oracle(i1, i2, JConfig(**kw))
    got = dis_flow_padded(torch.from_numpy(i1), torch.from_numpy(i2), DISConfig(**kw)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.nanmax(err) < 1e-2, f"max abs diff {np.nanmax(err)}"
