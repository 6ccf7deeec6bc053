"""Port parity: the variational refinement (dis_tpu_torch vs dis_tpu).

``dis_tpu_torch/ops/variational.py`` on torch CPU against
``dis_tpu/ops/variational.py`` on JAX CPU, on 40x56 planes made from
numpy seeds:

- ``refine_warp_plain`` (the ``take4`` taps) bitwise, its in-bounds mask
  equal;
- ``variational_refinement`` within 1e-4 px max |d| (the port's IRLS
  weight takes a correctly rounded ``0.5 / sqrt``, XLA's CPU ``rsqrt`` is
  not correctly rounded, and the difference grows through the sweeps to
  about 1e-5 px), at the presets' own sweep counts (``DIS_MEDIUM`` 5 x 5,
  ``DIS_FULL`` 10 x 5) and plain Gauss-Seidel (omega 1.0), both schemes,
  Q1-level padding and the exact-size intensity planes.  The JAX side
  runs eagerly (``tests/conftest.py`` jits it; ``tests/test_variational.py``
  warns about compiling the warp1 program late in a process);
- a pair axis (warp included): B = 2 equal to two single calls bitwise;
- ``intensity_pyramid`` bitwise against the JAX package's ``window2``
  decimation (the association the port copies);
- ``refine_level`` with ``refined_init_clamp`` (the clip to the
  policing-chain bound), under both schemes, within the same 1e-4 px.

The IRLS weight is pinned to ``fl(0.5 / fl(sqrt(fl(s2 + eps2))))``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.config import DIS_MEDIUM as J_MEDIUM
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu.ops import pyramid as jpyr
from dis_tpu.ops import variational as jvar
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.ops import pyramid as tpyr
from dis_tpu_torch.ops import variational as tvar

from torch_threads import one_thread

H, W = 40, 56
# (omega, inner sweeps, SOR sweeps): plain Gauss-Seidel, DIS_MEDIUM, DIS_FULL.
SWEEPS = {"gs": (1.0, 5, 1), "medium": (1.6, 5, 5), "full": (1.6, 10, 5)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _eager(fn):
    return getattr(fn, "__wrapped__", fn)


def _smooth(seed, h, w):
    from scipy.signal import convolve2d

    x = (np.random.default_rng(seed).random((h, w)) * 255).astype(np.float32)
    k = np.ones((5, 5), np.float32) / 25.0
    return convolve2d(x, k, mode="same", boundary="symm").astype(np.float32)


def _inputs(pad, seed=0, batch=None):
    """Padded planes [(B,) H + 2 pad, W + 2 pad] cut from smooth random
    images, and a flow [(B,) H, W, 2] within 2 px."""
    lead = () if batch is None else (batch,)
    n = 1 if batch is None else batch
    i1 = np.stack([_smooth(seed + 10 * k, H + 16, W + 16) for k in range(n)])
    i2 = np.stack([_smooth(seed + 10 * k + 1, H + 16, W + 16) for k in range(n)])
    cut = (slice(None), slice(8 - pad, 8 + H + pad), slice(8 - pad, 8 + W + pad))
    flow = (np.random.default_rng(seed + 5).random(lead + (H, W, 2)) - 0.5) * 4
    shape = lead + (H + 2 * pad, W + 2 * pad)
    return (np.ascontiguousarray(i1[cut]).reshape(shape),
            np.ascontiguousarray(i2[cut]).reshape(shape), flow.astype(np.float32))


def _cfg(scheme, sweeps):
    omega, inner, sor = SWEEPS[sweeps]
    return JConfig(mode="fixed", refinement_iters=1, refinement_inner_sweeps=inner,
                   refinement_sor_sweeps=sor, refinement_omega=omega,
                   refinement_scheme=scheme, refinement_alpha=40.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,c", [((37, 53), 6), ((H, W), 1)])
def test_warp_bilinear_bitwise(shape, c):
    rng = np.random.default_rng(11)
    planes = rng.random(shape + (c,)).astype(np.float32)
    flow = ((rng.random(shape + (2,)) - 0.5) * 9).astype(np.float32)
    want, want_inb = jvar._warp_bilinear(jnp.asarray(planes), jnp.asarray(flow))
    got, got_inb = tvar.refine_warp_plain(_t(planes), _t(flow))
    assert not bool(got_inb.all()) and bool(got_inb.any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_inb.numpy(), np.asarray(want_inb))


@pytest.mark.parametrize("sweeps", sorted(SWEEPS))
@pytest.mark.parametrize("pad", ["img_padding", "0"])
@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
def test_refinement_matches_jax(scheme, pad, sweeps):
    jcfg = _cfg(scheme, sweeps)
    p = jcfg.img_padding if pad == "img_padding" else 0
    i1, i2, flow = _inputs(p, seed=3)
    want = np.asarray(_eager(jvar.variational_refinement)(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(flow), jcfg, pad=p))
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    got = tvar.variational_refinement(_t(i1), _t(i2), _t(flow), tcfg, pad=p).numpy()
    assert got.shape == want.shape == (H, W, 2)
    assert np.isfinite(got).all()
    assert np.abs(got - flow).max() > 1e-2          # the refinement moved the flow
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
def test_refinement_pair_axis_equals_singles_bitwise(scheme):
    jcfg = _cfg(scheme, "medium")
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    i1, i2, flow = _inputs(0, seed=6, batch=2)
    got = tvar.variational_refinement(_t(i1), _t(i2), _t(flow), tcfg, pad=0)
    assert got.shape == (2, H, W, 2)
    for i in range(2):
        one = tvar.variational_refinement(_t(i1[i]), _t(i2[i]), _t(flow[i]), tcfg, pad=0)
        assert torch.equal(got[i], one), i


def test_psi_deriv_is_correctly_rounded_root():
    rng = np.random.default_rng(7)
    s2 = np.concatenate([rng.random(20000) * 10.0 ** rng.integers(-8, 6, 20000),
                         [0.0, 1e-30]]).astype(np.float32)
    for eps2 in (tvar._EPS2_DATA, tvar._EPS2_SMOOTH):
        want = np.float32(0.5) / np.sqrt(s2 + np.float32(eps2))
        np.testing.assert_array_equal(tvar._psi_deriv(_t(s2), eps2).numpy(), want)


@pytest.mark.parametrize("batch", [None, 2])
def test_intensity_pyramid_bitwise(batch, monkeypatch):
    monkeypatch.setenv("DIS_TPU_RESIZE", "window2")
    rng = np.random.default_rng(8)
    n = batch or 1
    imgs = (rng.random((n, 48, 64)) * 255).astype(np.float32)
    got = tpyr.intensity_pyramid(_t(imgs if batch else imgs[0]), 3)
    assert [tuple(g.shape[-2:]) for g in got] == [(48, 64), (24, 32), (12, 16), (6, 8)]
    for i in range(n):
        want = jpyr.intensity_pyramid(jnp.asarray(imgs[i]), 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal((g[i] if batch else g).numpy(), np.asarray(w))


CLAMP_CASES = [("intensity", "planes6"), ("q1", "planes6"), ("intensity", "warp1"),
               ("q1", "warp1")]


@pytest.mark.parametrize("planes,scheme", CLAMP_CASES,
                         ids=[pl + ("" if sc == "planes6" else f"-{sc}")
                              for pl, sc in CLAMP_CASES])
def test_refine_level_clamp_matches_jax(planes, scheme):
    """``DIS_MEDIUM`` (2 x 2 sweeps) with the clamp at scale 1 of 2: a flow of 11 +- 2
    px refined and clipped to ``motion_bound`` (12 px), on the Q1 level
    planes or the intensity planes of that scale, under either scheme (the
    port clips in R3's compose mode)."""
    from types import SimpleNamespace

    jcfg = dataclasses.replace(J_MEDIUM, coarsest_scale=2, refined_init_clamp=True,
                               refinement_planes=planes, refinement_inner_sweeps=2,
                               refinement_sor_sweeps=2, refinement_scheme=scheme)
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    bound = jdis.motion_bound(jcfg, 1)
    assert tdis.motion_bound(tcfg, 1) == bound == 12.0
    p = jcfg.img_padding if planes == "q1" else 0
    i1, i2, flow = _inputs(p, seed=9)
    flow = flow + np.float32(11.0)

    def args(conv):
        levels = [SimpleNamespace(img=conv(x)) for x in (i1, i2)]
        per_scale = None if planes == "q1" else [[None, conv(x)] for x in (i1, i2)]
        return levels + [conv(flow)], per_scale

    (l1, l2, f), jp = args(jnp.asarray)
    want = np.asarray(jdis.refine_level(l1, l2, f, jcfg, 1, jp))
    (l1, l2, f), tp = args(_t)
    got = tdis.refine_level(l1, l2, f, tcfg, 1, tp).numpy()
    assert np.abs(got).max() == bound          # the clip binds (on about 2% of values)
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()
