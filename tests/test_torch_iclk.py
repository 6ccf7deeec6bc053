"""Port parity: grid, templates, regions and the IC-LK search
(dis_tpu_torch vs dis_tpu).

Each stage of the port is fed the JAX stage's own inputs through
``dis_tpu_torch.interop`` (NumPy in between), on torch CPU, i.e. through
the plain paths of kernels K2 and K1.

Gates: centers, the NN init, template taps, ``Hinv`` (same pair tree),
regions and bases bitwise; the search in the equivalence class of
``tests/test_pallas_iclk.py``: final ``u`` within 1e-3 px on patches
whose freeze state agrees, freeze flips < 2% (the two sides sum the
search's ``rhs`` in different orders, and a 1-ulp difference can flip a
near-threshold policing decision, PARITY.md:62-67).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.config import DISConfig as JConfig
from dis_tpu.ops import grid as jgrid
from dis_tpu.ops import iclk as jiclk
from dis_tpu.ops.pyramid import construct_pyramid as jpyramid
from dis_tpu_torch import interop
from dis_tpu_torch.ops import grid as tgrid
from dis_tpu_torch.ops import iclk as ticlk

from conftest import synthetic_pair


def _levels(h, w, ps, seed):
    """JAX level 0 of both images of a shifted pair, plus the port's
    copies of the same planes."""
    i1, i2 = synthetic_pair(h, w, shift=(2.0, 1.0), seed=seed)
    jl1 = jpyramid(jnp.asarray(i1), 0, ps)[0]
    jl2 = jpyramid(jnp.asarray(i2), 0, ps)[0]
    tl1, tl2 = interop.pyramid_from_numpy(
        [tuple(np.asarray(a) for a in (l.img, l.dx, l.dy)) + (l.width, l.height)
         for l in (jl1, jl2)])
    return jl1, jl2, tl1, tl2


@pytest.mark.parametrize("w,h,steps", [(96, 64, 5), (53, 37, 3), (240, 136, 2)])
def test_make_grid_matches(w, h, steps):
    jg = jgrid.make_grid(w, h, steps)
    tg = tgrid.make_grid(w, h, steps)
    assert (tg.num_w, tg.num_h, tg.offset_w, tg.offset_h, tg.steps) == \
        (jg.num_w, jg.num_h, jg.offset_w, jg.offset_h, jg.steps)
    np.testing.assert_array_equal(tg.centers, jg.centers)


@pytest.mark.parametrize("w,h,steps", [(96, 64, 5), (52, 36, 3)])
def test_nn_init_bitwise(w, h, steps):
    geom = jgrid.make_grid(w, h, steps)
    flow = np.random.default_rng(3).normal(size=(h // 2, w // 2, 2)).astype(np.float32)
    ref = np.asarray(jgrid.init_from_coarser_flow(geom, jnp.asarray(flow)))
    got = tgrid.init_from_coarser_flow(tgrid.scale_plan(w, h, steps, 8, torch.device("cpu")),
                                       torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ps,overlap", [(8, 0.3), (12, 0.75), (10, 0.5)])
def test_templates_and_hinv_bitwise(ps, overlap):
    jl1, _, tl1, _ = _levels(48, 72, ps, seed=5)
    cfg = JConfig(patch_size=ps, patch_overlap=overlap)
    jg = jgrid.make_grid(jl1.width, jl1.height, cfg.steps)
    # The taps are pure copies, so jit (fast) changes nothing in them.  The
    # Hessian inverse is held to the JAX function evaluated op by op: under
    # jit, XLA's CPU fusion rounds a * c - b * b differently in ~20% of
    # patches (1 ulp), so no single association matches both.
    taps = jax.jit(lambda *planes: jiclk.extract_templates_grid(*planes, jg, ps, ps))(
        jl1.img, jl1.dx, jl1.dy)
    ref = jiclk._templates_from_taps(taps.T, taps.Tdx, taps.Tdy)
    got = ticlk.extract_templates_grid(tl1.img, tl1.dx, tl1.dy,
                                       tgrid.make_grid(tl1.width, tl1.height, cfg.steps),
                                       ps, ps)
    for name in ("T", "Tdx", "Tdy", "Hinv"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_hinv_det_guard_bitwise():
    """A flat patch has det == 0: both sides add the 1e-10 guard."""
    rng = np.random.default_rng(9)
    T = rng.normal(size=(6, 64)).astype(np.float32)
    Tdx = rng.normal(size=(6, 64)).astype(np.float32)
    Tdy = rng.normal(size=(6, 64)).astype(np.float32)
    Tdx[:2] = 0.0
    Tdy[:2] = 0.0
    Tdy[2] = 2.0 * Tdx[2]           # rank-deficient: det is (near) zero
    ref = jiclk._templates_from_taps(jnp.asarray(T), jnp.asarray(Tdx), jnp.asarray(Tdy))
    t = [torch.from_numpy(a) for a in (T, Tdx, Tdy)]
    got = ticlk.templates_from_hessian(
        *t, ticlk.pairwise_sum(t[1] * t[1]), ticlk.pairwise_sum(t[1] * t[2]),
        ticlk.pairwise_sum(t[2] * t[2]))
    np.testing.assert_array_equal(got.Hinv.numpy(), np.asarray(ref.Hinv))


@pytest.mark.parametrize("n", [1, 7, 64, 100, 144, 257])
def test_pairwise_sum_bitwise(n):
    x = np.random.default_rng(n).normal(size=(5, n)).astype(np.float32)
    np.testing.assert_array_equal(ticlk.pairwise_sum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jiclk.pairwise_sum(jnp.asarray(x))))


@pytest.mark.parametrize("ps", [8, 12])
def test_regions_and_bases_bitwise(ps):
    _, jl2, _, tl2 = _levels(48, 72, ps, seed=6)
    geom = jgrid.make_grid(jl2.width, jl2.height, max(1, ps // 2))
    init = np.random.default_rng(ps).uniform(-3, 3, geom.centers.shape).astype(np.float32)
    pos0 = geom.centers + init
    pos0[:3] = [[-40.0, 5.0], [500.0, 900.0], [3.5, -2e7]]   # clipped bases
    ref = jiclk.extract_regions(jl2.img, jnp.asarray(pos0), ps, ps)
    got = ticlk.extract_regions_plain(tl2.img, torch.from_numpy(pos0), ps, ps)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_regions_accept_zero_patches():
    _, _, _, tl2 = _levels(24, 32, 8, seed=2)
    regions, by, bx = ticlk.extract_regions_plain(tl2.img, torch.zeros((0, 2)), 8, 8)
    assert regions.shape == (0, 19, 19) and by.shape == bx.shape == (0,)


def _search_pair(mode, ps, init, seed=9):
    jl1, jl2, tl1, tl2 = _levels(40, 56, ps, seed=seed)
    jcfg = JConfig(iterations=10, patch_size=ps, coarsest_scale=0,
                   patch_overlap=0.5, early_exit=False, mode=mode, kernel="xla")
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    geom = jgrid.make_grid(jl1.width, jl1.height, jcfg.steps)
    jtpl = jax.jit(lambda *planes: jiclk.extract_templates_grid(*planes, geom, ps, ps))(
        jl1.img, jl1.dx, jl1.dy)
    init_u = (np.zeros_like(geom.centers) if init == "zero" else
              np.random.default_rng(seed).uniform(-2, 2, geom.centers.shape)
              .astype(np.float32))
    ref = jax.jit(lambda img, tpl, c, u: jiclk.inverse_search(
        img, tpl, c, u, jcfg, jl1.width, jl1.height))(
            jl2.img, jtpl, jnp.asarray(geom.centers), jnp.asarray(init_u))
    ttpl = interop.templates_from_numpy(*(np.asarray(a) for a in jtpl))
    got = ticlk.inverse_search(tl2.img, ttpl, torch.from_numpy(geom.centers),
                               torch.from_numpy(init_u), tcfg, tl1.width, tl1.height)
    return ref, got


@pytest.mark.parametrize("mode", ["compat", "fixed"])
@pytest.mark.parametrize("ps", [8, 12])
@pytest.mark.parametrize("init", ["zero", "random"])
def test_inverse_search_equivalence_class(mode, ps, init):
    ref, got = _search_pair(mode, ps, init)
    rc, gc = np.asarray(ref.converged), got.converged.numpy()
    np.testing.assert_array_equal(got.start_oob.numpy(), np.asarray(ref.start_oob))
    agree = rc == gc
    du = np.abs(got.u.numpy() - np.asarray(ref.u)).max(axis=1)
    assert du[agree].max() < 1e-3, du[agree].max()
    assert (~agree).mean() < 0.02, (~agree).mean()
