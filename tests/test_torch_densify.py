"""Port parity: densification (dis_tpu_torch vs dis_tpu).

The same per-patch flows (and, in fixed mode, weights) made from a NumPy
seed go through the JAX phase stencil and the port's gather stencil.
Both sum the covering grid rows, then the covering grid columns, in
increasing grid order; the gate is atol 1e-5 all the same, because the
JAX stencil is compiled by XLA, which may fuse the adds differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.ops import densify as jden
from dis_tpu.ops import grid as jgrid
from dis_tpu_torch.ops import densify as tden
from dis_tpu_torch.ops import grid as tgrid

GEOMS = [(96, 64, 8, 5), (53, 37, 8, 2), (72, 48, 12, 3), (40, 24, 10, 5)]


@pytest.mark.parametrize("w,h,ps,steps", GEOMS)
@pytest.mark.parametrize("weighted", [False, True])
def test_densify_matches(w, h, ps, steps, weighted):
    jg = jgrid.make_grid(w, h, steps)
    n = jg.num_w * jg.num_h
    rng = np.random.default_rng(w * h + ps)
    u = rng.normal(size=(n, 2)).astype(np.float32) * 3
    wts = rng.uniform(0.01, 1.0, n).astype(np.float32) if weighted else None
    ref = jden.densify(jnp.asarray(u), jg, w, h, ps,
                       None if wts is None else jnp.asarray(wts))
    plan = tgrid.scale_plan(w, h, steps, ps, torch.device("cpu"))
    got = tden.densify(torch.from_numpy(u), plan,
                       None if wts is None else torch.from_numpy(wts))
    assert got.shape == (h, w, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_uniform_weight_plane_is_the_jax_copy():
    key = (20, 13, 2, 2, 5, 0)
    np.testing.assert_array_equal(tgrid._uniform_wsum(key, 96, 64, 8, 0),
                                  jden._uniform_wsum(key, 96, 64, 8, 0))


@pytest.mark.parametrize("w,h,ps,steps,lo,hi", [(96, 64, 8, 5, 10, 30), (53, 37, 8, 2, 0, 9),
                                              (72, 48, 12, 3, 40, 48), (40, 24, 10, 5, 7, 8)])
@pytest.mark.parametrize("weighted", [False, True])
def test_densify_window_matches(w, h, ps, steps, lo, hi, weighted):
    """Output rows [lo, hi) from the row-ranged grid that covers them:
    against the JAX densify with ``out_row0`` (atol 1e-5, as above), and
    bitwise those rows of the port's full densify."""
    from dis_tpu.models.dis import window_patch_rows
    from dis_tpu.config import DISConfig

    iy = window_patch_rows(DISConfig(patch_size=ps, patch_overlap=1 - steps / ps), h, lo, hi)
    jg = jgrid.make_grid(w, h, steps, iy_range=iy)
    full = jgrid.make_grid(w, h, steps)
    rng = np.random.default_rng(w * h + ps + lo)
    u_full = rng.normal(size=(full.num_w, full.num_h, 2)).astype(np.float32) * 3
    w_full = rng.uniform(0.01, 1.0, (full.num_w, full.num_h)).astype(np.float32)
    u = np.ascontiguousarray(u_full[:, iy[0]:iy[1]]).reshape(-1, 2)
    wts = np.ascontiguousarray(w_full[:, iy[0]:iy[1]]).reshape(-1) if weighted else None
    ref = jden.densify(jnp.asarray(u), jg, w, hi - lo, ps,
                       None if wts is None else jnp.asarray(wts), out_row0=lo)
    plan = tgrid.scale_plan(w, h, steps, ps, torch.device("cpu"), iy, (lo, hi))
    got = tden.densify(torch.from_numpy(u), plan,
                       None if wts is None else torch.from_numpy(wts))
    assert got.shape == (hi - lo, w, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    whole = tden.densify(torch.from_numpy(u_full.reshape(-1, 2)),
                         tgrid.scale_plan(w, h, steps, ps, torch.device("cpu")),
                         torch.from_numpy(w_full.reshape(-1)) if weighted else None)
    assert torch.equal(got, whole[lo:hi])
