"""Port parity: the exact tiling engines (dis_tpu_torch vs dis_tpu).

The engines run on torch CPU (the kernels' plain versions) against the
JAX package on JAX CPU, with the gates of ``tests/test_torch_dis.py``:
mean |flow_port - flow_jax| <= 1e-3 px and at most 1% of pixels over
1e-2 px (the two sides differ by an ulp in the pyramid and the search's
sums, which can flip a near-threshold policing decision).  Within the
port, every tiled flow equals the untiled ``dis_flow_padded`` bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu.ops import grid as jgrid
from dis_tpu.parallel import tiles as jtiles
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.parallel import tiles as ttiles

from conftest import synthetic_pair
from torch_threads import one_thread

BENCH = JConfig(iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
                patch_overlap=0.3, patch_normalization=True, mode="compat",
                early_exit=False)


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


CFG = JConfig(iterations=8, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
CFG_F1 = JConfig(iterations=6, coarsest_scale=2, finest_scale=1, patch_overlap=0.5,
                 early_exit=False)
CFG_FIXED = JConfig(iterations=8, coarsest_scale=2, patch_overlap=0.3, mode="fixed")


def _gate(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cfg,h,w,row0,own_r0,own_h,rows", [
    (CFG, 384, 48, 64, 192, 64, (192, 256)),
    (CFG, 384, 48, 128, 320, 64, (320, 384)),      # the bottom edge
    (CFG_F1, 384, 48, 64, 192, 64, (96, 128)),     # output at scale 1
], ids=["halo", "bottom", "finest1"])
def test_dis_flow_stripe_matches_jax(cfg, h, w, row0, own_r0, own_h, rows):
    i1, i2 = synthetic_pair(h, w, shift=(1.0, 2.0), seed=14)
    ref = np.asarray(jax.jit(lambda a, b: jdis.dis_flow_stripe(
        a, b, cfg, row0=row0, own_r0=own_r0, own_h=own_h, global_h=h))(
            jnp.asarray(i1[row0:]), jnp.asarray(i2[row0:])))
    tcfg = _tcfg(cfg)
    got = tdis.dis_flow_stripe(_t(i1[row0:]), _t(i2[row0:]), tcfg, row0=row0,
                               own_r0=own_r0, own_h=own_h, global_h=h)
    _gate(got.numpy(), ref)
    untiled = tdis.dis_flow_padded(_t(i1), _t(i2), tcfg)
    assert torch.equal(got, untiled[rows[0]:rows[1]])


@pytest.mark.parametrize("scale,lo,hi", [(2, 5, 11), (1, 13, 32), (0, 40, 41)])
def test_dis_scale_window_matches_jax(scale, lo, hi):
    """One scale on a window of output rows: geometry bitwise, the search
    in the equivalence class of ``tests/test_torch_iclk.py``, the flow
    under the gates above; within the port, bitwise those rows of the
    full window."""
    from dis_tpu.ops.pyramid import construct_pyramid as jpyramid

    h, w = 64, 96
    i1, i2 = synthetic_pair(h, w, shift=(2.0, 1.0), seed=23)
    jl = [jpyramid(jnp.asarray(x), CFG.coarsest_scale, CFG.img_padding) for x in (i1, i2)]
    tl = [interop.pyramid_from_numpy(
        [tuple(np.asarray(a) for a in (l.img, l.dx, l.dy)) + (l.width, l.height) for l in p])
        for p in jl]
    j1, j2, t1, t2 = jl[0][scale], jl[1][scale], tl[0][scale], tl[1][scale]
    fc = None
    if scale < CFG.coarsest_scale:
        fc = np.random.default_rng(scale).uniform(
            -1.5, 1.5, (h >> (scale + 1), w >> (scale + 1), 2)).astype(np.float32)
    def jscale(p1, p2, f):
        l1, l2 = (j._replace(img=p[0], dx=p[1], dy=p[2]) for j, p in ((j1, p1), (j2, p2)))
        return jdis.dis_scale_window(l1, l2, f, CFG, scale, lo, hi)[::2]

    jflow, jres = jax.jit(jscale)(j1[:3], j2[:3], None if fc is None else jnp.asarray(fc))
    jgeom = jgrid.make_grid(j1.width, j1.height, CFG.steps,
                            iy_range=jdis.window_patch_rows(CFG, j1.height, lo, hi))
    tcfg = _tcfg(CFG)
    tfc = None if fc is None else _t(fc)
    tflow, tgeom, tres = tdis.dis_scale_window(t1, t2, tfc, tcfg, scale, lo, hi)
    assert tgeom[:5] + tgeom[6:] == jgeom[:5] + jgeom[6:]
    np.testing.assert_array_equal(tgeom.centers, jgeom.centers)
    np.testing.assert_array_equal(tres.start_oob.numpy(), np.asarray(jres.start_oob))
    agree = tres.converged.numpy() == np.asarray(jres.converged)
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max(axis=1)
    assert (~agree).mean() < 0.02 and (du[agree].max() if agree.any() else 0) < 1e-3
    _gate(tflow.numpy(), np.asarray(jflow))
    full, _, _ = tdis.dis_scale_window(t1, t2, tfc, tcfg, scale, 0, t1.height)
    assert torch.equal(tflow, full[lo:hi])


def test_stripe_halo_validation():
    h, w = 128, 48
    i1, i2 = synthetic_pair(h, w, seed=16)
    with pytest.raises(ValueError, match="halo too small"):
        tdis.dis_flow_stripe(_t(i1[96:]), _t(i2[96:]), _tcfg(CFG), row0=96, own_r0=96,
                             own_h=32, global_h=h)
    with pytest.raises(ValueError, match="divisible"):
        tdis.dis_flow_stripe(_t(i1), _t(i2), _tcfg(CFG), row0=2, own_r0=0, own_h=32,
                             global_h=h)


@pytest.mark.parametrize("cfg,n", [(CFG, 2), (CFG_FIXED, 4)], ids=["compat2", "fixed4"])
def test_tiled_flow_exact_matches_jax(cfg, n):
    h, w = 512, 48
    i1, i2 = synthetic_pair(h, w, shift=(1.0, 1.0), seed=18)
    halo = jtiles.min_stripe_halo(cfg, w, h, n)
    tcfg = _tcfg(cfg)
    assert ttiles.min_stripe_halo(tcfg, w, h, n) == halo
    ref = np.asarray(jax.jit(lambda a, b: jtiles.tiled_flow_exact(
        a, b, cfg, n_stripes=n, halo=halo))(jnp.asarray(i1), jnp.asarray(i2)))
    got = ttiles.tiled_flow_exact(_t(i1), _t(i2), tcfg, n_stripes=n, halo=halo)
    _gate(got.numpy(), ref)
    assert torch.equal(got, tdis.dis_flow_padded(_t(i1), _t(i2), tcfg))


@pytest.mark.parametrize("cfg,n", [(CFG, 3), (CFG_F1, 4)], ids=["compat3", "finest1_4"])
def test_grid_tiled_flow_matches_jax(cfg, n):
    h, w = 192, 64
    i1, i2 = synthetic_pair(h, w, shift=(2.0, 1.0), seed=21)
    tcfg = _tcfg(cfg)
    ref = np.asarray(jax.jit(lambda a, b: jtiles.grid_tiled_flow(a, b, cfg, n))(
        jnp.asarray(i1), jnp.asarray(i2)))
    got = ttiles.grid_tiled_flow(_t(i1), _t(i2), tcfg, n)
    _gate(got.numpy(), ref)
    assert torch.equal(got, tdis.dis_flow_padded(_t(i1), _t(i2), tcfg))


def test_tiled_batch_equals_untiled():
    """A batch of pairs through both engines: bitwise the batched untiled
    flow (and so each pair's serial flow)."""
    h, w = 256, 40
    pairs = [synthetic_pair(h, w, shift=(1.0, -1.0 + i), seed=30 + i) for i in range(2)]
    a, b = (_t(np.stack([p[k] for p in pairs])) for k in (0, 1))
    tcfg = _tcfg(CFG_FIXED)
    untiled = tdis.dis_flow_padded(a, b, tcfg)
    halo = ttiles.min_stripe_halo(tcfg, w, h, 2)
    assert torch.equal(ttiles.tiled_flow_exact(a, b, tcfg, 2, halo), untiled)
    assert torch.equal(ttiles.grid_tiled_flow(a, b, tcfg, 3), untiled)


@pytest.mark.parametrize("h,n,i,halo", [(2160, 3, 1, 176), (2160, 6, 5, 200), (512, 2, 0, 64)])
def test_stripe_bounds_and_partition_match_jax(h, n, i, halo):
    tcfg = _tcfg(BENCH)
    assert ttiles.stripe_bounds(tcfg, h, n, i, halo) == jtiles.stripe_bounds(BENCH, h, n, i, halo)
    assert ttiles.window_partition(h, n) == jtiles.window_partition(h, n)
    assert ttiles.window_partition(h + 1, n) == jtiles.window_partition(h + 1, n)


def test_tiling_engines_refuse_refinement():
    """The engines no longer refuse ``DIS_MEDIUM`` and ``DIS_FULL`` (the
    presets themselves): both run them and equal the untiled flow
    bitwise, and ``tiled_flow_exact(refine=False)`` gives the stripes'
    flow without refinement."""
    h, w = 64, 48
    i1, i2 = synthetic_pair(h, w, shift=(1.0, 1.0), seed=19)
    a, b = _t(i1), _t(i2)
    with one_thread():
        for cfg in (dis_tpu_torch.DIS_MEDIUM, dis_tpu_torch.DIS_FULL):
            untiled = tdis.dis_flow_padded(a, b, cfg)
            assert untiled.shape == (h, w, 2) and bool(torch.isfinite(untiled).all())
            halo = ttiles.min_stripe_halo(cfg, w, h, 2)
            assert torch.equal(ttiles.tiled_flow_exact(a, b, cfg, 2, halo), untiled)
            assert torch.equal(ttiles.grid_tiled_flow(a, b, cfg, 2), untiled)
            bare = dataclasses.replace(cfg, refinement_iters=0)
            assert torch.equal(ttiles.tiled_flow_exact(a, b, cfg, 2, halo, refine=False),
                               tdis.dis_flow_padded(a, b, bare))
