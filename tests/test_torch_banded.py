"""Port parity: kernel K2c's function and the extraction route that
picks it (dis_tpu_torch vs dis_tpu).

K2c (``ops/cuda/extract_banded_kernel.py``) computes K2's function, so its
plain version is ``ops/iclk.py::extract_regions_plain``: held bitwise
against the JAX package's column-banded Pallas kernel run in interpret
mode (as ``tests/test_pallas_extract.py`` runs it), with a stripe's
``row0``, with a pair axis and on an empty grid.  The CUDA kernel itself
is held against the same plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 1c).

The route is a pure function of static shapes: with JAX's backend query
patched to "tpu" (as ``tests/test_extraction_route.py`` does), the port
must launch K2 where the TPU takes its whole-image kernel and K2c where
it takes the column-banded one, at every scale of every listed config
and size, and on every stripe of a 3- and 6-way 4K split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DIS_FAST as J_FAST
from dis_tpu.config import DIS_FULL as J_FULL
from dis_tpu.config import DIS_MEDIUM as J_MEDIUM
from dis_tpu.config import DIS_ULTRAFAST as J_ULTRAFAST
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu.ops import iclk as jiclk
from dis_tpu.ops.pallas.extract_kernel import extract_regions_banded as j_banded
from dis_tpu.parallel import tiles as jtiles
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.ops import iclk as ticlk
from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
from dis_tpu_torch.ops.cuda.extract_kernel import (MIN_BLOCKS_PER_SM, PATCHES_PER_GROUP,
                                                   STAGE_FLOATS, blocks_per_sm,
                                                   shared_bytes)
from dis_tpu_torch.ops.grid import GridGeometry
from dis_tpu_torch.parallel import tiles as ttiles

BENCH = JConfig(iterations=16, patch_size=8, coarsest_scale=3, finest_scale=0,
                patch_overlap=0.3, patch_normalization=True, mode="compat",
                early_exit=False)
ROUTE_CONFIGS = {"compat_bench": BENCH, "config3": BENCH, "fast": J_FAST,
                 "ultrafast": J_ULTRAFAST}
# Padded frames: 1920x1080 and 1242x375 pad to these for 2**3.
ROUTE_SIZES = [(1920, 1088), (1248, 376), (3840, 2160)]
JAX_TO_PORT = {"pallas_image": "K2", "pallas_banded": "K2c"}


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture
def tpu_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("cfg_name", sorted(ROUTE_CONFIGS))
@pytest.mark.parametrize("size", ROUTE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scale_route_matches_jax(tpu_backend, cfg_name, size):
    jcfg = ROUTE_CONFIGS[cfg_name]
    tcfg = _tcfg(jcfg)
    routes = []
    for scale in range(jcfg.finest_scale, jcfg.coarsest_scale + 1):
        want = jdis.scale_extraction_route(jcfg, *size, scale)
        assert want in JAX_TO_PORT, want
        got = tdis.scale_extraction_route(tcfg, *size, scale)
        assert got == JAX_TO_PORT[want], (scale, got, want)
        routes.append(got)
    # K2c exactly at the 4K finest scale.
    assert routes[0] == ("K2c" if size == (3840, 2160) and jcfg.finest_scale == 0 else "K2")
    assert routes[1:] == ["K2"] * (len(routes) - 1)


def _stripe_routes(cfg, plan_fn, bounds_fn, route_fn, width, height, n, halo):
    """[stripe][scale] extraction routes of an n-way split, from the static
    shapes dis_flow_stripe hands the route: the stripe's padded level
    plane and its local patch count."""
    out = []
    for i in range(n):
        row0, ext_h, own_r0, own_h = bounds_fn(cfg, height, n, i, halo)
        iy_plan, _ = plan_fn(cfg, height, own_r0, own_h)
        pad = cfg.img_padding
        per_scale = []
        for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
            w_s = width >> s
            num_w = -(-w_s // cfg.steps)
            iy0, iy1 = iy_plan[s]
            shape = ((ext_h >> s) + 2 * pad, w_s + 2 * pad)
            per_scale.append(route_fn(cfg, shape, num_w * (iy1 - iy0), s))
        out.append((row0, per_scale))
    return out


@pytest.mark.parametrize("n", [3, 6])
def test_stripe_route_matches_jax(tpu_backend, n):
    w, h = 3840, 2160
    halo = jtiles.min_stripe_halo(BENCH, w, h, n)
    tcfg = _tcfg(BENCH)
    assert ttiles.min_stripe_halo(tcfg, w, h, n) == halo

    def jroute(cfg, shape, npatch, s):
        bound = 0.0 if s == cfg.coarsest_scale else 2.0 * jdis.motion_bound(cfg, s + 1)
        r = jiclk.extraction_route(cfg, shape, npatch, geom=object(), init_bound=bound)
        assert r in JAX_TO_PORT, r
        return JAX_TO_PORT[r]

    def troute(cfg, shape, npatch, s):
        return ticlk.extraction_route(cfg, shape, npatch, tdis.init_bound(cfg, s))

    def jplan(cfg, height, own_r0, own_h):
        return jdis._stripe_plan(cfg, w, height, own_r0, own_h)

    want = _stripe_routes(BENCH, jplan, jtiles.stripe_bounds, jroute, w, h, n, halo)
    got = _stripe_routes(tcfg, tdis._stripe_plan, ttiles.stripe_bounds, troute, w, h, n, halo)
    assert got == want
    finest = [r[1][0] for r in got]
    if n == 3:
        assert halo == 176 and [r[0] for r in got] == [0, 544, 1264]
        assert finest == ["K2c"] * 3
    else:
        assert finest == ["K2"] + ["K2c"] * 4 + ["K2"]
    assert all(r[1][1:] == ["K2"] * BENCH.coarsest_scale for r in got)


def test_route_gates_match_jax():
    from dis_tpu.ops.pallas import extract_kernel as jext

    for rc in (19, 23, 27, 35):
        assert ticlk._slab_rows(rc) == jext._slab_rows(rc)
    for th, tw, ps in [(1096, 1936, 8), (2176, 3856, 8), (912, 3856, 8), (392, 1264, 12)]:
        assert ticlk.vmem_ok(th, tw, ps) == jext.vmem_ok(th, tw, ps)
    for ps, bound in [(8, 56.0), (8, 60.0), (8, 61.0), (12, 12.0), (8, 130.0)]:
        assert ticlk.band_width_ok(ps, bound) == jext.band_width_ok(ps, bound)


def test_route_raises_without_an_init_bound(tpu_backend):
    """Without a static init bound (per-level refinement, no clamp) the
    route no longer raises: it takes K2 at every scale of every size,
    which is the TPU's route mapped to the port (its whole-image kernel
    where that fits, its XLA extraction elsewhere: both K2 here).  With
    the clamp the bound returns, and so does K2c where the TPU bands."""
    no_bound = {**JAX_TO_PORT, "xla_regions": "K2"}
    for jcfg in (J_MEDIUM, J_FULL):
        tcfg = _tcfg(jcfg)
        for size in ROUTE_SIZES:
            for s in range(jcfg.finest_scale, jcfg.coarsest_scale):
                assert tdis.init_bound(tcfg, s) is None
                want = no_bound[jdis.scale_extraction_route(jcfg, *size, s)]
                assert tdis.scale_extraction_route(tcfg, *size, s) == want == "K2"
    jclamped = dataclasses.replace(J_MEDIUM, refined_init_clamp=True)
    clamped = _tcfg(jclamped)
    routes = {}
    for size in ROUTE_SIZES:
        for s in range(clamped.coarsest_scale + 1):
            want = jdis.scale_extraction_route(jclamped, *size, s)
            assert want in JAX_TO_PORT, want
            routes[size, s] = tdis.scale_extraction_route(clamped, *size, s)
            assert routes[size, s] == JAX_TO_PORT[want], (size, s)
    assert {k for k, r in routes.items() if r == "K2c"} == {
        ((1920, 1088), 0), ((3840, 2160), 0), ((3840, 2160), 1)}


# -- K2c's function -----------------------------------------------------------

def _banded_inputs(ps, num_h, seed, pairs=None):
    """test_pallas_extract.py's banded case: an 88x280 plane and a 12 x
    num_h x-outer grid of stride 4 with an init flow bounded by 12 px."""
    rng = np.random.default_rng(seed)
    th, tw = 88, 280
    shape = (th, tw) if pairs is None else (pairs, th, tw)
    img = (rng.random(shape) * 255).astype(np.float32)
    num_w, steps, bound = 12, 4, 12.0
    xs = (np.arange(num_w) * steps + 3).astype(np.float32)
    ys = (np.arange(num_h) * steps + 2).astype(np.float32)
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel()], -1)
    init = (rng.random(shape[:-2] + centers.shape) * 2 - 1) * bound
    pos0 = (centers + init).astype(np.float32)
    geom = GridGeometry(num_w, num_h, 3, 2, steps, centers.astype(np.float32))
    return img, pos0, geom, bound


@pytest.mark.parametrize("ps,row0", [(8, 0), (12, 0), (8, 24)])
def test_banded_function_matches_pallas_interpret(ps, row0):
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=ps + row0)
    want = j_banded(jnp.asarray(img), jnp.asarray(pos0), ps, ps, geom.num_w,
                    geom.num_h, row0=row0, interpret=True)
    plain = ticlk.extract_regions_plain(torch.from_numpy(img), torch.from_numpy(pos0),
                                        ps, ps, row0)
    extract_regions_banded.launches = 0
    wrapped = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0),
                                     ps, ps, geom, bound, row0)
    assert extract_regions_banded.launches == 0          # CPU: the plain version
    for w, p, k in zip(want, plain, wrapped):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
        np.testing.assert_array_equal(k.numpy(), np.asarray(w))


def test_banded_pair_axis_matches_per_pair_pallas():
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=3, pairs=2)
    got = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0), ps, ps,
                                 geom, bound, row0=8)
    for i in range(2):
        want = j_banded(jnp.asarray(img[i]), jnp.asarray(pos0[i]), ps, ps, geom.num_w,
                        geom.num_h, row0=8, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_banded_empty_grid():
    """num_h = 0 (a stripe's empty patch range): empty outputs.  The TPU
    kernel divides by zero there (extract_kernel.py:54-55), so the JAX
    side is its XLA extraction."""
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 0, seed=5)
    assert pos0.shape == (0, 2)
    want = jiclk.extract_regions(jnp.asarray(img), jnp.asarray(pos0), ps, ps)
    got = extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0), ps, ps,
                                 geom, bound)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    assert tuple(got[0].shape) == (0, 19, 19)


def test_banded_refusals():
    ps = 8
    img, pos0, geom, bound = _banded_inputs(ps, 16, seed=7)
    with pytest.raises(ValueError, match="x-outer grid"):
        extract_regions_banded(torch.from_numpy(img), torch.from_numpy(pos0[:-1]), ps, ps,
                               geom, bound)
    meta = torch.empty(img.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        extract_regions_banded(meta, torch.zeros(pos0.shape, device="meta"), ps, ps,
                               geom, bound)
    # A region wider than the kernel's table fields.
    with pytest.raises(ValueError, match="patch_size"):
        extract_regions_banded(meta, torch.zeros(pos0.shape, device="meta"), 32, 32,
                               geom, bound)
    assert extract_regions_banded.launches == 0


def test_banded_staged_box_fits_the_4k_route():
    """At the 4K finest scale of the compat bench config (stride 5, init
    bound 56, which no longer sizes the kernel) a 48-patch group of a
    column with up to 16 px of flow spread in y and 8 in x is staged whole
    in the fixed stage, a block's shared memory fits a Hopper block's
    227 KB, and 2 blocks share an SM; the same holds for the ps 12 grids
    the route admits."""
    cfg = _tcfg(BENCH)
    assert tdis.init_bound(cfg, 0) == 56.0
    rows = (PATCHES_PER_GROUP - 1) * cfg.steps + 19 + 16
    assert rows * ((3 + 19 + 8 + 3) & ~3) <= STAGE_FLOATS
    assert shared_bytes(8) <= 232_448 and blocks_per_sm(8) == MIN_BLOCKS_PER_SM == 2
    assert ticlk.band_width_ok(12, 60.0) and blocks_per_sm(12) == 2
