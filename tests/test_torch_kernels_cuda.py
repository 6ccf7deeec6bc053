"""Kernels K1-K3 (and K2b, K1b: the pair axis) against their plain
PyTorch versions on a CUDA GPU; batched flows against serial ones, and
CUDA-graph replay (``serving.aot_compile``) against the eager path, both
bitwise.

Marked ``cuda``: each test skips (from a fixture, at run time) where
``torch.cuda.is_available()`` is false, as on the CPU test machines.  On
a machine with a card and ``nvcc``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not need.)  Gates: K3 and K2 bitwise; K1 equal to its plain
version to 1e-3 px on patches whose freeze state agrees, with < 2% freeze
flips (the kernel uses the same pair trees and no FMA, so it is bitwise
in practice); ``dis_flow`` through the kernels within 1e-3 px mean of
the plain path.
"""

import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search
from dis_tpu_torch.ops.cuda.pyramid_kernel import pyramid_level
from dis_tpu_torch.ops.grid import make_grid
from dis_tpu_torch.ops.pyramid import pyramid_level_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")


def _smooth(h, w, seed):
    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    big = (r.random((h + 16, w + 16)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    return big[8:8 + h, 8:8 + w], big[6:6 + h, 5:5 + w]


@pytest.mark.parametrize("shape", [(64, 96), (37, 53)])
def test_pyramid_level_bitwise(shape):
    x = torch.from_numpy(np.ascontiguousarray(_smooth(*shape, 1)[0])).cuda()
    kern = pyramid_level(x, 8, base=True)
    ref = pyramid_level_plain(x, 8, base=True)
    for a, b in zip(kern, ref):
        assert torch.equal(a, b)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        for a, b in zip(pyramid_level(kern[0], 8, base=False),
                        pyramid_level_plain(kern[0], 8, base=False)):
            assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("ps", [8, 10, 12, 16])
@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_extract_and_search(ps, mode):
    a, b = _smooth(72, 104, ps)
    dev = torch.device("cuda")
    l1 = pyramid_level(torch.from_numpy(np.ascontiguousarray(a)).to(dev), ps, True)
    l2 = pyramid_level(torch.from_numpy(np.ascontiguousarray(b)).to(dev), ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=12, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.5, mode=mode)
    geom = make_grid(104, 72, cfg.steps)
    centers = torch.from_numpy(geom.centers).to(dev)
    init_u = torch.from_numpy(np.random.default_rng(ps).uniform(
        -2, 2, geom.centers.shape).astype(np.float32)).to(dev)
    pos0 = centers + init_u
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    conv0 = iclk.out_of_bounds(pos0, ps, 104, 72)
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    kr = extract_regions(l2[0], pos0, ps, ps)
    pr = iclk.extract_regions_plain(l2[0], pos0, ps, ps)
    for x, y in zip(kr, pr):
        assert torch.equal(x, y)
    args = (tpl, Tn, centers, init_u, conv0, cfg, 104, 72)
    ku, kq, kc = iclk_search(*kr, *args)
    pu, pq, pc = iclk.iclk_search_plain(*pr, *args)
    torch.cuda.synchronize()
    agree = kc == pc
    assert float((~agree).float().mean()) < 0.02
    assert float((ku - pu).abs().max(dim=1).values[agree].max()) <= 1e-3


def test_extract_zero_patches():
    img = torch.zeros((40, 56), device="cuda")
    regions, by, bx = extract_regions(img, torch.zeros((0, 2), device="cuda"), 8, 8)
    torch.cuda.synchronize()
    assert regions.shape == (0, 19, 19) and by.shape == bx.shape == (0,)


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_dis_flow_kernels_vs_plain(mode):
    a, b = _smooth(96, 160, 3)
    x, y = (torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in (a, b))
    cfg = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                  patch_overlap=0.3, mode=mode)
    wrappers = (pyramid_level, extract_regions, iclk_search)
    for w in wrappers:
        w.launches = 0
    flow = dis_tpu_torch.dis_flow(x, y, cfg)
    assert all(w.launches > 0 for w in wrappers)
    plain = dis_tpu_torch.dis_flow(x, y, cfg, plain=True)
    d = torch.linalg.vector_norm(flow - plain, dim=-1)
    assert flow.device.type == "cuda" and bool(torch.isfinite(flow).all())
    assert float(d.mean()) <= 1e-3 and float((d > 1e-2).float().mean()) <= 0.01


def _batch(b, h, w, seed):
    pairs = [_smooth(h, w, seed + i) for i in range(b)]
    return tuple(torch.from_numpy(np.stack([p[k] for p in pairs])).cuda() for k in (0, 1))


@pytest.mark.parametrize("b", [1, 3])
def test_pyramid_level_batched_bitwise(b):
    x, _ = _batch(b, 64, 96, 11)
    for base, src in ((True, x), (False, pyramid_level(x, 8, base=True)[0])):
        kern = pyramid_level(src, 8, base=base)
        for i in range(b):
            one = pyramid_level(src[i], 8, base=base)
            ref = pyramid_level_plain(src[i], 8, base=base)
            for k, o, r in zip(kern, one, ref):
                assert torch.equal(k[i], o) and torch.equal(k[i], r)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_extract_and_search_batched(mode):
    """K2b and K1b on 3 pairs: bitwise equal to the batched plain versions
    and to one K2/K1 call per pair, in one launch each."""
    b, ps = 3, 8
    x, y = _batch(b, 72, 104, 21)
    l1 = pyramid_level(x, ps, True)
    l2 = pyramid_level(y, ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=12, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.5, mode=mode)
    geom = make_grid(104, 72, cfg.steps)
    centers = torch.from_numpy(geom.centers).cuda()
    init_u = torch.from_numpy(np.random.default_rng(5).uniform(
        -2, 2, (b,) + geom.centers.shape).astype(np.float32)).cuda()
    pos0 = centers + init_u
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    conv0 = iclk.out_of_bounds(pos0, ps, 104, 72)
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    extract_regions.launches = iclk_search.launches = 0
    kr = extract_regions(l2[0], pos0, ps, ps)
    args = (tpl, Tn, centers, init_u, conv0, cfg, 104, 72)
    kout = iclk_search(*kr, *args)
    assert extract_regions.launches == 1 and iclk_search.launches == 1
    pr = iclk.extract_regions_plain(l2[0], pos0, ps, ps)
    pout = iclk.iclk_search_plain(*pr, *args)
    for k, p in zip(kr + kout, pr + pout):
        assert torch.equal(k, p)
    for i in range(b):
        one = extract_regions(l2[0][i], pos0[i], ps, ps)
        tpl_i = iclk.PatchTemplates(*(t[i] for t in tpl))
        out_i = iclk_search(*one, tpl_i, None if Tn is None else Tn[i], centers,
                            init_u[i], conv0[i], cfg, 104, 72)
        for k, o in zip(kr + kout, one + out_i):
            assert torch.equal(k[i], o)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_batched_flow_equals_serial(mode):
    x, y = _batch(3, 75, 118, 31)
    cfg = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                  finest_scale=1 if mode == "fixed" else 0,
                                  patch_overlap=0.3, mode=mode)
    flows = dis_tpu_torch.dis_flow(x, y, cfg)
    for i in range(3):
        assert torch.equal(flows[i], dis_tpu_torch.dis_flow(x[i], y[i], cfg))


@pytest.mark.parametrize("batch", [None, 2])
def test_graph_replay_equals_eager(batch):
    from dis_tpu_torch.serving import aot_compile

    x, y = _batch(batch or 1, 75, 118, 41)
    if batch is None:
        x, y = x[0], y[0]
    cfg = dis_tpu_torch.DIS_FAST
    compiled = aot_compile(cfg, 75, 118, batch=batch)
    eager = dis_tpu_torch.dis_flow(x, y, cfg)
    for _ in range(2):
        assert torch.equal(compiled(x, y), eager)
    with pytest.raises(ValueError, match="compiled for"):
        compiled(x[..., :-1], y[..., :-1])


def test_graph_replay_after_plan_churn():
    """The graph reads its bucket's plans at every replay: making many
    other plans and refilling the allocator must not change its flow."""
    from dis_tpu_torch.ops.grid import scale_plan
    from dis_tpu_torch.serving import aot_compile

    x, y = _batch(1, 75, 118, 43)
    x, y = x[0], y[0]
    cfg = dis_tpu_torch.DIS_FAST
    compiled = aot_compile(cfg, 75, 118)
    eager = dis_tpu_torch.dis_flow(x, y, cfg)
    dev = x.device
    for k in range(80):
        scale_plan(40 + k, 24, cfg.steps, cfg.patch_size, dev)
    torch.cuda.empty_cache()
    junk = [torch.full((n,), float("nan"), device=dev) for n in (1 << 10, 1 << 16, 1 << 20)
            for _ in range(8)]
    assert torch.equal(compiled(x, y), eager)
    del junk
