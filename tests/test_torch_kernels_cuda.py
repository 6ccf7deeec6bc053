"""Kernels K1-K3 (and K2b, K1b: the pair axis; K2c, the column-banded
K2) against their plain PyTorch versions on a CUDA GPU; batched and tiled
flows against serial and untiled ones, and CUDA-graph replay
(``serving.aot_compile``) against the eager path, all bitwise.

Marked ``cuda``: each test skips (from a fixture, at run time) where
``torch.cuda.is_available()`` is false, as on the CPU test machines.  On
a machine with a card and ``nvcc``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not need.)  Gates: K3 (every level of a pyramid in one
launch), K2 and K1 bitwise (K1 uses the plain version's pair trees and
no FMA; K2 and K2c also with windows outside their group's staged box,
groups straddling columns and ragged last groups), K1 also on warps
whose patches freeze at different trips;
``dis_flow`` through the kernels within 1e-3 px mean of the plain path,
with the refinement presets too; the refinement (torch ops) on the card
bitwise equal to the same call on the CPU.
"""

import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
from dis_tpu_torch.ops.cuda.iclk_kernel import iclk_search, lane_layout
from dis_tpu_torch.ops.cuda.pyramid_kernel import MAX_LEVELS, pyramid_level, pyramid_levels
from dis_tpu_torch.ops.grid import make_grid
from dis_tpu_torch.ops.pyramid import construct_pyramid, pyramid_level_plain

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
@pytest.mark.parametrize("spread", [2.0, 24.0])
def test_extract_and_search(ps, mode, spread):
    """K2 (groups of plain consecutive patches, and groups that follow the
    grid's columns) and K1 bitwise; a spread of 24 px sends many windows
    outside their group's staged box."""
    a, b = _smooth(72, 104, ps)
    dev = torch.device("cuda")
    l1 = pyramid_level(torch.from_numpy(np.ascontiguousarray(a)).to(dev), ps, True)
    l2 = pyramid_level(torch.from_numpy(np.ascontiguousarray(b)).to(dev), ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=12, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.5, mode=mode)
    geom = make_grid(104, 72, cfg.steps)
    centers = torch.from_numpy(geom.centers).to(dev)
    init_u = torch.from_numpy(np.random.default_rng(ps).uniform(
        -spread, spread, geom.centers.shape).astype(np.float32)).to(dev)
    pos0 = centers + init_u
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    conv0 = iclk.out_of_bounds(pos0, ps, 104, 72)
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    kr = extract_regions(l2[0], pos0, ps, ps)
    kc = extract_regions(l2[0], pos0, ps, ps, num_h=geom.num_h)
    pr = iclk.extract_regions_plain(l2[0], pos0, ps, ps)
    for x, y, z in zip(kr, kc, pr):
        assert torch.equal(x, z) and torch.equal(y, z)
    args = (tpl, Tn, centers, init_u, conv0, cfg, 104, 72)
    kout = iclk_search(*kr, *args)
    pout = iclk.iclk_search_plain(*pr, *args)
    torch.cuda.synchronize()
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)


def test_extract_patch_sizes_in_any_order():
    """K2 and K2c at ps 16, 6, 16, 8, 30: a launch for a smaller region
    after a larger one leaves the larger one launchable (each is bitwise
    equal to the plain version)."""
    a, _ = _smooth(96, 128, 7)
    dev = torch.device("cuda")
    for ps in (16, 6, 16, 8, 30, 8):
        plane = pyramid_level_plain(torch.from_numpy(np.ascontiguousarray(a)).to(dev), ps,
                                    True)[0]
        geom = make_grid(128, 96, max(1, ps // 2))
        pos0 = torch.from_numpy(geom.centers + np.random.default_rng(ps).uniform(
            -3, 3, geom.centers.shape).astype(np.float32)).to(dev)
        pr = iclk.extract_regions_plain(plane, pos0, ps, ps)
        for got in (extract_regions(plane, pos0, ps, ps, num_h=geom.num_h),
                    extract_regions_banded(plane, pos0, ps, ps, geom, 3.0)):
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, pr))


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
    wrappers = (pyramid_levels, extract_regions, iclk_search)
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


def _staged_outside(base_y, base_x, num_h, ps, tw):
    """Windows that lie outside their group's staged rows, from the bases:
    each column of ``num_h`` patches in the groups of ``group_layout``;
    the box's left edge aligned down to 4 floats and its pitch up to 4
    (``tw % 4 == 0``), its rows cut to ``STAGE_FLOATS`` and to none when
    fewer than one window's."""
    from dis_tpu_torch.ops.cuda import extract_kernel as ek

    rc = 2 * ps + 3
    vec = tw % 4 == 0
    by = base_y.reshape(-1, num_h).cpu().numpy()
    bx = base_x.reshape(-1, num_h).cpu().numpy()
    size = ek.group_layout(num_h)[1]
    count = 0
    for first in range(0, num_h, size):
        gy, gx = by[:, first:first + size], bx[:, first:first + size]
        y0 = gy.min(1, keepdims=True)
        xa = gx.min(1, keepdims=True) & ~3 if vec else gx.min(1, keepdims=True)
        pitch = gx.max(1, keepdims=True) + rc - xa
        pitch = (pitch + 3) & ~3 if vec else pitch
        rows = np.minimum(gy.max(1, keepdims=True) + rc - y0, ek.STAGE_FLOATS // pitch)
        rows = np.where(rows < rc, 0, rows)
        count += int((gy - y0 + rc > rows).sum())
    return count


@pytest.mark.parametrize("ps,row0,batch", [(8, 0, None), (8, 16, None), (12, 8, 2), (8, 0, 3)])
def test_banded_extract_bitwise(ps, row0, batch):
    """K2c equal to its plain version and to K2 bitwise, one launch, no
    window outside the staged box, with a stripe's row0 and a pair axis."""
    dev = torch.device("cuda")
    b = batch or 1
    x, _ = _batch(b, 96, 160, 51 + ps)
    planes = pyramid_level(x, ps, True)[0]
    if batch is None:
        planes = planes[0]
    planes = planes[..., row0:, :].contiguous()
    cfg = dis_tpu_torch.DISConfig(patch_size=ps, patch_overlap=0.5)
    geom = make_grid(160, 96, cfg.steps, iy_range=(2, 12))
    bound = 6.0
    init = np.random.default_rng(ps).uniform(-bound, bound,
                                             (b,) + geom.centers.shape).astype(np.float32)
    pos0 = torch.from_numpy(geom.centers + (init if batch else init[0])).to(dev)
    outside = torch.zeros(1, dtype=torch.int32, device=dev)
    extract_regions_banded.launches = 0
    kc = extract_regions_banded(planes, pos0, ps, ps, geom, bound, row0, outside)
    assert extract_regions_banded.launches == 1
    k2 = extract_regions(planes, pos0, ps, ps, row0)
    pr = iclk.extract_regions_plain(planes, pos0, ps, ps, row0)
    torch.cuda.synchronize()
    for a, k, p in zip(kc, k2, pr):
        assert torch.equal(a, p) and torch.equal(a, k)
    assert int(outside) == 0 == _staged_outside(kc[1], kc[2], geom.num_h, ps, planes.shape[-1])


@pytest.mark.parametrize("spread,batch", [(30.0, None), (56.0, 2)])
def test_banded_outside_box_is_copied(spread, batch):
    """Inits up to the 4K finest scale's static bound (56 px) and past the
    stated one: the windows outside the staged box come from device memory
    and the result is still exact, equal to K2's and to the plain one."""
    dev = torch.device("cuda")
    b = batch or 1
    x, _ = _batch(b, 160, 256, 61)
    planes = pyramid_level(x, 8, True)[0]
    if batch is None:
        planes = planes[0]
    geom = make_grid(256, 160, 4)
    init = np.random.default_rng(2).uniform(-spread, spread,
                                            (b,) + geom.centers.shape).astype(np.float32)
    pos0 = torch.from_numpy(geom.centers + (init if batch else init[0])).to(dev)
    outside = torch.zeros(1, dtype=torch.int32, device=dev)
    kc = extract_regions_banded(planes, pos0, 8, 8, geom, 2.0, 0, outside)
    k2 = extract_regions(planes, pos0, 8, 8, num_h=geom.num_h)
    pr = iclk.extract_regions_plain(planes, pos0, 8, 8)
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) and torch.equal(k, p) for a, k, p in zip(kc, k2, pr))
    assert int(outside) == _staged_outside(kc[1], kc[2], geom.num_h, 8, planes.shape[-1]) > 0


@pytest.mark.parametrize("num_h", [1, 5, 18, 33, 75])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("plane", ["aligned", "odd_width", "offset_pointer"])
def test_extract_groups_straddle_and_ragged(num_h, batch, plane):
    """Columns of num_h patches (a ragged last group where num_h is not a
    multiple of the column's group size, ``group_layout``):
    K2 with plain consecutive groups (straddling two columns), K2 with the
    column length and K2c, all bitwise equal to the plain version, on
    16-byte-aligned planes, planes of odd width and planes that start 4
    bytes past an aligned address (both staged with 4-byte copies)."""
    dev = torch.device("cuda")
    ps, steps = 8, 3
    num_w = 7
    h, w = num_h * steps + 4, num_w * steps + 30 + (1 if plane == "odd_width" else 0)
    r = np.random.default_rng(num_h * 10 + batch)
    th, tw = h + 2 * ps, w + 2 * ps
    img = torch.from_numpy((r.random(batch * th * tw + 1) * 255).astype(np.float32)).to(dev)
    start = 1 if plane == "offset_pointer" else 0
    planes = img[start:start + batch * th * tw].view(batch, th, tw)
    assert planes.is_contiguous() and (planes.data_ptr() % 16 == 0) == (start == 0)
    xs, ys = np.arange(num_w) * steps + 2, np.arange(num_h) * steps + 2
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel()], -1).astype(np.float32)
    init = r.uniform(-6, 6, (batch,) + centers.shape).astype(np.float32)
    pos0 = torch.from_numpy(centers + init).to(dev)
    from dis_tpu_torch.ops.grid import GridGeometry
    geom = GridGeometry(num_w, num_h, 2, 2, steps, centers)
    pr = iclk.extract_regions_plain(planes, pos0, ps, ps)
    for got in (extract_regions(planes, pos0, ps, ps),
                extract_regions(planes, pos0, ps, ps, num_h=num_h),
                extract_regions_banded(planes, pos0, ps, ps, geom, 6.0)):
        torch.cuda.synchronize()
        for a, p in zip(got, pr):
            assert torch.equal(a, p)


def test_extract_layout_matches_kernel():
    """The wrapper's launch constants are the kernel's, and the occupancy
    calculator gives the blocks per SM the launch arithmetic promises."""
    import ctypes

    from dis_tpu_torch import _build
    from dis_tpu_torch.ops.cuda import extract_kernel as ek

    lib = _build.library()
    out = (ctypes.c_int * 7)()
    for ps in (8, 10, 12, 16):
        assert lib.dis_extract_layout(ps, out) == 0
        assert list(out)[:6] == [ek.THREADS, ek.PATCHES_PER_GROUP, ek.STAGES,
                                 ek.STAGE_FLOATS, ek.MIN_BLOCKS_PER_SM, ek.shared_bytes(ps)]
        assert out[6] >= min(ek.blocks_per_sm(ps), ek.MIN_BLOCKS_PER_SM)
    assert lib.dis_extract_layout(31, out) != 0


def test_banded_empty_grid_launches_nothing():
    dev = torch.device("cuda")
    geom = make_grid(56, 40, 4, iy_range=(3, 3))
    extract_regions_banded.launches = 0
    regions, by, bx = extract_regions_banded(torch.zeros((56, 72), device=dev),
                                             torch.zeros((0, 2), device=dev), 8, 8, geom, 8.0)
    torch.cuda.synchronize()
    assert regions.shape == (0, 19, 19) and by.shape == bx.shape == (0,)
    assert extract_regions_banded.launches == 0


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_search_row0_vs_plain(mode):
    """K1 on a stripe's regions (row0 > 0) equals its plain version."""
    dev = torch.device("cuda")
    ps, row0 = 8, 24
    a, b = (torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in _smooth(96, 128, 71))
    l1 = pyramid_level(a, ps, True)
    l2 = pyramid_level(b, ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=12, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.5, mode=mode)
    geom = make_grid(128, 96, cfg.steps, iy_range=(8, 18))
    centers = torch.from_numpy(geom.centers).to(dev)
    init_u = torch.from_numpy(np.random.default_rng(4).uniform(
        -2, 2, geom.centers.shape).astype(np.float32)).to(dev)
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    conv0 = iclk.out_of_bounds(centers + init_u, ps, 128, 96)
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    stripe = l2[0][row0:].contiguous()
    kr = extract_regions(stripe, centers + init_u, ps, ps, row0)
    args = (tpl, Tn, centers, init_u, conv0, cfg, 128, 96, row0)
    ko = iclk_search(*kr, *args)
    po = iclk.iclk_search_plain(*kr, *args)
    full = iclk_search(*extract_regions(l2[0], centers + init_u, ps, ps), *args[:-1])
    torch.cuda.synchronize()
    for k, p, f in zip(ko, po, full):
        assert torch.equal(k, p) and torch.equal(k, f)


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_tiled_flow_equals_untiled(mode):
    from dis_tpu_torch.parallel import grid_tiled_flow, min_stripe_halo, tiled_flow_exact

    a, b = (torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in _smooth(512, 96, 81))
    cfg = dis_tpu_torch.DISConfig(iterations=8, patch_size=8, coarsest_scale=2,
                                  patch_overlap=0.5, mode=mode)
    untiled = dis_tpu_torch.dis_flow_padded(a, b, cfg)
    halo = min_stripe_halo(cfg, 96, 512, 2)
    assert torch.equal(tiled_flow_exact(a, b, cfg, 2, halo), untiled)
    assert torch.equal(grid_tiled_flow(a, b, cfg, 3), untiled)


@pytest.mark.parametrize("shape,coarsest", [((64, 96), c) for c in (1, 2, 3, 4)]
                         + [((376, 1248), 3), ((1072, 3840), 3), ((1072, 3840), 4)])
def test_pyramid_fused_bitwise(shape, coarsest):
    """Every plane of every level of one K3 launch (two past MAX_LEVELS
    levels) equals the plain level-by-level chain; 1072 x 3840 is a 4K
    middle stripe (720 own rows and two 176-row halos)."""
    x = torch.from_numpy(np.ascontiguousarray(_smooth(*shape, 7)[0])).cuda()
    pyramid_levels.launches = 0
    kern = construct_pyramid(x, coarsest, 8)
    assert pyramid_levels.launches == -(-(coarsest + 1) // MAX_LEVELS)
    ref = construct_pyramid(x, coarsest, 8, plain=True)
    torch.cuda.synchronize()
    assert len(kern) == len(ref) == coarsest + 1
    for k, r in zip(kern, ref):
        assert (k.width, k.height) == (r.width, r.height)
        for a, b in zip(k[:3], r[:3]):
            assert torch.equal(a, b)


def test_pyramid_fused_batched_bitwise():
    """B = 3 planes in one launch: each equals its own launch and the plain
    chain, at ps 12 padding."""
    x, _ = _batch(3, 64, 96, 13)
    pyramid_levels.launches = 0
    kern = construct_pyramid(x, 3, 12)
    assert pyramid_levels.launches == 1
    for i in range(3):
        one = construct_pyramid(x[i], 3, 12)
        ref = construct_pyramid(x[i], 3, 12, plain=True)
        for k, o, r in zip(kern, one, ref):
            for a, b, c in zip(k[:3], o[:3], r[:3]):
                assert torch.equal(a[i], b) and torch.equal(a[i], c)
    torch.cuda.synchronize()


def test_lane_layout_matches_kernel():
    import ctypes

    from dis_tpu_torch import _build

    lib = _build.library()
    for ps in range(2, 24, 2):
        k, g = ctypes.c_int(), ctypes.c_int()
        assert lib.dis_iclk_layout(ps, ctypes.byref(k), ctypes.byref(g)) == 0
        assert (k.value, g.value) == lane_layout(ps)
    assert lib.dis_iclk_layout(24, ctypes.byref(k), ctypes.byref(g)) != 0


@pytest.mark.parametrize("ps", [6, 8, 10, 12, 14, 16])
@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_search_mixed_trips_bitwise(ps, mode):
    """K1b on 2 pairs whose patches freeze at different trips inside one
    warp (random conv0, wide random init: some start frozen, some are
    policed early, fixed mode converges at varied trips) equals the plain
    version bitwise; ps 6 and 14 take the kernel's runtime-ps instances."""
    b = 2
    x, y = _batch(b, 72, 104, 90 + ps)
    l1 = pyramid_level(x, ps, True)
    l2 = pyramid_level(y, ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=14, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.6, mode=mode)
    geom = make_grid(104, 72, cfg.steps)
    r = np.random.default_rng(ps)
    centers = torch.from_numpy(geom.centers).cuda()
    init_u = torch.from_numpy(r.uniform(-ps, ps, (b,) + geom.centers.shape)
                              .astype(np.float32)).cuda()
    pos0 = centers + init_u
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    conv0 = iclk.out_of_bounds(pos0, ps, 104, 72) | torch.from_numpy(
        r.random((b, geom.centers.shape[0])) < 0.2).cuda()
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    kr = extract_regions(l2[0], pos0, ps, ps)
    args = (tpl, Tn, centers, init_u, conv0, cfg, 104, 72)
    trips = []
    pout = iclk.iclk_search_plain(*kr, *args, trips=trips)
    kout = iclk_search(*kr, *args)
    torch.cuda.synchronize()
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)
    assert len(set(trips)) > 1          # some patches froze inside the loop


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
@pytest.mark.parametrize("batch", [None, 2])
def test_refinement_card_equals_cpu(scheme, batch):
    """The refinement (torch ops, no kernel of its own) on the card equals
    the same call on the CPU bitwise: no reduction, correctly rounded
    roots and divisions, no contracted multiply-add."""
    from dis_tpu_torch.ops.variational import variational_refinement

    b = batch or 1
    x, y = _batch(b, 72, 104, 101)
    if batch is None:
        x, y = x[0], y[0]
    flow = torch.from_numpy(((np.random.default_rng(3).random(x.shape + (2,)) - 0.5) * 4)
                            .astype(np.float32)).cuda()
    cfg = dis_tpu_torch.DISConfig(mode="fixed", refinement_iters=1, refinement_inner_sweeps=5,
                                  refinement_sor_sweeps=5, refinement_omega=1.6,
                                  refinement_alpha=40.0, refinement_scheme=scheme)
    card = variational_refinement(x, y, flow, cfg, pad=0)
    cpu = variational_refinement(x.cpu(), y.cpu(), flow.cpu(), cfg, pad=0)
    torch.cuda.synchronize()
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("preset", ["DIS_MEDIUM", "DIS_FULL"])
def test_refined_dis_flow_kernels_vs_plain(preset):
    a, b = _smooth(96, 160, 5)
    x, y = (torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in (a, b))
    cfg = getattr(dis_tpu_torch, preset)
    wrappers = (pyramid_levels, extract_regions, iclk_search)
    for w in wrappers:
        w.launches = 0
    flow = dis_tpu_torch.dis_flow(x, y, cfg)
    assert all(w.launches > 0 for w in wrappers)
    plain = dis_tpu_torch.dis_flow(x, y, cfg, plain=True)
    d = torch.linalg.vector_norm(flow - plain, dim=-1)
    assert flow.device.type == "cuda" and bool(torch.isfinite(flow).all())
    assert float(d.mean()) <= 1e-3 and float((d > 1e-2).float().mean()) <= 0.01


def test_refined_graph_batch_and_tiles():
    """DIS_MEDIUM: a graph replay of a batch of 2 equals the eager batch,
    which equals its pairs alone; both tiling engines equal the untiled
    flow, all bitwise."""
    from dis_tpu_torch.parallel import grid_tiled_flow, min_stripe_halo, tiled_flow_exact
    from dis_tpu_torch.serving import aot_compile

    cfg = dis_tpu_torch.DIS_MEDIUM
    x, y = _batch(2, 96, 128, 111)
    eager = dis_tpu_torch.dis_flow(x, y, cfg)
    compiled = aot_compile(cfg, 96, 128, batch=2)
    for _ in range(2):
        assert torch.equal(compiled(x, y), eager)
    for i in range(2):
        assert torch.equal(eager[i], dis_tpu_torch.dis_flow(x[i], y[i], cfg))
    a, b = x[0], y[0]
    untiled = dis_tpu_torch.dis_flow_padded(a, b, cfg)
    assert torch.equal(grid_tiled_flow(a, b, cfg, 3), untiled)
    assert torch.equal(tiled_flow_exact(a, b, cfg, 2, min_stripe_halo(cfg, 128, 96, 2)), untiled)


def _write_sequence(root, n, h, w, seed):
    """``root/frames/frame_000{1..n}.png``: 8-bit frames, each shifted by
    (3, 2) px from the one before, written with the port's own writer."""
    from dis_tpu_torch.utils.io import imwrite

    from scipy.signal import convolve2d

    r = np.random.default_rng(seed)
    big = (r.random((h + 3 * n, w + 4 * n)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm")
    (root / "frames").mkdir()
    for t in range(n):
        y0, x0 = 2 * (n - t), 3 * (n - t)
        fr = np.clip(np.rint(big[y0:y0 + h, x0:x0 + w]), 0, 255).astype(np.uint8)
        imwrite(str(root / "frames" / f"frame_{t + 1:04d}.png"), fr)


def test_cli_batch_equals_serial_on_the_card(tmp_path, monkeypatch, capsys):
    """The CLI on the card (a CUDA graph per shape): ``--batch 2`` over 3
    pairs (its tail chunk repeats the last pair) writes the serial run's
    flows bitwise, and both are the eager kernel path's."""
    from dis_tpu_torch.cli import main
    from dis_tpu_torch.utils.flo import load_flo
    from dis_tpu_torch.utils.io import imread_gray

    _write_sequence(tmp_path, 4, 75, 118, 201)
    monkeypatch.chdir(tmp_path)
    params = ["frames", "1", "4", "16", "8", "3", "0", "0.3", "1", "0", "--save-flo",
              "--no-early-exit"]
    assert main(params + ["--out-dir", "serial"]) == 0
    assert main(params + ["--out-dir", "batch", "--batch", "2"]) == 0
    assert "fps steady-state" in capsys.readouterr().out
    cfg = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                  patch_overlap=0.3, early_exit=False)
    for t in (1, 2, 3):
        a, b = (torch.from_numpy(imread_gray(f"frames/frame_{i:04d}.png").astype(np.float32))
                .cuda() for i in (t, t + 1))
        want = dis_tpu_torch.dis_flow(a, b, cfg).cpu().numpy()
        for out in ("serial", "batch"):
            np.testing.assert_array_equal(load_flo(f"{out}/frame_{t:04d}.flo"), want)


def test_checked_raises_on_nan_on_the_card(monkeypatch):
    from dis_tpu_torch.utils import checks

    monkeypatch.setenv("DIS_TPU_CHECK", "1")
    x, y = _smooth(64, 96, 211)
    a = torch.from_numpy(np.ascontiguousarray(x)).cuda()
    b = torch.from_numpy(np.ascontiguousarray(y)).cuda()
    fn = checks.checked(lambda p, q: dis_tpu_torch.dis_flow(p, q, dis_tpu_torch.DIS_FAST))
    assert torch.equal(fn(a, b), dis_tpu_torch.dis_flow(a, b, dis_tpu_torch.DIS_FAST))
    a[10, 10] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        fn(a, b)


def test_cli_without_visible_devices_exits_nonzero(tmp_path):
    """``--device cuda`` in a process that sees no card exits non-zero
    with a reason: the CLI never carries on on the CPU."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    _write_sequence(tmp_path, 2, 32, 48, 221)
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-m", "dis_tpu_torch", "--device", "cuda",
                           "frames", "1", "2"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "OF_frames").exists()


@pytest.mark.parametrize("batch", [None, 2])
def test_cuda_artifact_replays_as_aot_compile(batch):
    """A CUDA artifact holds the kernels as ``dis_tpu_torch`` ops, one per
    launch of an eager call and no gather of a plain K2 or K1; reloaded,
    its replays equal ``aot_compile``'s bitwise."""
    from dis_tpu_torch.cost import kernel_ops
    from dis_tpu_torch.serving import aot_compile, export_flow, load_exported

    x, y = _batch(batch or 1, 75, 118, 231)
    if batch is None:
        x, y = x[0], y[0]
    cfg = dis_tpu_torch.DIS_FAST
    run, program = load_exported(export_flow(cfg, 75, 118, batch=batch))
    assert kernel_ops(program) == {"K3": 2, "K2": 4, "K2c": 0, "K1": 4}
    assert not any(n.target is torch.ops.aten.gather.default for n in program.graph.nodes)
    compiled = aot_compile(cfg, 75, 118, batch=batch)
    for _ in range(2):
        assert torch.equal(run(x, y), compiled(x, y))
    assert run.graph_launches == compiled.graph_launches
    for flow in (run, compiled):
        mem = flow.memory_analysis()
        assert mem["graph pool bytes"] >= mem["output bytes"] > 0
        assert mem["plan bytes"] > 0 and mem["plan cache bytes"] >= mem["plan bytes"]
    assert run.cost_analysis() == compiled.cost_analysis()
    with pytest.raises(ValueError, match="not for"):
        load_exported(export_flow(cfg, 75, 118, batch=batch), device="cpu")


def test_cuda_artifact_4k_holds_k2c():
    """At the 4K bucket the finest extraction is K2c, in the program as
    ``extract_regions_banded``."""
    from dis_tpu_torch.cost import kernel_ops
    from dis_tpu_torch.serving import export_flow, load_exported

    cfg = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                  finest_scale=0, patch_overlap=0.3, mode="compat",
                                  early_exit=False)
    _, program = load_exported(export_flow(cfg, 2160, 3840))
    assert kernel_ops(program) == {"K3": 2, "K2": 3, "K2c": 1, "K1": 4}


def test_two_gloo_ranks_on_one_card():
    """``tiled_flow_fn`` (halo by neighbour shifts, staged through the
    host under gloo) and ``grid_tiled_flow_fn`` over 2 ranks on card 0
    (``parallel.launch.spawn``, gloo): each bitwise the single-device
    flow on the card."""
    import torch_ranks
    from dis_tpu_torch.models.dis import dis_flow_padded
    from dis_tpu_torch.parallel.launch import spawn

    i1, i2 = (np.ascontiguousarray(x) for x in _smooth(256, 48, 3))
    cfg = dis_tpu_torch.DISConfig(iterations=6, coarsest_scale=2, patch_overlap=0.5,
                                  early_exit=False)
    cases = [("stripes", "tiled", cfg, 2, None, i1, i2), ("grid", "grid", cfg, 2, None, i1, i2)]
    out = spawn(2, torch_ranks.tiling_world, cases, device="cuda:0", timeout_s=120)
    want = dis_flow_padded(torch.from_numpy(i1).cuda(), torch.from_numpy(i2).cuda(), cfg).cpu()
    for label in ("stripes", "grid"):
        assert torch.equal(torch.cat([out[r][label] for r in range(2)]), want), label
    assert all(r["staged_bytes"] > 0 for r in out)
