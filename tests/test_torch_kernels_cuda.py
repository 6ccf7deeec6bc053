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
whose patches freeze at different trips, and in its plane mode (windows
from the level plane) equal to its plain composition and to K2 then K1;
``dis_flow`` through the kernels within 1e-3 px mean of the plain path,
with the refinement presets too; the refinement's kernels R1 (the warp,
in its setup mode), R23 (a weight update and its half-sweeps on tiles)
and R3 (in its no-sweep mode) bitwise equal to their plain versions at
1, 2 and odd rows and columns, B = 8 and the 1080p finest level, R23
also with its half-sweeps split over launches; the 4K compat artifact
searching every scale in K1's plane mode; the refinement through them
on the card bitwise equal to the same call on the CPU, and
``plain=True`` launching none of them; each scale's
S1 (templates, inverse Hessians and the search start, once S2's), S3
(fixed mode's weights) and S4 (densification) bitwise equal to their plain
versions at ps 6-16, on a pair axis, a row-ranged grid with ``row0`` and a
window plan, S1's start at the coarsest scale and from a window of the
coarser flow with its row offset, empty grids launching nothing where the
output is empty; S1's and S4's tiles cut by the grid's, the planes' and
the output's edges, S1 at each tile shape its plan picks (ps 2-20,
strides 1-64), S4 on cover tables in another order or reaching past its
staged sub-block; S1's start read from no flow while its flag is off,
whatever pointer stands in its place; one S1 a scale on the main path,
and no start kernel left; R0 (a level's Sobel planes), R1's setup and
warp1 modes, R23's compose mode (with its clip) and R3's no-sweep mode
bitwise equal to their plain versions at 1, 2 and odd rows and columns (R0 at 1 also against a NumPy reflect reference), B
absent, 1 and 3, on padded windows and whole planes,
omega 1.0 and 1.6, and the refinement through them on the card bitwise
the CPU's with Q1 and intensity planes; F1 (the frame's padding, also of
a strided view), F2 (the intensity levels, chained past five) and F3 (the
upsample and crop) bitwise equal to their plain versions, with R0 once a
level, F2 once a frame, F1 only where the frame pads and F3 only where
finest_scale > 0; at small frames (8 x 64 to 64 x 8) K3 down to levels of
one row or column, K2 and K2b on planes shorter or narrower than a region,
and ``dis_flow`` under every preset within 1e-3 px mean of the CPU's.
"""

import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops.cuda.extract_banded_kernel import extract_regions_banded
from dis_tpu_torch.ops.cuda.extract_kernel import extract_regions
from dis_tpu_torch.ops.cuda.iclk_kernel import (iclk_search, iclk_search_plane, lane_layout,
                                                search_layout)
from dis_tpu_torch.ops.cuda.pyramid_kernel import MAX_LEVELS, pyramid_level, pyramid_levels
from dis_tpu_torch.ops.cuda import scale_kernel as sk
from dis_tpu_torch.ops.cuda.refine_kernel import (refine_setup, refine_setup_warp1,
                                                  refine_update)
from dis_tpu_torch.ops.grid import make_grid
from dis_tpu_torch.ops.pyramid import construct_pyramid, pyramid_level_plain

pytestmark = pytest.mark.cuda

SCALE_WRAPPERS = (sk.scale_templates, sk.fixed_weights, sk.densify)


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
    wrappers = ((pyramid_levels, iclk_search, iclk_search_plane, extract_regions)
                + SCALE_WRAPPERS)
    for w in wrappers:
        w.launches = 0
    flow = dis_tpu_torch.dis_flow(x, y, cfg)
    assert [w.launches for w in SCALE_WRAPPERS] == [4, 4 if mode == "fixed" else 0, 4]
    # Every scale searches in K1's plane mode: no K2.
    assert [w.launches for w in wrappers[1:4]] == [4, 4, 0] and pyramid_levels.launches > 0
    for w in wrappers:
        w.launches = 0
    plain = dis_tpu_torch.dis_flow(x, y, cfg, plain=True)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)
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


@pytest.mark.parametrize("plane", [(17, 40), (18, 18), (40, 18), (17, 17), (1, 30)])
@pytest.mark.parametrize("batch", [None, 2])
def test_extract_small_planes_bitwise(plane, batch):
    """K2 and K2b on padded planes with fewer rows or columns than a region
    (coarse levels of small frames): base 0 on that axis and every window
    index past the plane clipped to its edge, bitwise the plain version,
    at start positions over the policed range and beyond it."""
    ps = 8
    th, tw = plane
    lead = () if batch is None else (batch,)
    r = np.random.default_rng(th * tw)
    img = torch.from_numpy((r.random(lead + plane) * 255).astype(np.float32)).cuda()
    pos0 = np.stack([r.uniform(-6, tw - ps + 2, lead + (37,)),
                     r.uniform(-6, th - ps + 2, lead + (37,))], -1).astype(np.float32)
    pos0 = torch.from_numpy(pos0).cuda()
    extract_regions.launches = 0
    got = extract_regions(img, pos0, ps, ps)
    want = iclk.extract_regions_plain(img, pos0, ps, ps)
    torch.cuda.synchronize()
    assert extract_regions.launches == 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("size", [(8, 64), (9, 64), (16, 64), (64, 16), (64, 8), (1, 1),
                                  (2, 3)])
@pytest.mark.parametrize("preset", ["DIS_COMPAT_DEFAULT", "DIS_FAST", "DIS_MEDIUM",
                                    "DIS_ULTRAFAST", "DIS_FULL"])
def test_small_frames_card_equals_cpu(size, preset):
    """dis_flow at small frames on the card (coarse planes shorter than a
    region, levels of one or two rows or columns): finite, and within
    1e-3 px mean (at most 1% of pixels over 1e-2 px) of the same call on
    the CPU."""
    cfg = getattr(dis_tpu_torch, preset)
    x, y = (torch.from_numpy(np.ascontiguousarray(v)) for v in _smooth(*size, 3))
    got = dis_tpu_torch.dis_flow(x.cuda(), y.cuda(), cfg).cpu()
    want = dis_tpu_torch.dis_flow(x, y, cfg)
    assert got.shape == want.shape == size + (2,) and bool(torch.isfinite(got).all())
    d = torch.linalg.vector_norm(got - want, dim=-1)
    assert float(d.mean()) <= 1e-3 and float((d > 1e-2).float().mean()) <= 0.01


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
                         + [((376, 1248), 3), ((1072, 3840), 3), ((1072, 3840), 4)]
                         + [((8, 64), 3), ((16, 64), 3), ((64, 16), 3), ((64, 8), 3),
                            ((16, 64), 4)])
def test_pyramid_fused_bitwise(shape, coarsest):
    """Every plane of every level of one K3 launch (two past MAX_LEVELS
    levels) equals the plain level-by-level chain; 1072 x 3840 is a 4K
    middle stripe (720 own rows and two 176-row halos); small frames take
    levels of one or two rows or columns (8 x 64 down to 1 x 8, 64 x 8 to
    8 x 1, 16 x 64 in five levels to 1 x 4)."""
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


def test_search_layout_matches_kernel():
    """K1's layout function (the split layout at ps 12) against its copy."""
    import ctypes

    from dis_tpu_torch import _build

    lib = _build.library()
    for ps in range(2, 24, 2):
        k, g = ctypes.c_int(), ctypes.c_int()
        assert lib.dis_iclk_search_layout(ps, ctypes.byref(k), ctypes.byref(g)) == 0
        assert (k.value, g.value) == search_layout(ps)
    assert lib.dis_iclk_search_layout(24, ctypes.byref(k), ctypes.byref(g)) != 0


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


# Frames of the plane-mode cases: a level, a level searched on a stripe
# of its plane (row0 > 0), wide starts whose windows clip at every edge of
# the plane, and planes shorter or narrower than a region.
PLANE_FRAMES = {"mixed": (72, 104), "row0": (72, 104), "edges": (72, 104),
                "short_plane": (2, 40), "narrow_plane": (40, 2)}


def _plane_case(ps, batch, case, mode, normalize=True):
    """CUDA inputs of K1's plane mode on a level of ``PLANE_FRAMES[case]``:
    (plane, starts, the search's other arguments).  An odd number of
    patches, so that with 2 or 3 pairs a warp of 2 or 4 patches straddles
    the pairs; random start freezes and inits up to ps px (3 ps in
    "edges"), so that the patches of a warp freeze at different trips."""
    h, w = PLANE_FRAMES[case]
    x, y = _batch(batch or 1, h, w, 140 + ps)
    if batch is None:
        x, y = x[0], y[0]
    l1 = pyramid_level(x, ps, True)
    l2 = pyramid_level(y, ps, True)
    cfg = dis_tpu_torch.DISConfig(iterations=14, patch_size=ps, coarsest_scale=0,
                                  patch_overlap=0.6, mode=mode,
                                  patch_normalization=normalize)
    gnum_h = -(-h // cfg.steps)
    iy_range, row0 = ((gnum_h // 3, gnum_h), 2 * ps) if case == "row0" else (None, 0)
    geom = make_grid(w, h, cfg.steps, iy_range=iy_range)
    tpl = iclk.extract_templates_grid(*l1, geom, ps, ps)
    n = geom.num_w * geom.num_h
    n -= 1 - n % 2
    lead = () if batch is None else (batch,)
    r = np.random.default_rng(ps)
    centers = torch.from_numpy(geom.centers[:n]).cuda()
    spread = 3 * ps if case == "edges" else ps
    init_u = torch.from_numpy(r.uniform(-spread, spread, lead + (n, 2))
                              .astype(np.float32)).cuda()
    tpl = iclk.PatchTemplates(*(t[..., :n, :].contiguous() for t in tpl[:3]),
                              tpl.Hinv[..., :n, :, :].contiguous())
    pos0 = centers + init_u
    conv0 = iclk.out_of_bounds(pos0, ps, w, h) | torch.from_numpy(
        r.random(lead + (n,)) < 0.2).cuda()
    Tn = iclk.residual_template(tpl, cfg) if mode == "fixed" else None
    plane = l2[0][..., row0:, :].contiguous()
    return plane, pos0, (tpl, Tn, centers, init_u, conv0, cfg, w, h, row0)


@pytest.mark.parametrize("ps", [6, 8, 10, 12, 14, 16])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", sorted(PLANE_FRAMES))
@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_search_plane_bitwise(ps, batch, case, mode):
    """K1 in its plane mode (K1b with 2 pairs, a warp straddling them)
    equals its plain composition, ``extract_regions_plain`` then
    ``iclk_search_plain``, and K2 then K1, bitwise, in one launch and no
    K2: on warps whose patches freeze at different trips, a stripe's plane
    (row0 > 0), windows clipped at all four edges of the plane, and planes
    with fewer rows or columns than a region (K2's edge rule)."""
    plane, pos0, args = _plane_case(ps, batch, case, mode)
    row0 = args[-1]
    extract_regions.launches = iclk_search.launches = iclk_search_plane.launches = 0
    iclk_search.split_launches = iclk_search_plane.split_launches = 0
    got = iclk_search_plane(plane, pos0, *args)
    assert (extract_regions.launches, iclk_search.launches, iclk_search_plane.launches) == (
        0, 1, 1)
    # Only ps 12 takes the split layout.
    assert iclk_search.split_launches == iclk_search_plane.split_launches == int(ps == 12)
    pr = iclk.extract_regions_plain(plane, pos0, ps, ps, row0)
    trips = []
    want = iclk.iclk_search_plain(*pr, *args, trips=trips)
    k2k1 = iclk_search(*extract_regions(plane, pos0, ps, ps, row0), *args)
    torch.cuda.synchronize()
    for g, p, k in zip(got, want, k2k1):
        assert torch.equal(g, p) and torch.equal(g, k)
    if case == "mixed":
        assert len(set(trips)) > 1      # some patches froze inside the loop
    th, tw = plane.shape[-2:]
    rc = iclk.region_size(ps)
    by, bx = pr[1], pr[2]
    if case == "edges":
        assert all(bool(c.any()) for c in (by == 0, by == th - rc, bx == 0, bx == tw - rc))
    if case.endswith("_plane"):
        assert min(th, tw) < rc


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("case", ["mixed", "row0", "short_plane"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_search_split_layout_bitwise(batch, case, normalize, mode):
    """K1 at ps 12 in its split layout (16 lanes of 8 + 1 taps, two patches
    a warp), in its plane mode and in its regions mode on K2's regions,
    equals ``iclk_search_plain`` bitwise, with and without normalisation:
    an odd number of patches (the last warp's second group mirrors and
    writes nothing), 3 pairs (warps straddle two pairs), a stripe's plane
    (row0 > 0) and a plane of fewer than 27 rows (the clip path).  Both
    launches count in ``split_launches``."""
    ps = 12
    k, g = search_layout(ps)
    assert k * g < ps * ps
    plane, pos0, args = _plane_case(ps, batch, case, mode, normalize)
    row0 = args[-1]
    assert pos0.shape[-2] % 2 == 1
    if case == "short_plane":
        assert plane.shape[-2] < iclk.region_size(ps)
    for w in (iclk_search, iclk_search_plane):
        w.launches = w.split_launches = 0
    got_plane = iclk_search_plane(plane, pos0, *args)
    got_regions = iclk_search(*extract_regions(plane, pos0, ps, ps, row0), *args)
    assert (iclk_search.split_launches, iclk_search_plane.split_launches) == (2, 1)
    assert (iclk_search.launches, iclk_search_plane.launches) == (2, 1)
    want = iclk.iclk_search_plain(*iclk.extract_regions_plain(plane, pos0, ps, ps, row0),
                                  *args)
    torch.cuda.synchronize()
    for a, b, p in zip(got_plane, got_regions, want):
        assert torch.equal(a, p) and torch.equal(b, p)


def test_search_plane_empty_grid():
    """The plane mode over no patches launches nothing and returns empty
    outputs."""
    dev = torch.device("cuda")
    cfg = dis_tpu_torch.DISConfig(iterations=4, patch_size=8)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    tpl = iclk.PatchTemplates(z(0, 64), z(0, 64), z(0, 64), z(0, 2, 2))
    iclk_search_plane.launches = 0
    u, Q, conv = iclk_search_plane(z(40, 56), z(0, 2), tpl, None, z(0, 2), z(0, 2),
                                   z(0, dt=torch.bool), cfg, 40, 24)
    torch.cuda.synchronize()
    assert u.shape == (0, 2) and Q.shape == (0, 64) and conv.shape == (0,)
    assert iclk_search_plane.launches == 0


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
@pytest.mark.parametrize("batch", [None, 2])
def test_refinement_card_equals_cpu(scheme, batch):
    """The refinement on the card, through R1 and R23 (one warp, 5 weight
    updates of 10 half-sweeps each), equals the same call on the CPU
    (their plain versions) bitwise: no reduction, correctly rounded roots
    and divisions, no contracted multiply-add."""
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
    for w in REFINE_WRAPPERS:
        w.launches = 0
    card = variational_refinement(x, y, flow, cfg, pad=0)
    six = scheme == "planes6"
    assert [w.launches for w in REFINE_WRAPPERS] == [int(six), int(not six), 5]
    cpu = variational_refinement(x.cpu(), y.cpu(), flow.cpu(), cfg, pad=0)
    torch.cuda.synchronize()
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("preset", ["DIS_MEDIUM", "DIS_FULL"])
def test_refined_dis_flow_kernels_vs_plain(preset):
    a, b = _smooth(96, 160, 5)
    x, y = (torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in (a, b))
    cfg = getattr(dis_tpu_torch, preset)
    wrappers = ((pyramid_levels, iclk_search, iclk_search_plane, refine_setup, refine_update)
                + SCALE_WRAPPERS)
    for w in wrappers + (refine_setup_warp1,):
        w.launches = 0
    flow = dis_tpu_torch.dis_flow(x, y, cfg)
    assert all(w.launches > 0 for w in wrappers)
    levels = cfg.coarsest_scale - cfg.finest_scale + 1
    updates = levels * cfg.refinement_inner_sweeps
    assert [w.launches for w in REFINE_WRAPPERS] == [levels, 0, updates]
    for w in wrappers:
        w.launches = 0
    plain = dis_tpu_torch.dis_flow(x, y, cfg, plain=True)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)
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
    assert compiled.graph_launches == {"K3": 2, "K2": 0, "K2c": 0, "K1": 4, "R0": 4, "R1": 4,
                                       "R23": 20, "S1": 4, "S3": 4, "S4": 4, "F2": 1}
    for _ in range(2):
        assert torch.equal(compiled(x, y), eager)
    for i in range(2):
        assert torch.equal(eager[i], dis_tpu_torch.dis_flow(x[i], y[i], cfg))
    a, b = x[0], y[0]
    untiled = dis_tpu_torch.dis_flow_padded(a, b, cfg)
    assert torch.equal(grid_tiled_flow(a, b, cfg, 3), untiled)
    assert torch.equal(tiled_flow_exact(a, b, cfg, 2, min_stripe_halo(cfg, 128, 96, 2)), untiled)


# The refinement's kernels of an outer iteration: R1 in its setup and
# warp1 modes, and R23.
REFINE_WRAPPERS = (refine_setup, refine_setup_warp1, refine_update)


def _check_refine_kernels(batch, h, w, seed):
    """R1's setup mode (its warp reaching past every edge), R23 (omega 1.6
    and 1.0, with and without its compose mode) and R3's no-sweep mode
    against their plain versions on the same CUDA inputs, bitwise; each
    update R23's launches (``update_plan``)."""
    from dis_tpu_torch.ops import variational as tvar
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).cuda()

    planes = t(rng.random(lead + (h, w, 6)) * 255)
    flow = t((rng.random(lead + (h, w, 2)) - 0.5) * 9)
    img1 = t(rng.random(lead + (h, w)) * 255)
    I1x, I1y = (t(rng.standard_normal(lead + (h, w)) * 20) for _ in range(2))
    wrappers = (rk.refine_setup, rk.refine_update, rk.refine_nosweep)
    for w_ in wrappers:
        w_.launches = 0
    ins = rk.refine_setup(planes, flow, img1, I1x, I1y, 0)
    want = tvar.refine_setup_plain(planes, flow, img1, I1x, I1y, 0)
    assert all(torch.equal(g, v) for g, v in zip(ins, want))
    assert not bool((want[8] == 1).all())            # some taps fell outside
    du, dv = ins[11] + 0.01, ins[12] - 0.02
    for omega in (1.6, 1.0):
        for compose in (False, True):
            args = (*ins[:11], du, dv, 40.0, 5.0, 10.0, 2, omega, compose)
            got, want = rk.refine_update(*args), tvar.refine_update_plain(*args)
            if not compose:
                got, want = torch.stack(got), torch.stack(want)
            assert torch.equal(got, want), (omega, compose)
    got = rk.refine_nosweep(*ins[9:11], du, dv)
    assert torch.equal(got, tvar.refine_nosweep_plain(*ins[9:11], du, dv))
    torch.cuda.synchronize()
    plan = rk.update_plan(batch or 1, h, w, 2, sms=rk._multiprocessors(flow.device))
    assert [w_.launches for w_ in wrappers] == [1, 4 * len(plan), 1]


@pytest.mark.parametrize("shape", [(1, 9), (2, 2), (7, 1), (9, 13), (37, 53)])
@pytest.mark.parametrize("batch", [None, 8])
def test_refine_kernels_bitwise(shape, batch):
    _check_refine_kernels(batch, *shape, seed=sum(shape))


def test_refine_kernels_bitwise_1080p():
    _check_refine_kernels(None, 1080, 1920, seed=7)


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
    assert kernel_ops(program) == {"K3": 2, "K2": 0, "K2c": 0, "K1": 4, "S1": 4, "S3": 4,
                                   "S4": 4, "F1": 1}
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
    """At the 4K bucket every scale, the finest included, searches in K1's
    plane mode: the program holds four ``iclk_search_plane`` nodes and no
    extraction (no K2, no K2c)."""
    from dis_tpu_torch.cost import kernel_ops
    from dis_tpu_torch.serving import export_flow, load_exported

    cfg = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                  finest_scale=0, patch_overlap=0.3, mode="compat",
                                  early_exit=False)
    _, program = load_exported(export_flow(cfg, 2160, 3840))
    assert kernel_ops(program) == {"K3": 2, "K2": 0, "K2c": 0, "K1": 4, "S1": 4, "S4": 4}
    names = [getattr(n.target, "name", lambda: "")() for n in program.graph.nodes]
    assert names.count("dis_tpu_torch::iclk_search_plane") == 4


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


# -- S1, S3, S4: each scale's glue ------------------------------------------------------

def _scale_level(h, w, ps, batch, seed):
    """The finest level (padding ps) of a smooth image, or of a batch of
    shifted copies."""
    a, _ = _smooth(h, w, seed)
    x = torch.from_numpy(np.ascontiguousarray(a)).cuda()
    if batch:
        x = torch.stack([x.roll(3 * i, 1) for i in range(batch)])
    return construct_pyramid(x, 1, ps)[0]


def _count(wrapper, fn, *args):
    before = wrapper.launches
    out = fn(*args)
    return out, wrapper.launches - before


def _check_scale_kernels(h, w, ps, steps, batch, iy_range, window, row0, seed,
                         cut_last=False):
    """S1, S3 and S4 bitwise equal to their plain versions on one plan (S1
    without the start, and with it at the coarsest scale and from a window
    of the coarser flow with its row offset); with ``cut_last`` the planes
    end at the grid's last tap row."""
    from dis_tpu_torch.ops.densify import densify_plain, fixed_weights_plain
    from dis_tpu_torch.ops.grid import scale_plan
    from dis_tpu_torch.ops.iclk import search_start_plain, template_origin, templates_plain

    rng = np.random.default_rng(seed)
    lv = _scale_level(h, w, ps, batch, seed)
    plan = scale_plan(w, h, steps, ps, torch.device("cuda"), iy_range, window)
    g = plan.geom
    n = g.num_w * g.num_h
    lead = (batch,) if batch else ()
    end = None
    if cut_last and n:
        end = row0 + template_origin(g, ps, ps, row0)[0] + (g.num_h - 1) * g.steps + ps
    planes = [p[..., row0:end, :].contiguous() for p in (lv.img, lv.dx, lv.dy)]
    cols = plan.nn_cols.max().item() + 2 if n else 2
    row_off = plan.nn_rows.min().item() if n else 0
    rows = (plan.nn_rows.max().item() + 2 - row_off) if n else 2
    coarse = torch.from_numpy((rng.random(lead + (rows, cols, 2)) - 0.5).astype(np.float32)
                              * 4 * ps).cuda()
    picks = (plan.nn_rows, plan.nn_cols)
    starts = ((None, None, None, 0, None), (None, *picks, 0, plan.centers),
              (coarse, *picks, row_off, plan.centers))
    for residual in (False, True):
        for flow, nn_rows, nn_cols, off, centers in starts:
            args = (*planes, g.num_w, g.num_h, g.steps, *template_origin(g, ps, ps, row0), ps,
                    residual, flow, nn_rows, nn_cols, off, centers, w, h)
            (tpl, tn, start), launched = _count(sk.scale_templates, sk.scale_templates, *args)
            assert launched == (1 if n else 0)
            assert (start is None) == (centers is None)
            if start is not None:
                want_start = search_start_plain(flow, nn_rows, nn_cols, off, centers, ps, w, h,
                                                batch or 0)
                for x, y in zip(start, want_start):
                    assert torch.equal(x, y)
                conv0 = start.conv0
            if not n:      # the plain version's window cuts need a patch row
                assert tpl.T.shape == lead + (0, ps * ps) and tpl.Hinv.shape == lead + (0, 2, 2)
                want_tn = tpl.T
                continue
            want, want_tn = templates_plain(*args[:10])
            for x, y in zip(tpl, want):
                assert torch.equal(x, y)
            assert (tn is None) == (not residual) and (tn is None or torch.equal(tn, want_tn))
    if n:
        assert bool(conv0.any()) and not bool(conv0.all())
    # S3: Q near the normalized template for half the patches (r2 < 1 there).
    T = tpl.T
    Q = torch.where(torch.from_numpy(rng.random(lead + (n, 1)) < 0.5).cuda(),
                    want_tn + torch.from_numpy(((rng.random(T.shape) - 0.5) * 0.05)
                                               .astype(np.float32)).cuda(),
                    torch.from_numpy((rng.random(T.shape) * 255).astype(np.float32)).cuda())
    for normalize in (False, True):
        args = (Q, T, conv0, ps, normalize)
        got, launched = _count(sk.fixed_weights, sk.fixed_weights, *args)
        assert launched == (1 if n else 0)
        assert torch.equal(got, fixed_weights_plain(*args))
    # S4: uniform and weighted (some weights 0), full plan or window.
    u = torch.from_numpy(((rng.random(lead + (n, 2)) - 0.5) * 20).astype(np.float32)).cuda()
    wts = torch.from_numpy((rng.random(lead + (n,)) * (rng.random(lead + (n,)) > 0.2))
                           .astype(np.float32)).cuda()
    for weights in (None, wts):
        args = (u, weights, plan.cover_rows, plan.cover_cols, plan.uniform_wsum, g.num_w,
                g.num_h)
        got, launched = _count(sk.densify, sk.densify, *args)
        assert launched == (1 if got.numel() else 0)
        assert torch.equal(got, densify_plain(*args))
    torch.cuda.synchronize()


def test_start_reads_no_flow_without_the_coarser_flag(monkeypatch):
    """S1 takes the start's modes as flags, never as a null pointer: with
    the coarser-flow flag off and a non-null pointer to a NaN-filled
    scratch flow in the flow's place, init_u is all zeros and the start is
    bitwise the coarsest scale's plain one."""
    from dis_tpu_torch import _build
    from dis_tpu_torch.ops.grid import scale_plan
    from dis_tpu_torch.ops.iclk import search_start_plain, template_origin

    ps, steps, h, w = 8, 5, 72, 104
    lv = _scale_level(h, w, ps, 2, 9)
    plan = scale_plan(w, h, steps, ps, torch.device("cuda"))
    g = plan.geom
    scratch = torch.full((2, h // 2, w // 2, 2), float("nan"), device="cuda")
    launch = _build.launch
    seen = []

    def with_scratch(name, device, *args):
        # args[23:26]: the start flag, the coarser flag, the flow pointer
        assert name == "dis_scale_templates" and args[23:26] == (1, 0, None)
        seen.append(name)
        return launch(name, device, *args[:25], scratch.data_ptr(), *args[26:])

    monkeypatch.setattr(sk._build, "launch", with_scratch)
    _, _, start = sk.scale_templates(lv.img, lv.dx, lv.dy, g.num_w, g.num_h, steps,
                                     *template_origin(g, ps, ps), ps, False, None,
                                     plan.nn_rows, plan.nn_cols, 0, plan.centers, w, h)
    torch.cuda.synchronize()
    assert seen == ["dis_scale_templates"]
    assert bool((start.init_u == 0).all())
    want = search_start_plain(None, plan.nn_rows, plan.nn_cols, 0, plan.centers, ps, w, h, 2)
    for x, y in zip(start, want):
        assert torch.equal(x, y)


def test_one_s1_a_scale_and_no_start_kernel():
    """On the main path each scale launches S1 once, which writes the
    start; no wrapper, op, entry point or library symbol of a separate
    start kernel remains, and a captured graph holds no S2."""
    from dis_tpu_torch import _build
    from dis_tpu_torch.serving import aot_compile

    assert not hasattr(sk, "search_start") and not hasattr(sk, "search_start_op")
    assert "dis_search_start" not in _build.SIGNATURES
    assert not hasattr(_build.library(), "dis_search_start")
    x, y = _batch(2, 96, 128, 17)
    for cfg in (dis_tpu_torch.DIS_FAST, dis_tpu_torch.DIS_MEDIUM):
        levels = cfg.coarsest_scale - cfg.finest_scale + 1
        for batch in (None, 2):
            a, b = (x[0], y[0]) if batch is None else (x, y)
            for wrapper in SCALE_WRAPPERS:
                wrapper.launches = 0
            dis_tpu_torch.dis_flow(a, b, cfg)
            torch.cuda.synchronize()
            assert sk.scale_templates.launches == levels
        compiled = aot_compile(cfg, 96, 128)
        assert compiled.graph_launches["S1"] == levels and "S2" not in compiled.graph_launches


@pytest.mark.parametrize("ps", [8, 10, 12, 16])
@pytest.mark.parametrize("batch", [None, 3])
def test_scale_kernels_bitwise(ps, batch):
    """S1, S3 and S4 against their plain versions on the full grid of a level, and
    on a row-ranged grid read from a stripe of the planes (``row0``) with
    a window plan of output rows."""
    steps = max(1, int(ps * 0.7)) if ps < 12 else 3
    _check_scale_kernels(72, 104, ps, steps, batch, None, None, 0, ps)
    _check_scale_kernels(72, 104, ps, steps, batch, (4, 9), (20, 41), 12, ps + 1)


# The edges of S1's and S4's tiles: (h, w, ps, steps, batch, iy_range, window,
# row0, cut_last).  Grid sides that no tile divides (every case), a tile cut
# by the planes' last row, ps 6 and 16, three pairs, a stripe's row0 with a
# window of output rows, DIS_FULL's ps 12 at stride 3 (5 x 5 covers), an
# empty grid with three pairs; and each tile that template_tiles picks
# (8 x 8 patches where the staged window fits, else fewer columns, then
# fewer rows) in every lane layout of lane_layout: 32 x 8 at ps 2 (K, G =
# 4, 1), 16 x 8 at ps 4 (8, 2), 8 x 4 at ps 16 stride 8 (8, 32), 8 x 2 at
# ps 8 stride 12, 8 x 1 at ps 16 stride 16, 4 x 1 at ps 16 stride 40, 2 x 1
# at ps 20 stride 64 (16, 32); and S4's covers 2 (ps 8 stride 12), 3, 4
# (ps 8 stride 3: the kernel's generic instance) and 5 grid rows wide.
TILE_EDGES = {
    "ps6": (58, 84, 6, 4, None, None, None, 0, False),
    "ps16_b3": (76, 134, 16, 8, 3, None, None, 0, False),
    "ps2_steps1": (38, 76, 2, 1, None, None, None, 0, True),
    "ps4_steps2_b2": (62, 172, 4, 2, 2, None, None, 0, False),
    "ps8_steps12": (62, 172, 8, 12, None, None, None, 0, True),
    "ps16_steps16_stripe": (150, 200, 16, 16, None, (2, 9), (30, 121), 18, True),
    "ps16_steps40_b2": (170, 300, 16, 40, 2, None, None, 0, False),
    "ps20_steps64": (300, 430, 20, 64, None, None, None, 0, True),
    "ps8_steps3_b2": (66, 130, 8, 3, 2, None, None, 0, False),
    "last_row_b3": (72, 150, 8, 5, 3, None, None, 0, True),
    "stripe_window": (90, 290, 8, 5, None, (5, 13), (31, 58), 20, True),
    "ps12_steps3": (70, 150, 12, 3, None, None, None, 0, False),
    "ps12_steps3_stripe_b3": (70, 150, 12, 3, 3, (6, 17), (25, 44), 14, True),
    "empty_b3": (72, 150, 12, 3, 3, (9, 9), (30, 47), 0, False),
}


@pytest.mark.parametrize("case", sorted(TILE_EDGES))
def test_scale_kernels_tile_edges(case):
    """S1, S3 and S4 bitwise equal to their plain versions where S1's and S4's
    tiles meet the edges of the grid, the planes and the output."""
    *args, cut_last = TILE_EDGES[case]
    _check_scale_kernels(*args, seed=len(case), cut_last=cut_last)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ps,steps", [(12, 3), (8, 5)])
def test_densify_any_covers(batch, ps, steps):
    """S4 bitwise equal to its plain version on cover tables no plan makes:
    each row's and column's covers in another order (the sums follow the
    table's order) and covers that reach past the staged sub-block (summed
    from device memory); uniform and weighted; 5 x 5 and 3 x 3 covers."""
    from dis_tpu_torch.ops.densify import densify_plain
    from dis_tpu_torch.ops.grid import scale_plan

    rng = np.random.default_rng(ps + (batch or 0))
    h, w = 53, 270
    plan = scale_plan(w, h, steps, ps, torch.device("cuda"))
    g = plan.geom
    n = g.num_w * g.num_h
    lead = (batch,) if batch else ()
    u = torch.from_numpy(((rng.random(lead + (n, 2)) - 0.5) * 20).astype(np.float32)).cuda()
    wts = torch.from_numpy((rng.random(lead + (n,)) * (rng.random(lead + (n,)) > 0.2))
                           .astype(np.float32)).cuda()
    shuffled = [torch.from_numpy(np.take_along_axis(
        t.cpu().numpy(), rng.permuted(np.tile(np.arange(t.shape[1]), (t.shape[0], 1)), axis=1),
        1)).cuda() for t in (plan.cover_rows, plan.cover_cols)]
    far = [torch.from_numpy(rng.integers(0, m + 1, t.shape)).cuda()
           for t, m in ((plan.cover_rows, g.num_h), (plan.cover_cols, g.num_w))]
    for cover_rows, cover_cols in (shuffled, far):
        for weights in (None, wts):
            args = (u, weights, cover_rows, cover_cols, plan.uniform_wsum, g.num_w, g.num_h)
            got, launched = _count(sk.densify, sk.densify, *args)
            assert launched == 1 and torch.equal(got, densify_plain(*args))
    torch.cuda.synchronize()


def test_scale_kernels_empty_grid():
    """An empty row range: S1-S3 launch nothing; S4 still fills its
    window (all zeros), bitwise the plain version."""
    _check_scale_kernels(72, 104, 8, 5, None, (5, 5), (30, 31), 0, 3)


def test_scale_kernels_bitwise_1080p():
    """At the 1080p finest shapes (ps 8 stride 5 and ps 12 stride 3)."""
    _check_scale_kernels(1080, 1920, 8, 5, None, None, None, 0, 7)
    _check_scale_kernels(1088, 1920, 12, 3, None, None, None, 0, 8)


def test_scale_wrappers_check_their_inputs():
    """A CUDA call with a wrong dtype, a strided tensor or a grid outside
    the planes raises before any launch."""
    lv = _scale_level(40, 56, 8, None, 1)
    with pytest.raises(ValueError, match="leaves"):
        sk.scale_templates(lv.img, lv.dx, lv.dy, 20, 20, 5, 0, 0, 8, False)
    with pytest.raises(ValueError, match="contiguous"):
        sk.scale_templates(lv.img.t(), lv.dx.t(), lv.dy.t(), 2, 2, 5, 0, 0, 8, False)
    u = torch.zeros(6, 2, device="cuda")
    rows = torch.zeros(4, 3, dtype=torch.int32, device="cuda")
    cols = torch.zeros(5, 3, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="int64"):
        sk.densify(u, None, rows, cols, torch.zeros(4, 5, 1, device="cuda"), 2, 3)


# -- R0, R1's setup mode, R23's compose mode, R3's no-sweep mode, F1-F3: the last glue -

GLUE_SHAPES = [(2, 2), (2, 7), (5, 2), (9, 13), (37, 53), (67, 131)]


def _planes_pair(batch, h, w, p, seed):
    """Two level planes [(B,) h + 2p, w + 2p] of 0..255 values on the card."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return tuple(torch.from_numpy((rng.random(lead + (h + 2 * p, w + 2 * p)) * 255)
                                  .astype(np.float32)).cuda() for _ in range(2))


@pytest.mark.parametrize("shape", GLUE_SHAPES)
@pytest.mark.parametrize("batch", [None, 1, 3])
@pytest.mark.parametrize("p", [0, 3])
def test_refine_planes_setup_compose_bitwise(shape, batch, p):
    """R0 on windows of the planes (p = 3, the Q1 levels' layout) and on
    whole planes (p = 0, the intensity planes), R1's setup mode on its
    planes and a random flow, and R23 in its compose mode (a sweep, omega
    1.0 and 1.6) on its inputs: each bitwise equal to its plain version,
    one launch each (R23's ``update_plan``), R23's compose launches counted
    in ``composed``."""
    from dis_tpu_torch.ops import variational as tvar
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    h, w = shape
    img1, img2 = _planes_pair(batch, h, w, p, sum(shape) + p)
    wrappers = (rk.refine_planes, rk.refine_setup, rk.refine_update, rk.composed)
    for w_ in wrappers:
        w_.launches = 0
    got, want = rk.refine_planes(img1, img2, p, h, w), tvar.refine_planes_plain(img1, img2,
                                                                                p, h, w)
    assert all(g.shape == v.shape and torch.equal(g, v) for g, v in zip(got, want))
    I1x, I1y, planes = got
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(7)
    flow = torch.from_numpy(((rng.random(lead + (h, w, 2)) - 0.5) * 9)
                            .astype(np.float32)).cuda()
    ins = rk.refine_setup(planes, flow, img1, I1x, I1y, p)
    want = tvar.refine_setup_plain(planes, flow, img1, I1x, I1y, p)
    assert len(ins) == 13 and all(torch.equal(g, v) for g, v in zip(ins, want))
    assert all(t.is_contiguous() for t in ins)
    update = (*ins[:11], ins[11] + 0.01, ins[12] - 0.02, 40.0, 5.0, 10.0, 1)
    for omega in (1.0, 1.6):
        got = rk.refine_update(*update, omega, True)
        want = tvar.refine_update_plain(*update, omega, True)
        assert got.shape == want.shape and torch.equal(got, want), omega
    torch.cuda.synchronize()
    n = len(rk.update_plan(batch or 1, h, w, 1, sms=rk._multiprocessors(img1.device)))
    assert [w_.launches for w_ in wrappers] == [1, 1, 2 * n, 2]


def _np_sobel3(x, axis):
    """``sobel3`` in NumPy on ``np.pad(mode="reflect")``, which repeats a
    plane of one row or column."""
    p = np.pad(x, 1, mode="reflect")
    if axis == "x":
        d = p[:, 2:] - p[:, :-2]
        out = d[:-2, :] + 2.0 * d[1:-1, :] + d[2:, :]
    else:
        d = p[2:, :] - p[:-2, :]
        out = d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]
    return out * np.float32(0.125)


@pytest.mark.parametrize("shape", [(1, 5), (5, 1), (1, 1), (1, 40), (40, 1)])
def test_refine_planes_refuses_what_its_plain_version_refuses(shape):
    """A window of one row or column (a coarse level of a small frame):
    R0 on the card and its plain version both give the Sobel chains of a
    NumPy reflect reference, bitwise, on padded windows (p = 3) and whole
    planes; R1's setup mode, R23 (with and without its compose mode) and
    R3's no-sweep mode on such a level equal their plain versions bitwise
    (their neighbour reads clamp to the one row or column)."""
    from dis_tpu_torch.ops import variational as tvar
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    h, w = shape
    for p in (0, 3):
        a, b = _planes_pair(None, h, w, p, 3)
        i1, i2 = (t.cpu().numpy()[p:p + h, p:p + w] for t in (a, b))
        i2x, i2y = _np_sobel3(i2, "x"), _np_sobel3(i2, "y")
        want = (_np_sobel3(i1, "x"), _np_sobel3(i1, "y"),
                np.stack([i2, i2x, i2y, _np_sobel3(i2x, "x"), _np_sobel3(i2x, "y"),
                          _np_sobel3(i2y, "y")], axis=-1))
        got = rk.refine_planes(a, b, p, h, w)
        plain = tvar.refine_planes_plain(a, b, p, h, w)
        for g, q, v in zip(got, plain, want):
            np.testing.assert_array_equal(g.cpu().numpy(), v)
            np.testing.assert_array_equal(q.cpu().numpy(), v)
        I1x, I1y, planes = got
        flow = torch.from_numpy(((np.random.default_rng(5).random((h, w, 2)) - 0.5) * 3)
                                .astype(np.float32)).cuda()
        ins = rk.refine_setup(planes, flow, a, I1x, I1y, p)
        want_ins = tvar.refine_setup_plain(planes, flow, a, I1x, I1y, p)
        assert all(torch.equal(g, v) for g, v in zip(ins, want_ins))
        du, dv = ins[11] + 0.01, ins[12] - 0.02
        update = (*ins[:11], du, dv, 40.0, 5.0, 10.0, 2, 1.6)
        assert all(torch.equal(g, v) for g, v in zip(rk.refine_update(*update),
                                                      tvar.refine_update_plain(*update)))
        assert torch.equal(rk.refine_update(*update, True),
                           tvar.refine_update_plain(*update, True))
        assert torch.equal(rk.refine_nosweep(*ins[9:11], du, dv),
                           tvar.refine_nosweep_plain(*ins[9:11], du, dv))


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
@pytest.mark.parametrize("planes", ["q1", "intensity"])
@pytest.mark.parametrize("omega", [1.0, 1.6])
@pytest.mark.parametrize("batch", [None, 1, 3])
def test_refinement_glue_card_equals_cpu(scheme, planes, omega, batch):
    """The refinement on the card (R0 once, R1 in its setup mode, R23 once
    a weight update, the last in its compose mode) equals the same call
    on the CPU bitwise, on Q1-style padded planes (pad 8) and on
    intensity planes (pad 0), odd sizes; the warp1 scheme launches R1 in
    its warp1 mode and no R0."""
    from dis_tpu_torch.ops.cuda import refine_kernel as rk
    from dis_tpu_torch.ops.variational import variational_refinement

    h, w, pad = 37, 53, (8 if planes == "q1" else 0)
    x, y = _planes_pair(batch, h, w, pad, 5)
    lead = () if batch is None else (batch,)
    flow = torch.from_numpy(((np.random.default_rng(3).random(lead + (h, w, 2)) - 0.5) * 4)
                            .astype(np.float32)).cuda()
    cfg = dis_tpu_torch.DISConfig(mode="fixed", refinement_iters=2, refinement_inner_sweeps=3,
                                  refinement_sor_sweeps=2, refinement_omega=omega,
                                  refinement_alpha=40.0, refinement_scheme=scheme,
                                  refinement_planes=planes)
    wrappers = (rk.refine_planes, rk.refine_setup, rk.refine_setup_warp1, rk.refine_update,
                rk.composed)
    for w_ in wrappers:
        w_.launches = 0
    card = variational_refinement(x, y, flow, cfg, pad=pad)
    six = scheme == "planes6"
    assert [w_.launches for w_ in wrappers] == [int(six), 2 * six, 2 * (1 - six), 6, 2]
    cpu = variational_refinement(x.cpu(), y.cpu(), flow.cpu(), cfg, pad=pad)
    torch.cuda.synchronize()
    assert card.shape == flow.shape and torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("shape", GLUE_SHAPES + [(1, 5), (5, 1), (1, 1), (1, 40), (40, 1)])
@pytest.mark.parametrize("batch", [None, 1, 3])
@pytest.mark.parametrize("p", [0, 3])
def test_refine_warp1_clip_nosweep_bitwise(shape, batch, p):
    """R1's warp1 mode (R1w) on windows of two level planes and a flow that
    reaches past every edge, R23's compose mode with its clip (a sweep,
    omega 1.0 and 1.6, a bound that binds) on its inputs, and R3's
    no-sweep mode with and without the clip on planes holding a NaN, -0.0
    and values far past the bound: each bitwise equal to its plain version
    (bit patterns, so NaNs and signed zeros count), the clip's launches
    counted in ``clamped``."""
    from dis_tpu_torch.ops import variational as tvar
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    h, w = shape
    img1, img2 = _planes_pair(batch, h, w, p, sum(shape) + 2 * p)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(17)
    flow = torch.from_numpy(((rng.random(lead + (h, w, 2)) - 0.5) * 9)
                            .astype(np.float32)).cuda()
    wrappers = (rk.refine_setup_warp1, rk.refine_update, rk.refine_nosweep, rk.clamped)
    for w_ in wrappers:
        w_.launches = 0
    bits = lambda t: t.contiguous().view(torch.int32)
    ins = rk.refine_setup_warp1(img2, flow, img1, p)
    want = tvar.refine_setup_warp1_plain(img2, flow, img1, p)
    assert len(ins) == 13 and all(torch.equal(bits(g), bits(v)) for g, v in zip(ins, want))
    assert all(t.is_contiguous() for t in ins)
    u0, v0 = ins[9].clone(), ins[10].clone()
    du, dv = ins[11] + 0.01, ins[12] - 0.02
    for omega in (1.0, 1.6):
        update = (*ins[:9], u0, v0, du, dv, 40.0, 5.0, 10.0, 1, omega, True, 0.75)
        got, ref = rk.refine_update(*update), tvar.refine_update_plain(*update)
        assert got.shape == ref.shape and torch.equal(bits(got), bits(ref)), omega
        assert bool((ref.abs() == 0.75).any())           # the bound binds
    for k, t in enumerate((u0, v0, du, dv)):
        flat = t.view(-1)
        flat[k % flat.numel()] = float("nan") if k == 0 else -0.0
        flat[-1] = 1e4 * (-1) ** k
    for bound in (None, 0.75):
        got = rk.refine_nosweep(u0, v0, du, dv, bound)
        ref = tvar.refine_nosweep_plain(u0, v0, du, dv, bound)
        assert got.shape == ref.shape and torch.equal(bits(got), bits(ref)), bound
    torch.cuda.synchronize()
    n = len(rk.update_plan(batch or 1, h, w, 1, sms=rk._multiprocessors(u0.device)))
    assert [w_.launches for w_ in wrappers] == [1, 2 * n, 2, 3]


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
@pytest.mark.parametrize("batch", [None, 3])
def test_clamped_and_nosweep_levels_card_equal_cpu(scheme, batch):
    """``refine_level`` with ``refined_init_clamp`` at the coarsest scale
    (its clip binds) and a level without a weight update, on the card,
    equal the same calls on the CPU bitwise, with R23's clip (in its
    compose mode) and R3's no-sweep launch counted."""
    import dataclasses
    from types import SimpleNamespace

    from dis_tpu_torch.models.dis import motion_bound, refine_level
    from dis_tpu_torch.ops.cuda import refine_kernel as rk
    from dis_tpu_torch.ops.variational import variational_refinement

    h, w, pad = 37, 53, 8
    x, y = _planes_pair(batch, h, w, pad, 9)
    lead = () if batch is None else (batch,)
    flow = torch.from_numpy((np.random.default_rng(4).standard_normal(lead + (h, w, 2)) * 8)
                            .astype(np.float32)).cuda()
    cfg = dataclasses.replace(dis_tpu_torch.DIS_MEDIUM, refinement_scheme=scheme,
                              refined_init_clamp=True)
    s = cfg.coarsest_scale
    levels = [SimpleNamespace(img=t) for t in (x, y)]
    for w_ in (rk.composed, rk.refine_nosweep, rk.clamped):
        w_.launches = 0
    card = refine_level(*levels, flow, cfg, s)
    cpu = refine_level(*(SimpleNamespace(img=t.cpu()) for t in (x, y)), flow.cpu(), cfg, s)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), cpu) and float(cpu.abs().max()) == motion_bound(cfg, s)
    nosweep = dataclasses.replace(cfg, refinement_inner_sweeps=0, refined_init_clamp=False)
    card = variational_refinement(x, y, flow, nosweep)
    torch.cuda.synchronize()
    assert torch.equal(card, flow)
    assert [w_.launches for w_ in (rk.composed, rk.refine_nosweep, rk.clamped)] == \
        [1, 1, 1]


@pytest.mark.parametrize("shape", GLUE_SHAPES + [(1, 5), (5, 1), (1, 40), (40, 1), (34, 60),
                                                 (136, 240), (544, 960)])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("sweeps,omega", [(1, 1.0), (5, 1.6)])
@pytest.mark.parametrize("capacity", [None, 400])
def test_refine_update_bitwise(shape, batch, sweeps, omega, capacity, monkeypatch):
    """R23, a weight update and its half-sweeps on tiles in shared memory,
    bitwise equal to its plain version run on the card's tensors, with and
    without its compose mode and the clip, one launch an update; with
    tiles of 400 pixels (capacity) the update's half-sweeps split over
    launches, each of some of them."""
    from dis_tpu_torch.ops import variational as tvar
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    if capacity is not None:
        monkeypatch.setattr(rk, "update_plan", lambda *a, sms=None: tvar.update_plan(
            *a, capacity=capacity, sms=sms))
    h, w = shape
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(h * w + sweeps)
    f = lambda s: torch.from_numpy((rng.standard_normal(lead + shape) * s)
                                   .astype(np.float32)).cuda()
    ins = [f(20), f(5), f(5), f(8), f(8), f(3), f(3), f(3),
           torch.from_numpy((rng.random(lead + shape) > 0.2).astype(np.float32)).cuda(),
           f(2), f(2), f(0.05), f(0.05)]
    bits = lambda t: t.contiguous().view(torch.int32)
    plan = rk.update_plan(batch or 1, h, w, sweeps, sms=rk._multiprocessors(ins[0].device))
    for compose, bound in ((False, None), (True, None), (True, 0.5)):
        before = rk.refine_update.launches
        got = rk.refine_update(*ins, 40.0, 5.0, 10.0, sweeps, omega, compose, bound)
        want = tvar.refine_update_plain(*ins, 40.0, 5.0, 10.0, sweeps, omega, compose, bound)
        if not compose:
            got, want = torch.stack(got), torch.stack(want)
        torch.cuda.synchronize()
        assert rk.refine_update.launches == before + len(plan)
        assert want.device == got.device and got.shape == want.shape
        assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (5, 7), (37, 53), (375, 1242)])
@pytest.mark.parametrize("batch", [None, 1, 3])
@pytest.mark.parametrize("coarsest", [1, 3, 4])
def test_frame_pad_bitwise(shape, batch, coarsest):
    """F1 pads both images in one launch, bitwise ``pad_divisible``; a
    frame that needs no padding launches nothing and is returned as it is;
    a strided view pads as its copy does."""
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda import frame_kernel as fk

    a, b = _planes_pair(batch, *shape, 0, sum(shape))
    fk.frame_pad.launches = 0
    p1, p2, pads = fk.frame_pad(a, b, coarsest)
    w1, w2, wpads = im.frame_pad_plain(a, b, coarsest)
    assert pads == wpads and torch.equal(p1, w1) and torch.equal(p2, w2)
    f = 2 ** coarsest
    padded = shape[0] % f or shape[1] % f
    assert fk.frame_pad.launches == int(bool(padded))
    if not padded:
        assert p1 is a and p2 is b
    strided = a.transpose(-1, -2)
    s1, s2, _ = fk.frame_pad(strided, b.transpose(-1, -2), coarsest)
    c1, c2, _ = im.frame_pad_plain(strided.contiguous(), b.transpose(-1, -2).contiguous(),
                                   coarsest)
    assert torch.equal(s1, c1) and torch.equal(s2, c2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("coarsest", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("batch", [None, 1, 3])
def test_intensity_levels_bitwise(coarsest, batch):
    """F2 builds levels 1..coarsest of both images in one launch (two past
    five levels), each bitwise ``intensity_pyramid``; level 0 is the image
    itself."""
    from dis_tpu_torch.ops.cuda import frame_kernel as fk
    from dis_tpu_torch.ops.pyramid import intensity_pyramid

    f = 2 ** coarsest
    h, w = f * 3, f * 5 if coarsest < 7 else f
    a, b = _planes_pair(batch, h, w, 0, coarsest)
    fk.intensity_levels.launches = 0
    got1, got2 = fk.intensity_levels(a, b, coarsest)
    assert fk.intensity_levels.launches == -(-coarsest // fk.MAX_LEVELS)
    assert got1[0] is a and got2[0] is b
    for got, img in ((got1, a), (got2, b)):
        want = intensity_pyramid(img, coarsest)
        assert len(got) == len(want) == coarsest + 1
        assert all(g.shape == v.shape and torch.equal(g, v) for g, v in zip(got, want))
    with pytest.raises(ValueError, match="divisible"):
        fk.intensity_levels(a[..., :-1], b[..., :-1], coarsest)
    torch.cuda.synchronize()


@pytest.mark.parametrize("finest", [1, 2, 3])
@pytest.mark.parametrize("frame", [(375, 1242), (37, 53), (64, 96), (2, 2), (9, 64)])
@pytest.mark.parametrize("batch", [None, 1, 3])
def test_frame_finish_bitwise(finest, frame, batch):
    """F3 writes the cropped, upsampled, scaled flow in one launch, bitwise
    the scale, ``resize_bilinear`` and ``crop_padding``; at finest scale 0
    it launches nothing and returns the crop, a view."""
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda import frame_kernel as fk

    coarsest = 3
    f = 2 ** coarsest
    hh, ww = frame
    ph, pw = -(-hh // f) * f, -(-ww // f) * f
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(hh + finest)
    flow = torch.from_numpy(((rng.random(lead + (ph >> finest, pw >> finest, 2)) - 0.5) * 20)
                            .astype(np.float32)).cuda()
    fk.frame_finish.launches = 0
    got = fk.frame_finish(flow, finest, pw - ww, ph - hh, ww, hh)
    want = im.frame_finish_plain(flow, finest, pw - ww, ph - hh, ww, hh)
    assert got.shape == want.shape == lead + (hh, ww, 2) and torch.equal(got, want)
    assert fk.frame_finish.launches == 1
    same = fk.frame_finish(flow, 0, 0, 0, pw >> finest, ph >> finest)
    assert fk.frame_finish.launches == 1 and same.data_ptr() == flow.data_ptr()
    torch.cuda.synchronize()


@pytest.mark.parametrize("preset, frame, want", [
    ("DIS_ULTRAFAST", (75, 118), {"F1": 1, "F3": 1}),
    ("DIS_MEDIUM", (96, 128), {"F2": 1, "R0": 4}),
    ("DIS_MEDIUM", (75, 118), {"F1": 1, "F2": 1, "R0": 4}),
    ("DIS_FULL", (75, 118), {"F1": 1, "F2": 1, "R0": 5}),
    ("DIS_FAST", (96, 128), {}),
])
def test_frame_and_level_launches(preset, frame, want):
    """Per dis_flow call: R0 once a refined level, F2 once a frame where the
    refinement reads intensity planes, F1 only where the frame pads, F3
    only where finest_scale > 0; the flow equals the kernel pipeline
    between the plain padding and the plain upsample and crop, bitwise."""
    from dis_tpu_torch.ops import image as im
    from dis_tpu_torch.ops.cuda import frame_kernel as fk
    from dis_tpu_torch.ops.cuda import refine_kernel as rk

    cfg = getattr(dis_tpu_torch, preset)
    x, y = (torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in _smooth(*frame, 9))
    counted = {"R0": rk.refine_planes, "F1": fk.frame_pad, "F2": fk.intensity_levels,
               "F3": fk.frame_finish}
    for w_ in counted.values():
        w_.launches = 0
    flow = dis_tpu_torch.dis_flow(x, y, cfg)
    torch.cuda.synchronize()
    assert {k: w_.launches for k, w_ in counted.items() if w_.launches} == want
    assert flow.shape == frame + (2,) and bool(torch.isfinite(flow).all())
    p1, p2, (padw, padh) = im.frame_pad_plain(x, y, cfg.coarsest_scale)
    plain = im.frame_finish_plain(dis_tpu_torch.dis_flow_padded(p1, p2, cfg),
                                  cfg.finest_scale, padw, padh, frame[1], frame[0])
    assert torch.equal(flow, plain)
