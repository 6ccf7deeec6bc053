"""Each scale's glue as three kernels (S1, S3, S4) on the CPU.

``models/dis.py::_scale`` composes a scale from the plain versions of S1
(``ops/iclk.py::scale_templates_plain``: ``templates_plain``, the
templates, inverse Hessians and fixed mode's ``Tn``, then
``search_start_plain``, the NN init and the start test, once a kernel of
its own, S2), S3 (``ops/densify.py::fixed_weights_plain``) and S4
(``densify_plain``), which CPU tensors run inline and which the ops
``dis_tpu_torch::scale_templates``, ``::fixed_weights`` and
``::densify`` (``ops/cuda/scale_kernel.py``) run as their CPU functions.
On numpy-seeded inputs at ps 8, 10, 12 and 16, with and without a pair
axis, on full and row-ranged grids:

- each plain version, inline and through its op (``ops_on_cpu``), is
  bitwise the parent's composition it replaced (verbatim copies below,
  ``_parent_*``); S1 with the start is ``templates_plain`` then
  ``search_start_plain``, at the coarsest scale, with a window of the
  coarser flow and its row offset, and without the start;
- S1's templates and its start are bitwise ``dis_tpu``'s functions (the
  templates from the JAX extraction, the inverse from
  ``_templates_from_taps`` op by op; the NN init from
  ``init_from_coarser_flow`` and the start test of
  ``dis_tpu/ops/iclk.py::inverse_search`` evaluated as written there);
- S3 is bitwise ``dis_tpu/models/dis.py::_fixed_weights`` run eagerly:
  both sum with the same forced pair tree and both divide the template's
  sum by ps^2 as a true division (the repair of a CUDA division by a
  Python scalar, which rounds as a multiplication by the reciprocal);
- S4 is within atol 1e-5 of ``dis_tpu``'s ``densify`` (the tolerance of
  ``tests/test_torch_densify.py``: XLA may fuse the JAX stencil's adds
  differently);
- the three ops pass ``torch.library.opcheck`` and have flat schemas (S2's
  op is gone); the
  wrappers refuse tensors neither on the CPU nor on a CUDA device; a CPU
  export within ``ops_on_cpu`` records one op node per launch and its
  cost analysis counts each by the package's formulas.

The kernels themselves run on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 1f).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.models import dis as jdis
from dis_tpu.ops import densify as jden
from dis_tpu.ops import grid as jgrid
from dis_tpu.ops import iclk as jiclk
from dis_tpu.ops.pyramid import construct_pyramid as jpyramid
from dis_tpu_torch import cost
from dis_tpu_torch.ops import cuda as kops
from dis_tpu_torch.ops import densify as tden
from dis_tpu_torch.ops import grid as tgrid
from dis_tpu_torch.ops import iclk as ticlk
from dis_tpu_torch.ops.cuda import scale_kernel as sk

from conftest import synthetic_pair

PS_STEPS = [(8, 5), (10, 5), (12, 3), (16, 8)]
CPU = torch.device("cpu")


# -- the stages as they were before the split: verbatim copies ------------------------
# (dis_tpu_torch/ops/iclk.py, ops/grid.py, ops/densify.py and models/dis.py
# before S1-S4; only the functions' names differ.)

def _parent_extract_templates_grid(img, dx, dy, geom, ps, pad, row0=0):
    s = geom.steps
    half = ps // 2
    nw, nh = geom.num_w, geom.num_h
    n = nw * nh
    y0 = geom.iy0 * s + geom.offset_h - half + pad - row0
    x0 = geom.offset_w - half + pad

    def taps(plane):
        win = plane[..., y0:y0 + (nh - 1) * s + ps, x0:x0 + (nw - 1) * s + ps]
        t = win.unfold(-2, ps, s).unfold(-2, ps, s)  # [..., nh, nw, ps(j), ps(i)]
        return t.transpose(-4, -3).reshape(*plane.shape[:-2], n, ps * ps)

    T, Tdx, Tdy = taps(img), taps(dx), taps(dy)
    a = ticlk.pairwise_sum(Tdx * Tdx)
    b = ticlk.pairwise_sum(Tdx * Tdy)
    c = ticlk.pairwise_sum(Tdy * Tdy)
    return _parent_templates_from_hessian(T, Tdx, Tdy, a, b, c)


def _parent_templates_from_hessian(T, Tdx, Tdy, a, b, c):
    det = a * c - b * b
    guard = torch.where(det == 0, torch.full_like(det, 1e-10),
                        torch.zeros_like(det))
    a = a + guard
    c = c + guard
    det = a * c - b * b
    inv_det = 1.0 / det
    Hinv = torch.stack(
        [torch.stack([c * inv_det, -b * inv_det], -1),
         torch.stack([-b * inv_det, a * inv_det], -1)], -2)
    return ticlk.PatchTemplates(T=T, Tdx=Tdx, Tdy=Tdy, Hinv=Hinv)


def _parent_residual_template(tpl, cfg):
    if not cfg.patch_normalization:
        return tpl.T
    return tpl.T - ticlk.pairwise_sum(tpl.T)[..., None] * ticlk.inv_taps(cfg.patch_size)


def _parent_init_from_coarser_flow(plan, flow_coarse, coarse_row_offset=0):
    rows_idx = plan.nn_rows if coarse_row_offset == 0 else plan.nn_rows - coarse_row_offset
    rows = flow_coarse.index_select(-3, rows_idx)
    sub = rows.index_select(-2, plan.nn_cols)              # [..., nh, nw, 2]
    n = plan.geom.num_w * plan.geom.num_h
    return sub.transpose(-3, -2).reshape(*sub.shape[:-3], n, 2) * 2.0


def _parent_start(plan, tpl, flow_coarse, coarse_row_offset, ps, width, height):
    """The parent's ``_scale`` and ``inverse_search`` lines from the init
    to the start test."""
    if flow_coarse is None:
        init_u = plan.centers.new_zeros(tpl.T.shape[:-1] + (2,))
    else:
        init_u = _parent_init_from_coarser_flow(plan, flow_coarse, coarse_row_offset)
    pos0 = plan.centers + init_u
    conv0 = ticlk.out_of_bounds(pos0, ps, width, height)
    return init_u, pos0, conv0


def _parent_fixed_weights(res, tpl, cfg):
    ps2 = cfg.num_points_patch
    Tn = tpl.T
    if cfg.patch_normalization:
        Tn = Tn - ticlk.pairwise_sum(Tn)[..., None] / ps2
    r2 = ticlk.pairwise_sum((res.Q - Tn) ** 2)
    return torch.where(res.start_oob, torch.ones_like(r2),
                       1.0 / torch.clamp(r2, min=1.0))


def _parent_stencil(x, plan):
    xz = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))      # zero grid row
    acc = None
    for k in range(plan.cover_rows.shape[1]):
        t = xz.index_select(-3, plan.cover_rows[:, k])
        acc = t if acc is None else acc + t                  # [..., H, nw, c]
    az = torch.nn.functional.pad(acc, (0, 0, 0, 1))          # zero grid col
    out = None
    for k in range(plan.cover_cols.shape[1]):
        t = az.index_select(-2, plan.cover_cols[:, k])
        out = t if out is None else out + t                  # [..., H, W, c]
    return out


def _parent_densify(u, plan, weights=None):
    geom = plan.geom
    lead = u.shape[:-2]
    ug = u.reshape(*lead, geom.num_w, geom.num_h, 2).transpose(-3, -2)
    if weights is None:
        vg = ug
        wsum = plan.uniform_wsum
    else:
        wg = weights.reshape(*lead, geom.num_w, geom.num_h).transpose(-2, -1)[..., None]
        vg = ug * wg
        wsum = _parent_stencil(wg, plan)
    fsum = _parent_stencil(vg, plan)
    pos = wsum > 0
    return torch.where(pos, fsum / torch.where(pos, wsum, torch.ones_like(wsum)),
                       torch.zeros_like(fsum))


# -- inputs ----------------------------------------------------------------------------

class _Res(NamedTuple):
    Q: torch.Tensor
    start_oob: torch.Tensor


def _level(h, w, ps, seed, batch):
    """The JAX level 0 (padding ps) of ``batch`` (None: one) smooth images
    and the port's copies of its planes, a pair axis leading where batched."""
    imgs = [synthetic_pair(h, w, seed=seed + i)[0] for i in range(batch or 1)]
    jls = [jpyramid(jnp.asarray(i), 0, ps)[0] for i in imgs]
    planes = [torch.from_numpy(np.stack([np.asarray(getattr(l, k)) for l in jls]))
              for k in ("img", "dx", "dy")]
    if batch is None:
        planes = [p[0] for p in planes]
    return jls, planes


def _plan(w, h, steps, ps, ranged):
    """The full plan, or a row-ranged grid with a window of output rows."""
    if not ranged:
        return tgrid.scale_plan(w, h, steps, ps, CPU)
    g = tgrid.make_grid(w, h, steps)
    iy = (g.num_h // 4, g.num_h // 4 + max(2, g.num_h // 3))
    cy0 = iy[0] * steps + g.offset_h
    return tgrid.scale_plan(w, h, steps, ps, CPU, iy, (cy0, cy0 + 2 * steps + 1))


def _cfg(ps, steps, mode="fixed", normalize=True):
    return dis_tpu_torch.DISConfig(patch_size=ps, patch_overlap=1.0 - steps / ps, mode=mode,
                                   patch_normalization=normalize)


def _both_routes(fn, *args):
    """``fn(*args)`` inline and through its op (``ops_on_cpu``)."""
    inline = fn(*args)
    with kops.ops_on_cpu():
        routed = fn(*args)
    return inline, routed


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))


# -- S1 ----------------------------------------------------------------------------------

@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
def test_templates_plain_is_the_parent_composition(ps, steps, batch, ranged):
    """S1's plain version (and its op) gives the parent's templates,
    inverse and residual template bitwise, with the planes cut to a stripe
    (``row0``) for a row-ranged grid."""
    h, w = 48, 72
    _, planes = _level(h, w, ps, ps, batch)
    plan = _plan(w, h, steps, ps, ranged)
    g = plan.geom
    row0 = 2 if ranged else 0
    cut = [p[..., row0:, :].contiguous() for p in planes]
    want = _parent_extract_templates_grid(*cut, g, ps, ps, row0)
    for normalize in (False, True):
        cfg = _cfg(ps, steps, normalize=normalize)
        want_tn = _parent_residual_template(want, cfg)
        for tpl, tn, start in _both_routes(ticlk.scale_templates, *cut, g, ps, ps, row0,
                                           normalize):
            assert _equal(tuple(tpl), tuple(want))
            assert _equal(tn, want_tn if normalize else None)
            assert start is None
        for plain in (False, True):
            assert _equal(tuple(ticlk.extract_templates_grid(*cut, g, ps, ps, row0,
                                                             plain=plain)), tuple(want))


@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("batch", [None, 2])
def test_templates_plain_bitwise_vs_jax(ps, steps, batch):
    """S1's plain version against ``dis_tpu``: taps from the JAX
    extraction (jit: pure copies), the inverse from
    ``_templates_from_taps`` and fixed mode's ``Tn`` as
    ``inverse_search`` writes it, both op by op, bitwise; each pair of a
    batch gets its own bits."""
    h, w = 40, 64
    jls, planes = _level(h, w, ps, 3 * ps, batch)
    jg = jgrid.make_grid(w, h, steps)
    got, tn, _ = ticlk.scale_templates(*planes, tgrid.make_grid(w, h, steps), ps, ps, 0, True)
    for i, jl in enumerate(jls):
        taps = jax.jit(lambda *p: jiclk.extract_templates_grid(*p, jg, ps, ps))(
            jl.img, jl.dx, jl.dy)
        ref = jiclk._templates_from_taps(taps.T, taps.Tdx, taps.Tdy)
        ref_tn = ref.T - jiclk.pairwise_sum(ref.T)[:, None] * jnp.float32(1.0 / (ps * ps))
        mine = [t if batch is None else t[i] for t in (*got, tn)]
        for name, g, r in zip(("T", "Tdx", "Tdy", "Hinv", "Tn"), mine, (*ref, ref_tn)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


# -- S1's start (once S2) ---------------------------------------------------------------

def _coarse_flow(lead, plan, h, w, ps, ranged, seed):
    """A coarser flow for ``plan``: the whole coarser level, or for a
    row-ranged plan the window from its first picked row (returned as the
    window's row offset)."""
    rng = np.random.default_rng(seed)
    off = int(plan.nn_rows.min()) if ranged else 0
    flow = torch.from_numpy(((rng.random(lead + (h // 2 + 1 - off, w // 2 + 1, 2)) - 0.5)
                             * 3 * ps).astype(np.float32))
    return flow, off


@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
def test_start_plain_is_the_parent_composition(ps, steps, batch, ranged):
    """S1's start (``search_start_plain``, and S1 inline, through its op
    and with ``plain=True``): the coarsest scale's zero init and the init
    from a window of the coarser flow (its first global row given), each
    with its start and start test, bitwise the parent's."""
    h, w = 48, 72
    plan = _plan(w, h, steps, ps, ranged)
    lead = () if batch is None else (batch,)
    flow, off = _coarse_flow(lead, plan, h, w, ps, ranged, ps + 7 * (batch or 0))
    planes = _random_planes(lead, h + 2 * ps, w + 2 * ps, ps)
    tpl = ticlk.PatchTemplates(torch.zeros(lead + (plan.centers.shape[0], ps * ps)),
                               None, None, None)
    for coarse, o in ((None, 0), (flow, off)):
        want = _parent_start(plan, tpl, coarse, o, ps, w, h)
        assert _equal(ticlk.search_start_plain(coarse, plan.nn_rows, plan.nn_cols, o,
                                               plan.centers, ps, w, h, batch or 0), want)
        for plain in (False, True):
            got = _both_routes(ticlk.scale_templates, *planes, plan.geom, ps, ps, 0, False,
                               plain, plan, coarse, o, w, h)
            for _, _, start in got:
                assert _equal(tuple(start), want)
    assert bool(want[2].any()) and not bool(want[2].all())   # both sides of the test


@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("ranged", [False, True])
def test_start_plain_bitwise_vs_jax(ps, steps, ranged):
    """S1's start against ``dis_tpu``: ``init_from_coarser_flow`` (with the
    coarser flow's row offset), then ``pos0 = centers + init_u`` and the
    valid-region test of ``inverse_search`` (its float32 bounds),
    bitwise."""
    h, w = 48, 72
    plan = _plan(w, h, steps, ps, ranged)
    g = plan.geom
    off = int(plan.nn_rows.min()) if ranged else 0
    rng = np.random.default_rng(ps)
    flow = ((rng.random((h // 2 + 1 - off, w // 2 + 1, 2)) - 0.5) * 3 * ps).astype(np.float32)
    jg = jgrid.make_grid(w, h, steps, iy_range=(g.iy0, g.iy0 + g.num_h))
    init_u = jgrid.init_from_coarser_flow(jg, jnp.asarray(flow), coarse_row_offset=off)
    pos0 = jnp.asarray(jg.centers) + init_u.astype(jnp.float32)
    lb = jnp.float32(-float(ps) / 2.0)
    ub_w = jnp.float32(w + ps // 2 - 2)
    ub_h = jnp.float32(h + ps // 2 - 2)
    conv0 = ((pos0[:, 0] < lb) | (pos0[:, 1] < lb) | (pos0[:, 0] > ub_w) | (pos0[:, 1] > ub_h))
    planes = _random_planes((), h + 2 * ps, w + 2 * ps, ps)
    got = ticlk.scale_templates(*planes, g, ps, ps, 0, False, False, plan,
                                torch.from_numpy(flow), off, w, h)[2]
    for name, a, b in zip(("init_u", "pos0", "conv0"), got, (init_u, pos0, conv0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("ps,steps", PS_STEPS + [(14, 7)])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
@pytest.mark.parametrize("coarser", [False, True])
def test_fused_start_is_templates_then_start(ps, steps, batch, ranged, coarser):
    """S1 with the start, inline (``scale_templates_plain``), through the
    op (its CPU function) and with ``plain=True``: bitwise
    ``templates_plain`` then ``search_start_plain``, and the parent's
    verbatim compositions, at ps 8 to 16, on planes cut to a stripe
    (``row0``) for a window's patch rows with the coarser flow's row
    offset, at the coarsest scale (no coarser flow) and with a pair axis;
    the op's start-less call (``extract_templates_grid``'s) returns empty
    starts."""
    h, w = 48, 72
    plan = _plan(w, h, steps, ps, ranged)
    g = plan.geom
    lead = () if batch is None else (batch,)
    row0 = 2 if ranged else 0
    planes = [p[..., row0:, :].contiguous()
              for p in _random_planes(lead, h + 2 * ps, w + 2 * ps, 3 * ps + (batch or 0))]
    flow, off = _coarse_flow(lead, plan, h, w, ps, ranged, 5 * ps)
    coarse, off = (flow, off) if coarser else (None, 0)
    y0, x0 = ticlk.template_origin(g, ps, ps, row0)
    grid = (g.num_w, g.num_h, steps, y0, x0, ps)
    start = (coarse, plan.nn_rows, plan.nn_cols, off, plan.centers, w, h)
    tpl, tn = ticlk.templates_plain(*planes, *grid, True)
    want = (tpl, tn, ticlk.search_start_plain(*start[:5], ps, w, h, batch or 0))
    parent = _parent_extract_templates_grid(*planes, g, ps, ps, row0)
    assert _equal(tuple(want[0]), tuple(parent))
    assert _equal(want[1], _parent_residual_template(parent, _cfg(ps, steps)))
    assert _equal(want[2], _parent_start(plan, parent, coarse, off, ps, w, h))
    for got in (*_both_routes(sk.scale_templates, *planes, *grid, True, *start),
                ticlk.scale_templates(*planes, g, ps, ps, row0, True, True, plan, coarse, off,
                                      w, h)):
        assert _equal((tuple(got[0]), got[1], tuple(got[2])), (tuple(want[0]), *want[1:]))
    with kops.ops_on_cpu():
        bare = sk.scale_templates_op(*planes, *grid, False, None, None, None, 0, None, 0, 0)
        assert _equal(tuple(bare[:4]), tuple(tpl))
        assert [tuple(t.shape) for t in bare[4:]] == [(0,)] * 4 and bare[7].dtype == torch.bool
        assert _equal(tuple(ticlk.extract_templates_grid(*planes, g, ps, ps, row0)), tuple(tpl))


# -- S3 ----------------------------------------------------------------------------------

def _weights_inputs(ps, lead, seed):
    """Templates T, final patches Q (half of them within 0.02 of the
    normalized template, so that max(1, r2) clamps) and start freezes."""
    rng = np.random.default_rng(seed)
    n = 37
    T = (rng.random(lead + (n, ps * ps)) * 255).astype(np.float32)
    Tn = T - T.mean(-1, keepdims=True)
    near = rng.random(lead + (n, 1)) < 0.5
    Q = np.where(near, Tn + (rng.random(T.shape) - 0.5) * 0.04,
                 (rng.random(T.shape) - 0.5) * 80).astype(np.float32)
    oob = rng.random(lead + (n,)) < 0.2
    return torch.from_numpy(Q), torch.from_numpy(T), torch.from_numpy(oob)


@pytest.mark.parametrize("ps", [8, 10, 12, 16])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("normalize", [False, True])
def test_fixed_weights_plain_is_the_parent_composition(ps, batch, normalize):
    """S3's plain version (and its op, and ``models/dis.py::_fixed_weights``)
    gives the parent's weights bitwise: on the CPU the parent's division by
    the Python int ps^2 is already a true division."""
    Q, T, oob = _weights_inputs(ps, () if batch is None else (batch,), ps)
    cfg = _cfg(ps, ps // 2, normalize=normalize)
    want = _parent_fixed_weights(_Res(Q, oob), ticlk.PatchTemplates(T, None, None, None), cfg)
    assert bool((want < 1.0).any()) and bool((want == 1.0).any())
    for got in _both_routes(tden.fixed_weights, Q, T, oob, ps, normalize):
        assert _equal(got, want)
    assert _equal(tden.fixed_weights(Q, T, oob, ps, normalize, plain=True), want)
    from dis_tpu_torch.models.dis import _fixed_weights

    assert _equal(_fixed_weights(_Res(Q, oob), ticlk.PatchTemplates(T, None, None, None), cfg),
                  want)


@pytest.mark.parametrize("ps", [8, 10, 12, 16])
@pytest.mark.parametrize("normalize", [False, True])
def test_fixed_weights_plain_bitwise_vs_jax(ps, normalize):
    """S3's plain version against ``dis_tpu/models/dis.py::_fixed_weights``
    run op by op: bitwise at every patch size, ps 10 and 12 included, where
    the mean's division by ps^2 = 100 and 144 rounds differently from a
    multiplication by the float32 reciprocal."""
    Q, T, oob = _weights_inputs(ps, (), 5 * ps)
    jcfg = JConfig(patch_size=ps, patch_overlap=0.5, mode="fixed",
                   patch_normalization=normalize)
    ref = jdis._fixed_weights(_Res(jnp.asarray(Q.numpy()), jnp.asarray(oob.numpy())),
                              jiclk.PatchTemplates(jnp.asarray(T.numpy()), None, None, None),
                              jcfg)
    got = tden.fixed_weights_plain(Q, T, oob, ps, normalize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fixed_weights_mean_is_a_true_division():
    """At ps 12 the template's mean is its sum divided by 144 as numpy
    divides, not the sum times float32(1/144), which a CUDA tensor divided
    by the Python int 144 would compute: on templates with one nonzero tap
    (so the pair tree's sum is that tap), with Q = 0, the weight is that
    of the template minus the true quotient wherever the product's weight
    differs from it."""
    v = (np.random.default_rng(0).random(20000) * 2e4).astype(np.float32)
    T = np.zeros((v.size, 144), np.float32)
    T[:, 0] = v
    Q = torch.zeros(v.size, 144)
    off = torch.zeros(v.size, dtype=torch.bool)

    def raw(m):
        return tden.fixed_weights_plain(Q, torch.from_numpy(T - m[:, None]), off, 12, False)

    div, mul = raw(v / np.float32(144)), raw(v * np.float32(1 / 144))
    got = tden.fixed_weights_plain(Q, torch.from_numpy(T), off, 12, True)
    assert torch.equal(got, div)
    assert int((div != mul).sum()) >= 10


# -- S4 ----------------------------------------------------------------------------------

@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
def test_densify_plain_is_the_parent_composition(ps, steps, batch, ranged):
    """S4's plain version (and its op): uniform and weighted (some weights
    0, so some pixels have no weight), full plan or a window plan,
    bitwise the parent's."""
    h, w = 48, 72
    plan = _plan(w, h, steps, ps, ranged)
    n = plan.centers.shape[0]
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(ps * 3 + (batch or 0))
    u = torch.from_numpy((rng.normal(size=lead + (n, 2)) * 3).astype(np.float32))
    wts = torch.from_numpy((rng.random(lead + (n,)) * (rng.random(lead + (n,)) > 0.3))
                           .astype(np.float32))
    for weights in (None, wts):
        want = _parent_densify(u, plan, weights)
        for got in _both_routes(tden.densify, u, plan, weights):
            assert _equal(got, want)
        assert _equal(tden.densify(u, plan, weights, plain=True), want)


@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("weighted", [False, True])
def test_densify_plain_vs_jax(ps, steps, weighted):
    """S4's plain version against ``dis_tpu``'s ``densify`` on a window
    plan (``out_row0``) and the full plan, atol 1e-5 (XLA may fuse the
    JAX stencil's adds differently)."""
    h, w = 48, 72
    for ranged in (False, True):
        plan = _plan(w, h, steps, ps, ranged)
        g = plan.geom
        lo, hi = 0, h
        if ranged:                      # _plan's window
            lo = g.iy0 * steps + g.offset_h
            hi = lo + 2 * steps + 1
        n = plan.centers.shape[0]
        rng = np.random.default_rng(ps + n)
        u = (rng.normal(size=(n, 2)) * 3).astype(np.float32)
        wts = rng.uniform(0.01, 1.0, n).astype(np.float32) if weighted else None
        jg = jgrid.make_grid(w, h, steps, iy_range=(g.iy0, g.iy0 + g.num_h))
        ref = jden.densify(jnp.asarray(u), jg, w, hi - lo, ps,
                           None if wts is None else jnp.asarray(wts), out_row0=lo)
        got = tden.densify_plain(torch.from_numpy(u),
                                 None if wts is None else torch.from_numpy(wts),
                                 plan.cover_rows, plan.cover_cols, plan.uniform_wsum,
                                 g.num_w, g.num_h)
        assert got.shape == (hi - lo, w, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# -- S1's and S4's tiles: the host-side plans and the kernels' decompositions ---------------
# Each test emulates its kernel's blocks on the CPU from the helper's plan
# (csrc/scale_glue.cu: a tile's pair and position from its index, the staged
# window or sub-block, the lanes' reads) and holds the result bitwise to the
# plain version; the kernels themselves run in tests/test_torch_kernels_cuda.py.

def _random_planes(lead, th, tw, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.random(lead + (th, tw)) * 255).astype(np.float32))
            for _ in range(3)]


# Strides at which template_tiles picks smaller tiles than PS_STEPS' 8 x 8
# patches: 16 x 8 at ps 4 (a warp holds 16 patches), 8 x 2 and 8 x 1.
SMALL_TILES = [(4, 2), (8, 12), (16, 16)]


@pytest.mark.parametrize("ps,steps", PS_STEPS + SMALL_TILES)
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
def test_template_tiles_stage_every_patch(ps, steps, batch, ranged):
    """``template_tiles``: rows a multiple of a warp's patches and shared
    bytes as the kernel checks them, under the target unless the tile is
    minimal; the tiles of every pair cover each patch once, each tile's
    window (cut at the grid's edges) lies in the planes and in its staged
    buffer; a warp's patches are consecutive outputs; the taps read from
    the staged windows at the lanes' offsets are ``templates_plain``'s
    T, Tdx and Tdy bitwise."""
    h, w = 48, 72
    plan = _plan(w, h, steps, ps, ranged)
    g = plan.geom
    row0 = 2 if ranged else 0
    th, tw = h + 2 * ps - row0, w + 2 * ps
    lead = () if batch is None else (batch,)
    planes = _random_planes(lead, th, tw, ps + row0)
    y0, x0 = ticlk.template_origin(g, ps, ps, row0)
    nb = batch or 1
    t = sk.template_tiles(ps, steps, g.num_w, g.num_h, nb)
    k, lanes = sk.lane_layout(ps)
    per_warp = 32 // lanes
    assert t.rows % per_warp == 0 and t.rows * t.cols <= 256   # a thread a patch's start
    assert (t.win_rows, t.win_cols) == ((t.rows - 1) * steps + ps, (t.cols - 1) * steps + ps)
    assert t.pitch == t.win_cols | 1
    assert t.shared_bytes == 3 * t.win_rows * t.pitch * 4
    assert t.shared_bytes <= sk.S1_SHARED_TARGET or (t.rows, t.cols) == (per_warp, 1)
    assert (t.tiles_h, t.tiles_w) == (-(-g.num_h // t.rows), -(-g.num_w // t.cols))
    assert t.blocks == nb * t.tiles_h * t.tiles_w
    n = g.num_w * g.num_h
    got = torch.full((3, nb, n, ps * ps), float("nan"))
    written = np.zeros((nb, n), np.int64)
    taps = np.arange(ps * ps)
    off = taps // ps * t.pitch + taps % ps          # the lanes' offsets, in tap order
    flat = [p.reshape(nb, th, tw) for p in planes]
    for tile in range(t.blocks):
        pair, rem = divmod(tile, t.tiles_h * t.tiles_w)
        tx, ty = divmod(rem, t.tiles_h)
        iy0, ix0 = ty * t.rows, tx * t.cols
        pv, cv = min(t.rows, g.num_h - iy0), min(t.cols, g.num_w - ix0)
        wr, wc = (pv - 1) * steps + ps, (cv - 1) * steps + ps
        r0, c0 = y0 + iy0 * steps, x0 + ix0 * steps
        assert 0 <= r0 and r0 + wr <= th and 0 <= c0 and c0 + wc <= tw
        assert wr <= t.win_rows and wc <= t.win_cols
        buf = torch.zeros(3, t.win_rows, t.pitch)
        for i in range(3):
            buf[i, :wr, :wc] = flat[i][pair, r0:r0 + wr, c0:c0 + wc]
        buf = buf.reshape(3, -1)
        slots = [(s // t.rows, s % t.rows) for s in range(t.rows * t.cols)]
        for w0 in range(0, len(slots), per_warp):   # a warp's patches, in order
            warp = [(cl, rl) for cl, rl in slots[w0:w0 + per_warp] if rl < pv and cl < cv]
            ids = [(ix0 + cl) * g.num_h + iy0 + rl for cl, rl in warp]
            assert ids == list(range(ids[0], ids[0] + len(ids))) if ids else True
            for (cl, rl), i in zip(warp, ids):
                base = rl * steps * t.pitch + cl * steps
                got[:, pair, i] = buf[:, base + off]
                written[pair, i] += 1
    assert (written == 1).all()
    want = ticlk.templates_plain(*planes, g.num_w, g.num_h, steps, y0, x0, ps, False)[0]
    for i, name in enumerate(("T", "Tdx", "Tdy")):
        assert torch.equal(got[i].reshape(getattr(want, name).shape), getattr(want, name))


def _read_wavefronts(ps, steps, pitch):
    """Shared-memory wavefronts of one warp's tap reads in S1 with row
    pitch ``pitch``: for each of a lane's K taps, the most distinct
    addresses that the warp's lanes (32 / G patches on consecutive patch
    rows, G lanes each) read in one bank, summed over the K reads."""
    k, g = sk.lane_layout(ps)
    total = 0
    for step in range(k):
        banks = {}
        for lane in range(32):
            patch, lg = divmod(lane, g)
            tap = lg * k + step
            if tap < ps * ps:
                addr = (patch * steps + tap // ps) * pitch + tap % ps
                banks.setdefault(addr % 32, set()).add(addr)
        total += max(len(a) for a in banks.values())
    return total


@pytest.mark.parametrize("ps,steps", PS_STEPS + SMALL_TILES + [(8, 4), (8, 2)])
def test_template_pitch_spreads_the_banks(ps, steps):
    """The staged pitch is the window's width rounded up to odd; at the
    presets' patch sizes and strides (ps 8 at 2, 4 and 5, ps 12 at 3) no
    pitch of the 32 from the window's width takes fewer shared-memory
    wavefronts for a warp's reads, and at ps 8 each of a lane's 8 reads is
    one wavefront; a tile that no target fits shrinks to one warp's patch
    rows in one column."""
    per_warp = 32 // sk.lane_layout(ps)[1]
    t = sk.template_tiles(ps, steps, 40, 40, 1)
    assert t.pitch % 2 == 1 and t.win_cols <= t.pitch <= t.win_cols + 1
    if (ps, steps) in ((8, 2), (8, 4), (8, 5), (12, 3)):
        best = min(_read_wavefronts(ps, steps, p) for p in range(t.win_cols, t.win_cols + 32))
        assert _read_wavefronts(ps, steps, t.pitch) == best
        assert ps != 8 or best == 8
    big = sk.template_tiles(ps, 40 * ps, 3, 3, 1)
    assert (big.rows, big.cols) == (per_warp, 1)


def _densify_emulated(u, weights, cover_rows, cover_cols, uniform_wsum, num_w, num_h, t):
    """S4's staged path, tile by tile, on the CPU: the tile's covers as
    32-bit local indices (the zero row and column the slots past the
    sub-block), the sub-block of the grid, the row pass once per (output
    row, grid column), then the column pass; each product u * w rounded
    once, before it is summed.  Asserts that every tile's covers reach no
    further than the plan stages."""
    lead = u.shape[:-2]
    nb = lead[0] if lead else 1
    out_h, kr = cover_rows.shape
    width, kc = cover_cols.shape
    uu = u.reshape(nb, num_w, num_h, 2)
    ww = None if weights is None else weights.reshape(nb, num_w, num_h)
    out = torch.full((nb, out_h, width, 2), float("nan"))
    th, tw = sk.DENSIFY_ROWS, sk.DENSIFY_COLS
    for tile in range(t.blocks):
        pair, rem = divmod(tile, t.tiles_h * t.tiles_w)
        ty, tx = divmod(rem, t.tiles_w)
        y0, x0 = ty * th, tx * tw
        rows = torch.full((th, kr), num_h, dtype=torch.int64)
        cols = torch.full((tw, kc), num_w, dtype=torch.int64)
        rows[:min(th, out_h - y0)] = cover_rows[y0:y0 + th]
        cols[:min(tw, width - x0)] = cover_cols[x0:x0 + tw]
        rv, cv = rows[rows != num_h], cols[cols != num_w]
        rlo = int(rv.min()) if rv.numel() else 0
        clo = int(cv.min()) if cv.numel() else 0
        nr = int(rv.max()) - rlo + 1 if rv.numel() else 0
        nc = int(cv.max()) - clo + 1 if cv.numel() else 0
        assert nr <= t.grid_rows and nc <= t.grid_cols
        rl = torch.where(rows == num_h, t.grid_rows, rows - rlo).to(torch.int32)
        cl = torch.where(cols == num_w, t.grid_cols, cols - clo).to(torch.int32)
        # the 32-bit copy of the covers is the int64 plan's
        assert torch.equal(torch.where(rl == t.grid_rows, num_h, rl.long() + rlo), rows)
        assert torch.equal(torch.where(cl == t.grid_cols, num_w, cl.long() + clo), cols)
        sub = uu[pair, clo:clo + nc, rlo:rlo + nr].permute(2, 1, 0)    # [2, r, c]
        if ww is not None:
            wsub = ww[pair, clo:clo + nc, rlo:rlo + nr].T[None]
            sub = torch.cat([sub * wsub, wsub])
        su = torch.zeros(sub.shape[0], t.grid_rows + 1, t.grid_cols)
        su[:, :nr, :nc] = sub
        acc = torch.zeros(sub.shape[0], th, t.grid_cols + 1)
        for k in range(kr):
            v = su[:, rl[:, k].long(), :nc]
            acc[:, :, :nc] = v if k == 0 else acc[:, :, :nc] + v
        f = None
        for k in range(kc):
            v = acc[:, :, cl[:, k].long()]
            f = v if f is None else f + v
        ws = f[2] if ww is not None else torch.zeros(th, tw)
        if ww is None:
            plane = uniform_wsum[y0:y0 + th, x0:x0 + tw, 0]
            ws[:plane.shape[0], :plane.shape[1]] = plane
        flow = torch.where(ws > 0, f[:2] / torch.where(ws > 0, ws, torch.ones_like(ws)),
                           torch.zeros_like(f[:2]))
        hh, wd = min(th, out_h - y0), min(tw, width - x0)
        out[pair, y0:y0 + hh, x0:x0 + wd] = flow[:, :hh, :wd].permute(1, 2, 0)
    return out.reshape(*lead, out_h, width, 2)


@pytest.mark.parametrize("ps,steps", PS_STEPS)
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("ranged", [False, True])
def test_densify_tiles_stage_every_cover(ps, steps, batch, ranged):
    """``densify_tiles``: tile counts and shared bytes as the kernel checks
    them; on full and window plans 300 pixels wide (three tile columns, the
    last cut), every tile's covers reach no further than it stages, their
    32-bit local copy is the int64 plan's, and the staged passes emulated
    tile by tile give ``densify_plain``'s flow bitwise, uniform and
    weighted."""
    h, w = 48, 300
    plan = _plan(w, h, steps, ps, ranged)
    g = plan.geom
    n = g.num_w * g.num_h
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(ps + (batch or 0))
    u = torch.from_numpy((rng.normal(size=lead + (n, 2)) * 3).astype(np.float32))
    wts = torch.from_numpy((rng.random(lead + (n,)) * (rng.random(lead + (n,)) > 0.3))
                           .astype(np.float32))
    out_h, kr = plan.cover_rows.shape
    kc = plan.cover_cols.shape[1]
    rows, cols = sk.DENSIFY_ROWS, sk.DENSIFY_COLS
    for weights in (None, wts):
        t = sk.densify_tiles(batch or 1, out_h, w, kr, kc, g.num_w, weights is not None)
        term = 8 if weights is None else 16       # {u0, u1} or {u0 w, u1 w, w, 0}
        assert (t.tiles_h, t.tiles_w) == (-(-out_h // rows), 3)
        assert t.blocks == (batch or 1) * t.tiles_h * 3
        assert t.shared_bytes == (term * ((t.grid_rows + 1) * t.grid_cols    # sub-block
                                          + rows * (t.grid_cols + 1))        # row sums
                                  + 4 * ((rows * cols if weights is None else 0)
                                         + rows * kr + cols * kc))           # 32-bit covers
        args = (u, weights, plan.cover_rows, plan.cover_cols, plan.uniform_wsum, g.num_w,
                g.num_h)
        assert torch.equal(_densify_emulated(*args, t), tden.densify_plain(*args))


# -- the ops -------------------------------------------------------------------------------

def _op_args(name, batch):
    lead = () if batch is None else (batch,)
    ps, steps, h, w = 8, 5, 24, 32
    plan = tgrid.scale_plan(w, h, steps, ps, CPU)
    g = plan.geom
    n = plan.centers.shape[0]
    rng = np.random.default_rng(1)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.random(lead + shape) * scale).astype(np.float32))

    if name in ("scale_templates", "search_start"):
        # S1 without the start, and S1 with the start from a coarser flow.
        th, tw = h + 2 * ps, w + 2 * ps
        tpl = (t(th, tw, scale=255), t(th, tw), t(th, tw), g.num_w, g.num_h, steps,
               *ticlk.template_origin(g, ps, ps), ps, True)
        if name == "scale_templates":
            return (*tpl, None, None, None, 0, None, 0, 0)
        return (*tpl, t(h // 2 + 1, w // 2 + 1, 2, scale=9), plan.nn_rows, plan.nn_cols, 0,
                plan.centers, w, h)
    if name == "fixed_weights":
        return (t(n, ps * ps, scale=9), t(n, ps * ps, scale=9),
                torch.from_numpy(rng.random(lead + (n,)) < 0.3), ps, True)
    return (t(n, 2), t(n), plan.cover_rows, plan.cover_cols, None, g.num_w, g.num_h)


@pytest.mark.parametrize("name", ["scale_templates", "search_start", "fixed_weights",
                                  "densify"])
@pytest.mark.parametrize("batch", [None, 2])
def test_opcheck_scale_ops(name, batch):
    """Each op; ``search_start`` is S1's op with the start from a coarser
    flow (once an op of its own)."""
    op = sk.scale_templates_op if name == "search_start" else getattr(sk, f"{name}_op")
    torch.library.opcheck(op, _op_args(name, batch))


def test_opcheck_optional_inputs():
    """S1's start at the coarsest scale (no coarser flow; three pairs, from
    the planes) and S4 with the uniform weight (no weights; with weights,
    as in ``_op_args``, no weight plane)."""
    plan = tgrid.scale_plan(32, 24, 5, 8, CPU)
    g = plan.geom
    planes = _random_planes((3,), 24 + 16, 32 + 16, 1)
    torch.library.opcheck(sk.scale_templates_op,
                          (*planes, g.num_w, g.num_h, 5, *ticlk.template_origin(g, 8, 8), 8,
                           False, None, plan.nn_rows, plan.nn_cols, 0, plan.centers, 32, 24))
    u = torch.rand(plan.centers.shape[0], 2)
    torch.library.opcheck(sk.densify_op, (u, None, plan.cover_rows, plan.cover_cols,
                                          plan.uniform_wsum, plan.geom.num_w,
                                          plan.geom.num_h))


SCHEMAS = {
    "scale_templates": "(Tensor img, Tensor dx, Tensor dy, SymInt num_w, SymInt num_h, "
                       "SymInt steps, SymInt y0, SymInt x0, SymInt ps, bool residual, "
                       "Tensor? flow_coarse, Tensor? nn_rows, Tensor? nn_cols, "
                       "SymInt coarse_row_offset, Tensor? centers, SymInt width, "
                       "SymInt height) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, "
                       "Tensor, Tensor)",
    "search_start": None,    # fused into scale_templates: no op of its own
    "fixed_weights": "(Tensor Q, Tensor T, Tensor start_oob, SymInt ps, bool normalize) -> "
                     "Tensor",
    "densify": "(Tensor u, Tensor? weights, Tensor cover_rows, Tensor cover_cols, "
               "Tensor? uniform_wsum, SymInt num_w, SymInt num_h) -> Tensor",
}


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_scale_ops_have_flat_schemas(name):
    """One op per C entry point, of tensors, ints and bools, writing
    nothing in place; each named in the cost model's kernel table.  The
    search start has no op, no wrapper and no cost entry of its own: S1's
    op takes its inputs."""
    if SCHEMAS[name] is None:
        assert not hasattr(sk, f"{name}_op") and not hasattr(sk, name)
        assert not hasattr(torch.ops.dis_tpu_torch, name) and name not in cost.KERNELS
        return
    op = getattr(sk, f"{name}_op")
    assert str(op._opoverload._schema) == f"dis_tpu_torch::{name}{SCHEMAS[name]}"
    assert cost.KERNELS[name] == {"scale_templates": "S1", "fixed_weights": "S3",
                                  "densify": "S4"}[name]


def test_scale_wrappers_refuse_non_cuda_non_cpu_tensors():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused before any build or launch."""
    z = lambda *s, dtype=torch.float32: torch.zeros(s, device="meta", dtype=dtype)
    wrappers = (sk.scale_templates, sk.fixed_weights, sk.densify)
    for w in wrappers:
        w.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        sk.scale_templates(z(40, 48), z(40, 48), z(40, 48), 4, 4, 5, 0, 0, 8, False)
    i64 = torch.int64
    cpu = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):   # the start's inputs on another device
        sk.scale_templates(cpu(40, 48), cpu(40, 48), cpu(40, 48), 5, 4, 5, 0, 0, 8, False,
                           None, z(4, dtype=i64), z(5, dtype=i64), 0, z(20, 2), 32, 24)
    with pytest.raises(ValueError, match="CUDA"):
        sk.fixed_weights(z(6, 64), z(6, 64), z(6, dtype=torch.bool), 8, True)
    with pytest.raises(ValueError, match="CUDA"):
        sk.densify(z(20, 2), None, z(24, 3, dtype=i64), z(32, 3, dtype=i64), z(24, 32, 1),
                   5, 4)
    assert [w.launches for w in wrappers] == [0, 0, 0]


def test_cpu_export_records_the_scale_ops():
    """``DIS_FAST`` at 40x56 traced through the ops (within ``ops_on_cpu``,
    as a CUDA export routes): S1, S3 and S4 once per scale, in a program with no
    gather and no index_select of a plain version, which runs the ops' CPU
    functions with the eager bits; its cost analysis counts each launch by
    the package's formulas."""
    from dis_tpu_torch.models.dis import flow_plans
    from dis_tpu_torch.serving import _Flow

    cfg, h, w = dis_tpu_torch.DIS_FAST, 40, 56
    levels = cfg.coarsest_scale - cfg.finest_scale + 1
    flow_plans(cfg, h, w, CPU)
    with kops.ops_on_cpu():
        program = torch.export.export(_Flow(cfg), (torch.zeros(h, w), torch.zeros(h, w)))
    assert cost.kernel_ops(program) == {"K3": 2, "K2": 0, "K2c": 0, "K1": levels,
                                        "S1": levels, "S3": levels, "S4": levels}
    assert not any(n.target in (torch.ops.aten.gather.default,
                                torch.ops.aten.index_select.default)
                   for n in program.graph.nodes)
    a, b = (torch.from_numpy(x) for x in synthetic_pair(h, w))
    assert torch.equal(program.module()(a, b), dis_tpu_torch.dis_flow(a, b, cfg))
    kernels = cost.flow_cost(cfg, h, w)["kernels"]
    assert {k: len(v) for k, v in kernels.items()} == cost.kernel_ops(program)
    ps, p = cfg.patch_size, cfg.img_padding
    for i, s in enumerate(range(cfg.coarsest_scale, cfg.finest_scale - 1, -1)):
        g = tgrid.make_grid(w >> s, h >> s, cfg.steps)
        n = g.num_w * g.num_h
        k = -(-ps // cfg.steps) + 1
        entry = lambda name: (kernels[name][i]["bytes accessed"], kernels[name][i]["flops"])
        tpl = cost.templates_cost(1, (h >> s) + 2 * p, (w >> s) + 2 * p, n, ps, True)
        start = cost.start_cost(1, g.num_w, g.num_h, s != cfg.coarsest_scale)
        assert entry("S1") == (tpl[0] + start[0], tpl[1] + start[1])
        assert entry("S3") == cost.weights_cost(1, n, ps, True)
        assert entry("S4") == cost.densify_cost(1, n, h >> s, w >> s, k, k, True)


@pytest.mark.parametrize("cfg_name", ["DIS_FAST", "compat"])
@pytest.mark.parametrize("batch", [None, 2])
def test_flow_is_the_parent_composition(cfg_name, batch):
    """``dis_flow`` end to end, inline, through the ops and with
    ``plain=True``: one flow, bitwise (the stages above compose)."""
    cfg = dis_tpu_torch.DIS_FAST if cfg_name == "DIS_FAST" else dis_tpu_torch.DISConfig(
        iterations=8, coarsest_scale=2, patch_overlap=0.3, mode="compat")
    pairs = [synthetic_pair(40, 56, seed=i) for i in range(batch or 1)]
    a, b = (torch.from_numpy(np.stack([p[k] for p in pairs])) for k in (0, 1))
    if batch is None:
        a, b = a[0], b[0]
    inline, routed = _both_routes(dis_tpu_torch.dis_flow, a, b, cfg)
    assert torch.equal(inline, routed)
    assert torch.equal(inline, dis_tpu_torch.dis_flow(a, b, cfg, plain=True))
    if batch:
        for i in range(batch):
            assert torch.equal(inline[i], dis_tpu_torch.dis_flow(a[i], b[i], cfg))
