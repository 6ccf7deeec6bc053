"""Batched pairs in the port (dis_tpu_torch), on CPU.

- Each stage over a batch [B, ...] equals B serial calls bitwise: every
  step is an elementwise op, an index pick or the fixed pair tree, so a
  pair's bits do not depend on its batch (the port's own gate; the JAX
  package holds vmap == serial only to 1e-5, tests/test_parallel.py).
- ``batched_flow_fn`` / ``batched_flow_epe_fn`` against
  ``dis_tpu.parallel`` (mesh None, JAX CPU) on one batch of the five
  synthetic families that tests/test_torch_dis.py does not run, under the
  ``dis_flow`` gates of tests/test_torch_dis.py: mean |d| <= 1e-3 px, at
  most 1% of pixels over 1e-2 px, |dEPE| <= 1e-3 px per pair.
- The batched plain versions of K2b and K1b against ``jax.vmap`` of the
  Pallas kernels in interpret mode, which runs their ``custom_vmap``
  rules: regions bitwise; the search in the equivalence class of
  tests/test_pallas_iclk.py (u within 1e-3 px where the freeze state
  agrees, < 2% freeze flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.ops import iclk as jiclk
from dis_tpu.ops.grid import make_grid as jmake_grid
from dis_tpu.ops.pallas.extract_kernel import extract_regions_pallas
from dis_tpu.ops.pallas.iclk_kernel import inverse_search_pallas
from dis_tpu.ops.pyramid import construct_pyramid as jpyramid
from dis_tpu.parallel import batched_flow_epe_fn as jbatched_flow_epe_fn
from dis_tpu_torch.utils import synth
from dis_tpu.utils.metrics import epe_jax
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.ops import densify as tden
from dis_tpu_torch.ops import grid as tgrid
from dis_tpu_torch.ops import iclk as ticlk
from dis_tpu_torch.ops import image as tim
from dis_tpu_torch.ops import pyramid as tpyr
from dis_tpu_torch.parallel import batched_flow_epe_fn, batched_flow_fn
from dis_tpu_torch.utils import epe_torch

from conftest import synthetic_pair
from torch_threads import one_thread

CPU = torch.device("cpu")
FAMILIES = ("zoom", "shear", "discontinuous", "smooth_warp", "natural_warp")
CONFIGS = {
    "compat": JConfig(iterations=16, patch_size=8, coarsest_scale=2, finest_scale=0,
                      patch_overlap=0.3, mode="compat", early_exit=False),
    "fixed_finest1": JConfig(iterations=12, patch_size=8, coarsest_scale=3,
                             finest_scale=1, patch_overlap=0.3, mode="fixed"),
}


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def _pairs(b, h, w):
    """b shifted pairs as [b, h, w] tensors (one shift and seed per pair)."""
    ps = [synthetic_pair(h, w, shift=(1.0 + i, 2.0 - i), seed=i) for i in range(b)]
    return tuple(torch.from_numpy(np.stack([p[k] for p in ps])) for k in (0, 1))


def _each(x):
    return [t.contiguous() for t in x]


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_batched_dis_flow_equals_serial_bitwise(cfg_name):
    cfg = _tcfg(CONFIGS[cfg_name])
    a, b = _pairs(3, 37, 53)       # padding, upsample and crop all run
    flows = dis_tpu_torch.dis_flow(a, b, cfg)
    assert flows.shape == (3, 37, 53, 2)
    for i, (x, y) in enumerate(zip(_each(a), _each(b))):
        assert torch.equal(flows[i], dis_tpu_torch.dis_flow(x, y, cfg)), i
    padded = batched_flow_fn(cfg)(*(tim.pad_divisible(t, cfg.coarsest_scale)[0]
                                    for t in (a, b)))
    for i in range(3):
        x, y = (tim.pad_divisible(t[i], cfg.coarsest_scale)[0] for t in (a, b))
        assert torch.equal(padded[i], dis_tpu_torch.dis_flow_padded(x, y, cfg)), i


# Each stage runs on the batch (i None) or on pair i alone.

def _stage_pyramid(a, b, i):
    return [t for lvl in tpyr.construct_pyramid(a, 2, 8) for t in lvl[:3]]


def _stage_image(a, b, i):
    p, (pw, ph) = tim.pad_divisible(a, 3)
    f = torch.stack([p, p * 0.5], -1)          # a flow [(B,) H, W, 2]
    return [p, tim.resize_bilinear(f, 61, 29), tim.crop_padding(f, pw, ph, 52, 36)]


def _search_inputs(a, b, i):
    cfg = dis_tpu_torch.DISConfig(iterations=10, patch_size=8, coarsest_scale=0,
                                  patch_overlap=0.5, mode="fixed")
    l1 = tpyr.construct_pyramid(a, 0, 8)[0]
    l2 = tpyr.construct_pyramid(b, 0, 8)[0]
    plan = tgrid.scale_plan(l1.width, l1.height, cfg.steps, 8, CPU)
    tpl = ticlk.extract_templates_grid(l1.img, l1.dx, l1.dy, plan.geom, 8, 8)
    init_u = torch.from_numpy(np.random.default_rng(4).uniform(
        -2, 2, (3,) + plan.geom.centers.shape).astype(np.float32))
    return cfg, l1, l2, plan, tpl, init_u if i is None else init_u[i]


def _stage_templates(a, b, i):
    return list(_search_inputs(a, b, i)[4])


def _stage_search(a, b, i):
    cfg, l1, l2, plan, tpl, init_u = _search_inputs(a, b, i)
    res = ticlk.inverse_search(l2.img, tpl, plan.centers, init_u, cfg,
                               l1.width, l1.height)
    return list(res) + [ticlk.residual_template(tpl, cfg),
                        tdis._fixed_weights(res, tpl, cfg)]


def _stage_densify(a, b, i):
    cfg, l1, l2, plan, tpl, init_u = _search_inputs(a, b, i)
    flow = tden.densify(init_u, plan, init_u[..., 0].abs() + 0.1)
    finer = tgrid.scale_plan(l1.width * 2, l1.height * 2, cfg.steps, 8, CPU)
    return [flow, tden.densify(init_u, plan), tgrid.init_from_coarser_flow(finer, flow)]


@pytest.mark.parametrize("stage", [_stage_pyramid, _stage_image, _stage_templates,
                                   _stage_search, _stage_densify],
                         ids=lambda f: f.__name__[len("_stage_"):])
def test_batched_stage_equals_serial_bitwise(stage):
    """Each stage (the plain versions of K3, K2b, K1b included) over a
    batch of 3 equals the stage on each pair alone, bitwise."""
    a, b = _pairs(3, 36, 52)
    got = stage(a, b, None)
    for i, (x, y) in enumerate(zip(_each(a), _each(b))):
        for g, o in zip(got, stage(x, y, i)):
            assert g.shape[1:] == o.shape and torch.equal(g[i], o), (stage, i)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_batched_flow_matches_jax(cfg_name):
    """One batch of the five families tests/test_torch_dis.py does not run, through
    ``batched_flow_epe_fn`` on both sides and the port's
    ``batched_flow_fn``."""
    jcfg = CONFIGS[cfg_name]
    tcfg = _tcfg(jcfg)
    h, w = 64, 96
    pairs = [synth.make_pair(f, h, w) for f in FAMILIES]
    a = np.stack([p[0] for p in pairs]).astype(np.float32)
    b = np.stack([p[1] for p in pairs]).astype(np.float32)
    s = 2 ** jcfg.finest_scale
    gt = np.stack([np.where(p[3][..., None], p[2], 1e10) for p in pairs])
    gt = np.ascontiguousarray(gt[:, ::s, ::s] / s).astype(np.float32)
    valid = np.stack([p[3] for p in pairs])[:, ::s, ::s]
    ref, ref_mean = jbatched_flow_epe_fn(jcfg)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gt))
    ref = np.asarray(ref)
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, gt))
    got, got_mean = batched_flow_epe_fn(tcfg)(ta, tb, tg)
    assert torch.equal(got, batched_flow_fn(tcfg)(ta, tb))
    got = got.numpy()
    assert got.shape == ref.shape == (5, h // s, w // s, 2)
    assert np.isfinite(got).all()
    for i, fam in enumerate(FAMILIES):
        d = np.sqrt(((got[i] - ref[i]) ** 2).sum(-1))
        assert d.mean() <= 1e-3, (fam, d.mean())
        assert (d > 1e-2).mean() <= 0.01, (fam, (d > 1e-2).mean())
        de = (synth.masked_epe(got[i], gt[i], valid[i], border=12 // s)
              - synth.masked_epe(ref[i], gt[i], valid[i], border=12 // s))
        assert abs(de) <= 1e-3, (fam, de)
    assert abs(float(got_mean) - float(ref_mean)) <= 1e-3


def test_epe_matches_epe_jax():
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(2, 24, 32, 2)).astype(np.float32)
    gt = rng.normal(size=(2, 24, 32, 2)).astype(np.float32)
    gt[0, :3] = 1e10                      # sentinel ground truth
    flow[1, 5, 5] = np.nan                # non-finite error
    ref = [float(epe_jax(jnp.asarray(flow[i]), jnp.asarray(gt[i]))) for i in range(2)]
    got = epe_torch(torch.from_numpy(flow), torch.from_numpy(gt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert float(epe_torch(torch.from_numpy(flow[0]), torch.from_numpy(gt[0]))) == float(got[0])


def _jax_levels(b, h, w, ps):
    """Level 0 of both images of b shifted pairs, JAX and port copies."""
    out = []
    for i in range(b):
        i1, i2 = synthetic_pair(h, w, shift=(2.0, 1.0), seed=20 + i)
        out.append((jpyramid(jnp.asarray(i1), 0, ps)[0], jpyramid(jnp.asarray(i2), 0, ps)[0]))
    return out


def test_batched_regions_match_pallas_vmap():
    """``extract_regions_plain`` on [2, th, tw] planes equals ``jax.vmap``
    of ``extract_regions_pallas`` (interpret mode: the K2b rule) bitwise,
    as tests/test_pallas_extract.py runs it."""
    ps, pad, n = 8, 8, 150
    rng = np.random.default_rng(17)
    imgs = (rng.random((2, 72, 200)) * 255).astype(np.float32)
    pos0 = np.stack([rng.random((2, n)) * 190 - 4,
                     rng.random((2, n)) * 62 - 4], -1).astype(np.float32)
    pos0[0, :2] = [[-40.0, 5.0], [500.0, 900.0]]          # clipped bases

    def f(img, p):
        return extract_regions_pallas(img, p, ps, pad, block=128, interpret=True)

    ref = jax.vmap(f)(jnp.asarray(imgs), jnp.asarray(pos0))
    got = ticlk.extract_regions_plain(torch.from_numpy(imgs), torch.from_numpy(pos0), ps, pad)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_batched_search_matches_pallas_vmap(mode):
    """``iclk_search_plain`` on 2 pairs against ``jax.vmap`` of
    ``inverse_search_pallas`` in interpret mode, whose rule folds the
    pairs into one grid (K1b), with the centers unbatched (broadcast)."""
    ps = 8
    levels = _jax_levels(2, 40, 56, ps)
    jcfg = JConfig(iterations=10, patch_size=ps, coarsest_scale=0, patch_overlap=0.5,
                   early_exit=False, mode=mode)
    tcfg = _tcfg(jcfg)
    w, h = levels[0][0].width, levels[0][0].height
    geom = jmake_grid(w, h, jcfg.steps)
    centers = geom.centers
    init_u = np.random.default_rng(8).uniform(-2, 2, (2,) + centers.shape).astype(np.float32)
    conv0 = ticlk.out_of_bounds(torch.from_numpy(centers + init_u), ps, w, h)
    tpls, jregs = [], []
    for i, (l1, l2) in enumerate(levels):
        tpls.append(jax.jit(lambda *p: jiclk.extract_templates_grid(*p, geom, ps, ps))(
            l1.img, l1.dx, l1.dy))
        jregs.append(jiclk.extract_regions(l2.img, jnp.asarray(centers + init_u[i]), ps, ps))
    stack = lambda xs: jnp.stack(list(xs))
    jT, jTdx, jTdy, jHinv = (stack(getattr(t, k) for t in tpls) for k in ("T", "Tdx", "Tdy", "Hinv"))
    jreg, jby, jbx = (stack(r[k] for r in jregs) for k in range(3))

    def one(reg, by, bx, T, Tdx, Tdy, Hinv, iu, c0):
        return inverse_search_pallas(reg, by, bx, T, Tdx, Tdy, Hinv, jnp.asarray(centers),
                                     iu, c0, jcfg, w, h, interpret=True)

    ru, _, rc = jax.vmap(one)(jreg, jby, jbx, jT, jTdx, jTdy, jHinv,
                              jnp.asarray(init_u), jnp.asarray(conv0.numpy()))
    tpl = interop.templates_from_numpy(*(np.asarray(x) for x in (jT, jTdx, jTdy, jHinv)))
    img2 = torch.from_numpy(np.stack([np.asarray(l2.img) for _, l2 in levels]))
    tu, tinit = torch.from_numpy(centers), torch.from_numpy(init_u)
    regions = ticlk.extract_regions_plain(img2, tu + tinit, ps, ps)
    Tn = ticlk.residual_template(tpl, tcfg) if mode == "fixed" else None
    gu, _, gc = ticlk.iclk_search_plain(*regions, tpl, Tn, tu, tinit, conv0, tcfg, w, h)
    assert gu.shape == (2, centers.shape[0], 2)
    agree = gc.numpy() == np.asarray(rc)
    du = np.abs(gu.numpy() - np.asarray(ru)).max(-1)
    assert du[agree].max() < 1e-3, du[agree].max()
    assert (~agree).mean() < 0.02, (~agree).mean()


@pytest.mark.parametrize("bad,match", [
    ((torch.zeros(32), torch.zeros(32)), "grayscale plane"),
    ((torch.zeros(2, 1, 32, 32), torch.zeros(2, 1, 32, 32)), "grayscale plane"),
    ((torch.zeros(0, 32, 32), torch.zeros(0, 32, 32)), "empty batch"),
    ((torch.zeros(2, 32, 32), torch.zeros(3, 32, 32)), "batch sizes differ"),
    ((torch.zeros(2, 32, 32), torch.zeros(32, 32)), "one input is batched"),
    ((torch.zeros(2, 32, 32), torch.zeros(2, 32, 40)), "shapes differ"),
], ids=["1d", "4d", "empty", "b_differs", "mixed", "hw_differs"])
def test_pair_check_errors(bad, match):
    with pytest.raises(ValueError, match=match):
        dis_tpu_torch.dis_flow(*bad, dis_tpu_torch.DIS_FAST)


def test_batched_flow_fn_refusals():
    cfg = dis_tpu_torch.DIS_FAST
    single = (torch.zeros(32, 32), torch.zeros(32, 32))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        batched_flow_fn(cfg)(*single)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        batched_flow_epe_fn(cfg)(*single, torch.zeros(32, 32, 2))
    # A refinement preset is no longer refused: the batch runs, each pair
    # bitwise its serial flow.
    a, b = _pairs(2, 32, 48)
    cfg = dis_tpu_torch.DIS_MEDIUM
    with one_thread():
        flows = batched_flow_fn(cfg)(a, b)
        assert flows.shape == (2, 32, 48, 2)
        for i in range(2):
            assert torch.equal(flows[i], dis_tpu_torch.dis_flow_padded(
                a[i].contiguous(), b[i].contiguous(), cfg)), i
