"""Port parity end to end with variational refinement on (dis_tpu_torch vs
dis_tpu).

Configs shaped like ``DIS_MEDIUM`` (ps 8, overlap 0.5, per-level
refinement on the intensity planes, alpha 40, omega 1.6) and
``DIS_FULL`` (ps 12, overlap 0.75), cut to ``coarsest_scale`` 2 and to
2 inner x 2 SOR sweeps so that each JAX reference compiles in seconds;
and one variant that takes the other value of each option: refinement
at the finest scale only, on the Q1 planes, with the ``warp1`` scheme
(one variant, to keep the JAX compiles few; each option alone is shown
to reach the flow on the port's side).  On 64x96 pairs made from numpy
seeds, the port's ``dis_flow`` on torch CPU
against the JAX package's on JAX CPU, with the gates of
``tests/test_torch_dis.py``: mean |d| <= 1e-3 px, at most 1% of pixels
over 1e-2 px, |dEPE| <= 1e-3 px.  (``refined_init_clamp`` does not bind
at this size; ``tests/test_torch_variational.py`` holds the clamp of
``refine_level`` against the JAX package's.)

Within the port, with refinement on: the tiling engines bitwise equal
to the untiled ``dis_flow_padded`` (and held to ``dis_tpu.parallel.tiles``
under the same gates), a batch bitwise equal to its pairs alone, and a
CPU ``aot_compile`` of ``DIS_MEDIUM`` bitwise equal to ``dis_flow``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dis_tpu_torch
from dis_tpu.config import DIS_FULL as J_FULL
from dis_tpu.config import DIS_MEDIUM as J_MEDIUM
from dis_tpu.models import dis as jdis
from dis_tpu.parallel import tiles as jtiles
from dis_tpu_torch.utils import synth
from dis_tpu_torch import interop
from dis_tpu_torch.models import dis as tdis
from dis_tpu_torch.parallel import tiles as ttiles
from dis_tpu_torch.serving import aot_compile

from conftest import synthetic_pair
from torch_threads import one_thread

H, W = 64, 96
_CUT = dict(coarsest_scale=2, refinement_inner_sweeps=2, refinement_sor_sweeps=2)
MEDIUM = dataclasses.replace(J_MEDIUM, **_CUT)
FINEST_ONLY = dataclasses.replace(MEDIUM, refine_per_level=False)
CONFIGS = {
    "medium": MEDIUM,
    "full": dataclasses.replace(J_FULL, **_CUT),
    "medium_finest_q1_warp1": dataclasses.replace(FINEST_ONLY, refinement_planes="q1",
                                                  refinement_scheme="warp1"),
}
VARIANTS = {
    "finest_only": FINEST_ONLY,
    "q1": dataclasses.replace(MEDIUM, refinement_planes="q1"),
    "warp1": dataclasses.replace(MEDIUM, refinement_scheme="warp1"),
    "clamped": dataclasses.replace(MEDIUM, refined_init_clamp=True),
}
PAIRS = ("synthetic_pair", "rotation")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _tcfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(name):
    if name == "synthetic_pair":
        i1, i2 = synthetic_pair(H, W, shift=(2.0, 1.0), seed=41)
        gt = np.broadcast_to(np.float32([2.0, 1.0]), (H, W, 2))
        return i1, i2, gt, np.ones((H, W), bool)
    return synth.make_pair(name, H, W)


@pytest.fixture(scope="module")
def jax_flows():
    """The JAX package's ``dis_flow`` per (config, pair), made once per
    module.  ``warp1`` runs eagerly (``tests/test_variational.py`` warns
    about jitting its per-level program late in a process)."""
    cache = {}

    def get(cfg_name, pair):
        key = (cfg_name, pair)
        if key not in cache:
            i1, i2 = _pair(pair)[:2]
            fn = jdis.dis_flow
            if CONFIGS[cfg_name].refinement_scheme == "warp1":
                fn = getattr(fn, "__wrapped__", fn)
            cache[key] = np.asarray(fn(jnp.asarray(i1), jnp.asarray(i2), CONFIGS[cfg_name]))
        return cache[key]

    return get


def _gate(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_refined_dis_flow_matches_jax(jax_flows, cfg_name, pair):
    i1, i2, gt, valid = _pair(pair)
    ref = jax_flows(cfg_name, pair)
    got = dis_tpu_torch.dis_flow(_t(i1), _t(i2), _tcfg(CONFIGS[cfg_name])).numpy()
    assert got.shape == (H, W, 2)
    _gate(got, ref)
    de = synth.masked_epe(got, gt, valid) - synth.masked_epe(ref, gt, valid)
    assert abs(de) <= 1e-3, de


def test_refinement_changes_the_flow(jax_flows):
    """Each option alone reaches the flow: every variant differs from the
    others and from the flow without refinement (the clamp does not bind
    at this size, so it equals ``medium``), and the JAX package's variant
    differs from its ``medium`` too."""
    i1, i2 = _pair("synthetic_pair")[:2]
    cfgs = {"medium": MEDIUM, "none": dataclasses.replace(MEDIUM, refinement_iters=0),
            **VARIANTS}
    flows = {k: dis_tpu_torch.dis_flow(_t(i1), _t(i2), _tcfg(c)).numpy() for k, c in cfgs.items()}
    assert np.array_equal(flows.pop("clamped"), flows["medium"])
    names = sorted(flows)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not np.array_equal(flows[a], flows[b]), (a, b)
    assert not np.array_equal(jax_flows("medium", "synthetic_pair"),
                              jax_flows("medium_finest_q1_warp1", "synthetic_pair"))


@pytest.mark.parametrize("cfg_name", ["medium", "finest_only", "full"])
def test_tiled_refined_flow_is_untiled_bitwise(cfg_name):
    """3-part grid tiling and 2-stripe exact tiling (per-level refinement
    routes to the grid engine) equal the untiled flow bitwise."""
    h, w = 128, 64
    i1, i2 = synthetic_pair(h, w, shift=(1.0, 2.0), seed=43)
    tcfg = _tcfg({**CONFIGS, **VARIANTS}[cfg_name])
    a, b = _t(i1), _t(i2)
    untiled = tdis.dis_flow_padded(a, b, tcfg)
    halo = ttiles.min_stripe_halo(tcfg, w, h, 2)
    assert torch.equal(ttiles.grid_tiled_flow(a, b, tcfg, 3), untiled)
    assert torch.equal(ttiles.tiled_flow_exact(a, b, tcfg, 2, halo), untiled)
    # refine=False: the stripes' flow without refinement.
    plain_cfg = dataclasses.replace(tcfg, refinement_iters=0)
    if not tcfg.refine_per_level:
        assert torch.equal(ttiles.tiled_flow_exact(a, b, tcfg, 2, halo, refine=False),
                           tdis.dis_flow_padded(a, b, plain_cfg))


def test_tiled_refined_flow_matches_jax():
    """Both engines with per-level refinement (``tiled_flow_exact`` routes
    it to the grid engine, as the JAX package does) against
    ``dis_tpu.parallel.tiles.grid_tiled_flow``."""
    i1, i2 = _pair("synthetic_pair")[:2]
    tcfg = _tcfg(MEDIUM)
    ref = np.asarray(jax.jit(lambda x, y: jtiles.grid_tiled_flow(x, y, MEDIUM, 2))(
        jnp.asarray(i1), jnp.asarray(i2)))
    halo = jtiles.min_stripe_halo(MEDIUM, W, H, 2)
    assert ttiles.min_stripe_halo(tcfg, W, H, 2) == halo
    for got in (ttiles.grid_tiled_flow(_t(i1), _t(i2), tcfg, 2),
                ttiles.tiled_flow_exact(_t(i1), _t(i2), tcfg, 2, halo)):
        _gate(got.numpy(), ref)


@pytest.mark.parametrize("cfg_name", ["medium", "full", "finest_only", "clamped"])
def test_refined_batch_equals_serial_bitwise(cfg_name):
    tcfg = _tcfg({**CONFIGS, **VARIANTS}[cfg_name])
    pairs = [synthetic_pair(37, 53, shift=(1.0 + i, 2.0 - i), seed=50 + i) for i in range(3)]
    a, b = (_t(np.stack([p[k] for p in pairs])) for k in (0, 1))
    flows = dis_tpu_torch.dis_flow(a, b, tcfg)
    assert flows.shape == (3, 37, 53, 2)
    for i in range(3):
        assert torch.equal(flows[i], dis_tpu_torch.dis_flow(a[i].contiguous(),
                                                            b[i].contiguous(), tcfg)), i


def test_aot_compile_medium_cpu_equals_dis_flow():
    """The ``DIS_MEDIUM`` preset itself (scales 3..0, 5 x 5 sweeps) behind
    a CPU ``aot_compile`` bucket of 2 pairs."""
    cfg = dis_tpu_torch.DIS_MEDIUM
    pairs = [synthetic_pair(40, 56, shift=(2.0, 1.0), seed=60 + i) for i in range(2)]
    a, b = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    got = aot_compile(cfg, 40, 56, batch=2, device="cpu")(a, b)
    assert got.shape == (2, 40, 56, 2) and bool(torch.isfinite(got).all())
    for i in range(2):
        assert torch.equal(got[i], dis_tpu_torch.dis_flow(_t(a[i]), _t(b[i]), cfg)), i
