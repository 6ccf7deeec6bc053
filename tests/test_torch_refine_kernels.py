"""The refinement's device loop (R0, R1, R23 and R3) on the CPU.

``ops/variational.py`` composes ``variational_refinement`` from the
plain versions of its kernels: R1's warp (``refine_warp_plain``) in its
setup and warp1 modes, R23's weight update (``refine_update_plain``:
``refine_weights_plain``, then ``refine_sor_plain`` a half-sweep), which
CPU tensors run inline and which the ops of
``ops/cuda/refine_kernel.py`` run as their CPU functions.  On
numpy-seeded inputs:

- the composition, inline, through the ops (``ops_on_cpu``) and with
  ``plain=True``, is bitwise the monolithic refinement it replaced (a
  verbatim copy below, ``_oracle_refinement``): both schemes, omega 1.0
  and 1.6, no pair axis and B = 2, planes of 2 and odd rows and columns;
- ``refine_warp_plain`` is bitwise ``dis_tpu``'s ``_warp_bilinear``, at
  1, 2 and odd rows and columns;
- the refinement through the ops is within 1e-4 px max |d| of
  ``dis_tpu``'s (the tolerance of ``tests/test_torch_variational.py``:
  the port's IRLS weight takes a correctly rounded ``0.5 / sqrt``, XLA's
  CPU ``rsqrt`` is not correctly rounded, and the difference grows
  through the sweeps to about 1e-5 px);
- the ops that launch, and F1-F3's, keep their flat schemas; a flow on
  CPU tensors dispatches none of them, and within ``ops_on_cpu`` one R0
  a level, one R1 per outer iteration (in its setup mode) and one R23 per
  weight update (the last of an outer iteration in its compose mode)
  (``tests/test_torch_refine_glue.py`` holds R0, R23's tiles and the
  modes, and runs ``opcheck`` on the ops);
- a CPU export of ``DIS_MEDIUM`` at 64x96 within ``ops_on_cpu`` records
  R0 = 4, R1 = 4, R23 = 20 and F2 = 1 op nodes (its four levels, 5
  weight updates of 5 sweeps each, the intensity levels): under a tenth
  of the 34,478 graph nodes the plain refinement gave (the plain K1
  included); its cost analysis counts each by the package's formulas.

The kernels themselves run on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 1e).
"""

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dis_tpu_torch
from dis_tpu.config import DISConfig as JConfig
from dis_tpu.ops import variational as jvar
from dis_tpu_torch import cost, interop
from dis_tpu_torch.config import DISConfig
from dis_tpu_torch.ops import cuda as kops
from dis_tpu_torch.ops import image as im
from dis_tpu_torch.ops import variational as tvar
from dis_tpu_torch.ops.cuda import frame_kernel as fk
from dis_tpu_torch.ops.cuda import refine_kernel as rk

from torch_threads import one_thread

# (omega, outer iterations, weight updates, SOR sweeps) of the oracle cases.
SWEEPS = {1.0: (2, 3, 2), 1.6: (1, 5, 5)}
SHAPES = [(2, 2), (2, 7), (5, 2), (9, 13), (3, 11)]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


# -- the refinement as it was before the split: a verbatim copy --------------
# (dis_tpu_torch/ops/variational.py before R1-R3; only the function's name
# differs.)

_EPS2_DATA = 1e-2
_EPS2_SMOOTH = 1e-6



def _coords(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column indices [h, 1] and [1, w] as int64, made on the device."""
    return (torch.arange(h, device=device)[:, None],
            torch.arange(w, device=device)[None, :])


def _warp_bilinear(planes: torch.Tensor, flow: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample stacked ``planes`` [(B,) H, W, C] at ``x + flow`` (flow
    [(B,) H, W, 2], edge clamp) with one shared set of four taps (the
    JAX package's ``take4`` route).  Returns (warped [(B,) H, W, C],
    in_bounds [(B,) H, W] bool)."""
    h, w, c = planes.shape[-3:]
    lead = planes.shape[:-3]
    ys, xs = (t.to(torch.float32) for t in _coords(h, w, planes.device))
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    inb = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    fxc = fx.clamp(0.0, w - 1.0)
    fyc = fy.clamp(0.0, h - 1.0)
    x0f = torch.floor(fxc)
    y0f = torch.floor(fyc)
    a = (fxc - x0f)[..., None]
    b = (fyc - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    flat = planes.reshape(*lead, h * w, c)

    def g(yy, xx):
        idx = (yy * w + xx).reshape(*lead, h * w, 1).expand(*lead, h * w, c)
        return flat.gather(-2, idx).reshape(*lead, h, w, c)

    c00, c01 = g(y0, x0), g(y0, x1)
    c10, c11 = g(y1, x0), g(y1, x1)
    out = ((1 - a) * (1 - b) * c00 + a * (1 - b) * c01
           + (1 - a) * b * c10 + a * b * c11)
    return out, inb


def _psi_deriv(s2: torch.Tensor, eps2: float) -> torch.Tensor:
    """Psi'(s^2) = 1 / (2 sqrt(s^2 + eps^2)), the IRLS weight, from the
    correctly rounded root (the JAX package's ``0.5 * rsqrt`` is not
    correctly rounded on its CPU build)."""
    return 0.5 / im.sqrt_f32(s2 + eps2)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """``x`` [(B,) h, w] with a replicated border of one pixel."""
    return im.replicate_pad(x, 1, 1, 1, 1)


def _shift_edge(xp: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbour value at (y + dy, x + dx) with replicate border, read
    from the edge-padded plane ``xp = _edge_pad(x)`` (one pad serves all
    four neighbours)."""
    h, w = xp.shape[-2] - 2, xp.shape[-1] - 2
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _neighbour_sum(x: torch.Tensor, wE, wW, wS, wN) -> torch.Tensor:
    """``wE x(E) + wW x(W) + wS x(S) + wN x(N)``, summed in that order."""
    xp = _edge_pad(x)
    return (wE * _shift_edge(xp, 0, 1) + wW * _shift_edge(xp, 0, -1)
            + wS * _shift_edge(xp, 1, 0) + wN * _shift_edge(xp, -1, 0))


def _oracle_refinement(img1_padded: torch.Tensor, img2_padded: torch.Tensor,
                           flow: torch.Tensor, cfg: DISConfig,
                           pad: Optional[int] = None) -> torch.Tensor:
    """Refine ``flow`` [(B,) h, w, 2] given the level image planes
    [(B,) h + 2 pad, w + 2 pad].

    ``pad`` is the border width to slice off the planes (default
    ``cfg.img_padding``, matching the Q1 pyramid levels; 0 for the
    exact-size intensity planes of ``refinement_planes="intensity"``).
    A leading pair axis runs through every step.  Returns the refined
    flow, of the shape of ``flow``.
    """
    h, w = flow.shape[-3:-1]
    p = cfg.img_padding if pad is None else pad
    I1 = img1_padded[..., p:p + h, p:p + w]
    I2 = img2_padded[..., p:p + h, p:p + w]

    I1x = im.sobel3(I1, "x")
    I1y = im.sobel3(I1, "y")
    warp1 = cfg.refinement_scheme == "warp1"
    if warp1:
        # Only I2 itself is warped; gradients come from Sobel of the
        # warped image (see below).
        planes = I2[..., None]
    else:
        I2x = im.sobel3(I2, "x")
        I2y = im.sobel3(I2, "y")
        I2xx = im.sobel3(I2x, "x")
        I2xy = im.sobel3(I2x, "y")
        I2yy = im.sobel3(I2y, "y")
        planes = torch.stack([I2, I2x, I2y, I2xx, I2xy, I2yy], dim=-1)

    alpha = cfg.refinement_alpha
    delta = cfg.refinement_delta
    gamma = cfg.refinement_gamma
    omega = cfg.refinement_omega
    ys, xs = _coords(h, w, flow.device)
    red = (xs + ys) % 2 == 0
    black = ~red

    for _ in range(cfg.refinement_iters):
        u0 = flow[..., 0]
        v0 = flow[..., 1]
        warped, inb = _warp_bilinear(planes, flow)
        if warp1:
            # Warp only I2, then differentiate the WARPED image and
            # average with I1's gradients (the gradient-averaging
            # linearization of the DIS authors' OpenCV refinement).
            W = warped[..., 0]
            Wxr = im.sobel3(W, "x")
            Wyr = im.sobel3(W, "y")
            Wx = 0.5 * (I1x + Wxr)
            Wy = 0.5 * (I1y + Wyr)
            Iz = W - I1
            Izx = Wxr - I1x
            Izy = Wyr - I1y
            Wxx = im.sobel3(Wx, "x")
            Wxy = im.sobel3(Wx, "y")
            Wyy = im.sobel3(Wy, "y")
        else:
            W, Wx, Wy, Wxx, Wxy, Wyy = warped.unbind(-1)
            Iz = W - I1
            Izx = Wx - I1x
            Izy = Wy - I1y
        m = inb.to(torch.float32)

        du = torch.zeros_like(u0)
        dv = torch.zeros_like(v0)
        for _ in range(cfg.refinement_inner_sweeps):
            # Lagged robust weights.
            r_d = Iz + Wx * du + Wy * dv
            wd = delta * _psi_deriv(r_d * r_d, _EPS2_DATA) * m
            r_gx = Izx + Wxx * du + Wxy * dv
            r_gy = Izy + Wxy * du + Wyy * dv
            wg = gamma * _psi_deriv(r_gx * r_gx + r_gy * r_gy, _EPS2_DATA) * m

            U = u0 + du
            V = v0 + dv
            Up, Vp = _edge_pad(U), _edge_pad(V)
            Ux = _shift_edge(Up, 0, 1) - U
            Uy = _shift_edge(Up, 1, 0) - U
            Vx = _shift_edge(Vp, 0, 1) - V
            Vy = _shift_edge(Vp, 1, 0) - V
            ws_c = alpha * _psi_deriv(Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy,
                                      _EPS2_SMOOTH)

            # Edge weights: average of the endpoint diffusivities.
            wsp = _edge_pad(ws_c)
            wE = 0.5 * (ws_c + _shift_edge(wsp, 0, 1))
            wW = 0.5 * (ws_c + _shift_edge(wsp, 0, -1))
            wS = 0.5 * (ws_c + _shift_edge(wsp, 1, 0))
            wN = 0.5 * (ws_c + _shift_edge(wsp, -1, 0))
            S = wE + wW + wS + wN

            A11 = wd * Wx * Wx + wg * (Wxx * Wxx + Wxy * Wxy) + S
            A12 = wd * Wx * Wy + wg * (Wxy * (Wxx + Wyy))
            A22 = wd * Wy * Wy + wg * (Wxy * Wxy + Wyy * Wyy) + S
            b1c = -(wd * Wx * Iz + wg * (Wxx * Izx + Wxy * Izy))
            b2c = -(wd * Wy * Iz + wg * (Wxy * Izx + Wyy * Izy))
            # Fixed over the sweeps of this weight update (the JAX package
            # writes them inside each half-sweep; the values are the same).
            det = A11 * A22 - A12 * A12
            det = det.masked_fill(det.abs() < 1e-12, 1e-12)
            Su0 = S * u0
            Sv0 = S * v0

            for _ in range(cfg.refinement_sor_sweeps):
                for mask in (red, black):
                    nU = _neighbour_sum(u0 + du, wE, wW, wS, wN)
                    nV = _neighbour_sum(v0 + dv, wE, wW, wS, wN)
                    b1 = b1c + nU - Su0
                    b2 = b2c + nV - Sv0
                    du_new = (A22 * b1 - A12 * b2) / det
                    dv_new = (A11 * b2 - A12 * b1) / det
                    # Block SOR: over-relax the exact 2x2 point solve
                    # (omega = 1 is plain red-black Gauss-Seidel, kept as
                    # the direct assignment).
                    if omega != 1.0:
                        du_new = du + omega * (du_new - du)
                        dv_new = dv + omega * (dv_new - dv)
                    du = torch.where(mask, du_new, du)
                    dv = torch.where(mask, dv_new, dv)
        flow = torch.stack([u0 + du, v0 + dv], dim=-1)
    return flow


# -- inputs --------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _refine_inputs(h, w, pad, batch, seed):
    """Padded planes [(B,) h + 2 pad, w + 2 pad] of 0..255 noise and a flow
    [(B,) h, w, 2] within 2 px."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    shape = lead + (h + 2 * pad, w + 2 * pad)
    i1 = (rng.random(shape) * 255).astype(np.float32)
    i2 = (rng.random(shape) * 255).astype(np.float32)
    flow = ((rng.random(lead + (h, w, 2)) - 0.5) * 4).astype(np.float32)
    return _t(i1), _t(i2), _t(flow)


def _cfg(scheme, omega):
    outer, inner, sor = SWEEPS[omega]
    return DISConfig(mode="fixed", refinement_iters=outer, refinement_inner_sweeps=inner,
                     refinement_sor_sweeps=sor, refinement_omega=omega,
                     refinement_scheme=scheme, refinement_alpha=40.0)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "dis_tpu_torch":
            name = func.name().split("::")[1].split(".")[0]
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# -- the composition against the monolithic refinement --------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("omega", sorted(SWEEPS))
@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
def test_steps_equal_the_monolithic_refinement(scheme, omega, batch, shape):
    """Inline, through the ops' CPU functions and with ``plain=True``, the
    composition of the kernels' plain versions is bitwise the refinement it
    replaced; Q1-level padding (2 px) on the no-batch cases."""
    cfg = _cfg(scheme, omega)
    pad = 2 if batch is None else 0
    i1, i2, flow = _refine_inputs(*shape, pad, batch, seed=shape[0] * 31 + shape[1])
    want = _oracle_refinement(i1, i2, flow, cfg, pad=pad)
    assert tuple(want.shape) == tuple(flow.shape) and bool(torch.isfinite(want).all())
    assert float((want - flow).abs().max()) > 1e-3       # the refinement moved the flow
    with kops.ops_on_cpu():
        routed = tvar.variational_refinement(i1, i2, flow, cfg, pad=pad)
    for got in (tvar.variational_refinement(i1, i2, flow, cfg, pad=pad), routed,
                tvar.variational_refinement(i1, i2, flow, cfg, pad=pad, plain=True)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 9), (2, 2), (7, 1), (13, 17)])
@pytest.mark.parametrize("c", [1, 6])
def test_refine_warp_plain_bitwise_vs_jax(shape, c):
    """R1's plain warp (also on a pair axis) is ``dis_tpu``'s four-tap warp
    bitwise, its mask equal, at 1, 2 and odd rows and columns; flows up to
    4.5 px reach past every edge."""
    rng = np.random.default_rng(sum(shape) * c)
    planes = rng.random((2,) + shape + (c,)).astype(np.float32)
    flow = ((rng.random((2,) + shape + (2,)) - 0.5) * 9).astype(np.float32)
    batched, batched_inb = tvar.refine_warp_plain(_t(planes), _t(flow))
    for i in range(2):
        want, want_inb = jvar._warp_bilinear(jnp.asarray(planes[i]), jnp.asarray(flow[i]))
        got, got_inb = tvar.refine_warp_plain(_t(planes[i]), _t(flow[i]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_inb.numpy(), np.asarray(want_inb))
        assert torch.equal(batched[i], got) and torch.equal(batched_inb[i], got_inb)


def _eager(fn):
    return getattr(fn, "__wrapped__", fn)


@pytest.mark.parametrize("scheme", ["planes6", "warp1"])
def test_refinement_through_the_ops_matches_jax(scheme):
    """``DIS_MEDIUM``'s sweeps (5 x 5, omega 1.6) on 40x56 intensity
    planes, through the ops: within 1e-4 px max |d| of ``dis_tpu``'s
    refinement (see the module docstring for why not bitwise)."""
    jcfg = JConfig(mode="fixed", refinement_iters=1, refinement_inner_sweeps=5,
                   refinement_sor_sweeps=5, refinement_omega=1.6, refinement_scheme=scheme,
                   refinement_alpha=40.0)
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    from scipy.signal import convolve2d

    rng = np.random.default_rng(12)
    k = np.ones((5, 5), np.float32) / 25.0
    i1, i2 = (convolve2d((rng.random((40, 56)) * 255).astype(np.float32), k, mode="same",
                         boundary="symm").astype(np.float32) for _ in range(2))
    flow = ((rng.random((40, 56, 2)) - 0.5) * 4).astype(np.float32)
    want = np.asarray(_eager(jvar.variational_refinement)(
        jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(flow), jcfg, pad=0))
    with kops.ops_on_cpu():
        got = tvar.variational_refinement(_t(i1), _t(i2), _t(flow), tcfg, pad=0).numpy()
    assert np.abs(got - flow).max() > 1e-2
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()


# -- the ops ----------------------------------------------------------------------

def _weights_args(batch, h=6, w=9, seed=4):
    """A weight update's inputs: random planes, a 0/1 mask, increments of
    a few hundredths of a px, and DIS_MEDIUM's alpha, delta, gamma."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)

    def plane(scale=1.0):
        return _t((rng.standard_normal(lead + (h, w)) * scale).astype(np.float32))

    ins = [plane(20.0) for _ in range(3)] + [plane(10.0) for _ in range(5)]
    m = _t((rng.random(lead + (h, w)) < 0.8).astype(np.float32))
    return (*ins, m, plane(2.0), plane(2.0), plane(0.05), plane(0.05), 40.0, 5.0, 10.0)


def _sor_args(batch, color, omega):
    args = _weights_args(batch)
    coef = tvar.refine_weights_plain(*args)
    u0, v0, du, dv = args[9:13]
    return (u0, v0, du, dv, *coef, color, omega)


_UPDATE_SCHEMA = ("(Tensor Iz, Tensor Izx, Tensor Izy, Tensor Wx, Tensor Wy, Tensor Wxx, "
                  "Tensor Wxy, Tensor Wyy, Tensor m, Tensor u0, Tensor v0, Tensor du, "
                  "Tensor dv, float alpha, float delta, float gamma, SymInt sweeps, "
                  "float omega, bool compose, bool clamp=False, float bound=0.) -> Tensor")
# The ops' schemas, which a saved artifact's nodes name: the refinement's
# ops that launch, and F1-F3's.
SCHEMAS = {
    "refine_planes": (rk, "(Tensor img1, Tensor img2, SymInt p, SymInt h, SymInt w) "
                          "-> (Tensor, Tensor)"),
    "refine_setup": (rk, "(Tensor planes, Tensor flow, Tensor img1, Tensor I1x, Tensor I1y, "
                         "SymInt p) -> Tensor"),
    "refine_setup_warp1": (rk, "(Tensor img2, Tensor flow, Tensor img1, SymInt p) -> Tensor"),
    "refine_update": (rk, _UPDATE_SCHEMA),
    "refine_nosweep": (rk, "(Tensor u0, Tensor v0, Tensor du, Tensor dv, bool clamp, "
                           "float bound) -> Tensor"),
    "frame_pad": (fk, "(Tensor img1, Tensor img2, SymInt top, SymInt bottom, SymInt left, "
                      "SymInt right) -> Tensor"),
    "intensity_levels": (fk, "(Tensor img1, Tensor img2, SymInt levels) -> Tensor[]"),
    "frame_finish": (fk, "(Tensor flow, SymInt finest_scale, SymInt top, SymInt left, "
                         "SymInt height, SymInt width) -> Tensor"),
}


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_refine_ops_have_flat_schemas(name):
    """One op per C entry point, of tensors, ints, floats and bools,
    writing nothing in place; its outputs stacked on a leading axis."""
    module, schema = SCHEMAS[name]
    op = getattr(module, f"{name}_op")
    assert str(op._opoverload._schema) == f"dis_tpu_torch::{name}{schema}"
    assert cost.KERNELS[name] in ("R0", "R1", "R23", "R3", "F1", "F2", "F3")


@pytest.mark.parametrize("color", [0, 1])
def test_sor_updates_one_colour(color):
    """A half-sweep changes only pixels of its colour."""
    args = _sor_args(None, color, 1.6)
    du, dv = tvar.refine_sor_plain(*args)
    ys, xs = np.mgrid[0:6, 0:9]
    other = torch.from_numpy((xs + ys) % 2 != color)
    assert torch.equal(du[other], args[2][other]) and torch.equal(dv[other], args[3][other])
    assert bool((du[~other] != args[2][~other]).all())


def test_wrappers_check_their_inputs():
    """Through the ops (the CUDA path's route) a wrapper refuses what its
    kernel does not take: a plane that is not contiguous, a warp of 3
    channels, no SOR sweep, a clip outside the compose mode, float64
    planes."""
    args = _weights_args(None)
    with kops.ops_on_cpu():
        strided = torch.zeros(6, 18)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            rk.refine_nosweep(strided, *args[10:13])
        with pytest.raises(ValueError, match=r"\[h, w, 6\]"):
            rk.refine_setup(torch.zeros(4, 5, 3), torch.zeros(4, 5, 2), torch.zeros(4, 5),
                            torch.zeros(4, 5), torch.zeros(4, 5), 0)
        with pytest.raises(ValueError, match="sweeps"):
            rk.refine_update(*args, 0, 1.6)
        with pytest.raises(ValueError, match="compose"):
            rk.refine_update(*args, 2, 1.6, False, 0.5)
        with pytest.raises(TypeError, match="float32"):
            rk.refine_update(*(a.double() if torch.is_tensor(a) else a for a in args), 2, 1.6)


def test_cpu_tensors_route_inline_and_through_ops():
    """A refinement on CPU tensors dispatches no kernel op; within
    ``ops_on_cpu`` it calls R0 once, R1 (in its setup mode) once per outer
    iteration and R23 once per weight update (the last of each outer
    iteration in its compose mode), with the same bits, and launches
    nothing."""
    cfg = _cfg("planes6", 1.0)          # 2 outer x 3 updates x 2 sweeps
    i1, i2, flow = _refine_inputs(9, 13, 0, 2, seed=5)
    wrappers = (rk.refine_planes, rk.refine_setup, rk.refine_setup_warp1, rk.refine_update,
                rk.refine_nosweep, rk.composed, rk.clamped)
    for w in wrappers:
        w.launches = 0
    with _CountOps() as inline:
        want = tvar.variational_refinement(i1, i2, flow, cfg, pad=0)
    assert inline.calls == {}
    with _CountOps() as routed, kops.ops_on_cpu():
        got = tvar.variational_refinement(i1, i2, flow, cfg, pad=0)
    assert routed.calls == {"refine_planes": 1, "refine_setup": 2, "refine_update": 6}
    assert torch.equal(got, want)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)


def test_cpu_export_records_the_refinement_ops():
    """``DIS_MEDIUM`` at 64x96 traced through the ops (within
    ``ops_on_cpu``, as a CUDA export routes): R1 once per level and R23
    five times, in a program
    a tenth the size of the plain refinement's 34,478 nodes, which runs
    the ops' CPU functions with the eager bits; its cost analysis counts
    each launch by the package's formulas."""
    from dis_tpu_torch.models.dis import flow_plans
    from dis_tpu_torch.serving import _Flow

    cfg, h, w = dis_tpu_torch.DIS_MEDIUM, 64, 96
    levels = cfg.coarsest_scale - cfg.finest_scale + 1
    flow_plans(cfg, h, w, torch.device("cpu"))
    with kops.ops_on_cpu():
        program = torch.export.export(_Flow(cfg), (torch.zeros(h, w), torch.zeros(h, w)))
    assert cost.kernel_ops(program) == {"K3": 2, "K2": 0, "K2c": 0, "K1": levels,
                                        "R0": levels, "R1": levels, "R23": 5 * levels,
                                        "S1": levels, "S3": levels, "S4": levels, "F2": 1}
    assert len(program.graph.nodes) < 34_478 // 10, len(program.graph.nodes)
    assert not any(n.target is torch.ops.aten.gather.default for n in program.graph.nodes)
    from conftest import synthetic_pair

    a, b = (torch.from_numpy(x) for x in synthetic_pair(h, w))
    assert torch.equal(program.module()(a, b), dis_tpu_torch.dis_flow(a, b, cfg))

    kernels = cost.flow_cost(cfg, h, w)["kernels"]
    assert {k: len(v) for k, v in kernels.items()} == cost.kernel_ops(program)
    want_r23 = []
    entry = lambda k, i: (kernels[k][i]["bytes accessed"], kernels[k][i]["flops"])
    for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        hs, ws = h >> s, w >> s
        i = cfg.coarsest_scale - s
        assert entry("R0", i) == cost.refine_planes_cost(1, hs, ws)
        assert entry("R1", i) == cost.refine_setup_cost(1, hs, ws)
        want_r23 += [cost.refine_update_cost(1, hs, ws, 5, True, k == 4) for k in range(5)]
    assert [(e["bytes accessed"], e["flops"]) for e in kernels["R23"]] == want_r23
    assert entry("F2", 0) == cost.intensity_levels_cost(1, h, w, cfg.coarsest_scale)
    # The coefficients' and the half-sweeps' operations, each plane read
    # or written once
    bytes_r2, ops_r2 = cost.refine_weights_cost(1, 8, 12)
    assert kernels["R23"][0]["bytes accessed"] == bytes_r2 * 15 // 25
    assert kernels["R23"][0]["flops"] == ops_r2 + sum(
        cost.refine_sor_cost(1, 8, 12, j & 1, True)[1] for j in range(10))


def test_refine_wrappers_refuse_non_cuda_non_cpu_tensors():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused before any build or launch."""
    z = lambda *s: torch.zeros(s, device="meta")
    wrappers = (rk.refine_setup, rk.refine_update, rk.refine_nosweep)
    for w in wrappers:
        w.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        rk.refine_setup(z(4, 5, 6), z(4, 5, 2), z(6, 7), z(4, 5), z(4, 5), 1)
    with pytest.raises(ValueError, match="CUDA"):
        rk.refine_update(*(z(4, 5) for _ in rk.WEIGHT_INPUTS), 40.0, 5.0, 10.0, 2, 1.6)
    with pytest.raises(ValueError, match="CUDA"):
        rk.refine_nosweep(*(z(4, 5) for _ in rk.NOSWEEP_INPUTS))
    assert [w.launches for w in wrappers] == [0, 0, 0]
