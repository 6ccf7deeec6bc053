"""Variational refinement of the densified flow field; counterpart of
``dis_tpu/ops/variational.py``.

The DIS paper (Kroeger et al., ECCV 2016, sec. 3.3) refines the
patch-densified flow with the Brox-style energy

    E(U) = int  delta * Psi(|I2(x+U) - I1(x)|^2)
              + gamma * Psi(|grad I2(x+U) - grad I1(x)|^2)
              + alpha * Psi(|grad u|^2 + |grad v|^2)

with Psi(s^2) = sqrt(s^2 + eps^2): ``refinement_iters`` outer warps, per
warp ``refinement_inner_sweeps`` lagged robust-weight updates, per update
``refinement_sor_sweeps`` red-black block-SOR sweeps with factor
``refinement_omega``, each a pair of masked half-sweeps over the whole
plane.  No TPU kernel backs it: the JAX package writes it as elementwise
code that XLA fuses.  Here :func:`variational_refinement` is a Python
loop over a few steps, each one kernel on CUDA tensors
(``ops/cuda/refine_kernel.py``, ``csrc/refine_planes.cu`` and
``csrc/variational.cu``): R0 the level's Sobel planes
(:func:`refine_planes_plain`), R1 the warp (:func:`refine_warp_plain`; in
its setup mode, :func:`refine_setup_plain`, also the weight update's
inputs, and in its warp1 mode, :func:`refine_setup_warp1_plain`, the
``warp1`` scheme's warp, Sobels and inputs), R2 one weight update
(:func:`refine_weights_plain`) and R3 one half-sweep
(:func:`refine_sor_plain`; in its compose mode,
:func:`refine_compose_plain`, the last one, which also writes the flow,
clipped where a bound is given; in its no-sweep mode,
:func:`refine_nosweep_plain`, the flow of an outer iteration without a
half-sweep).  These plain functions are the kernels' plain versions:
torch ops, which CPU tensors (and ``plain=True``) run.

Every expression keeps the JAX package's order of operations, and each
step is its own op, so no multiply-add is contracted.  Where the JAX
package takes ``rsqrt`` (not correctly rounded in XLA's CPU build), the
IRLS weight here is ``0.5 / sqrt_f32(s2 + eps2)``, correctly rounded on
every device.  The refinement has no reduction, so a call gives the same
bits on the CPU and on the card, through the kernels or not, a pair of a
batch the bits it gets alone, and a tiled flow the bits of the untiled
one; it agrees with the JAX package to about 1e-5 px.  It reads no device
value on the host and copies nothing from it, so a CUDA graph can capture
it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DISConfig
from . import image as im

# Charbonnier epsilon^2 per term (copy of the JAX package's values): the
# data and gradient terms are in 0..255 intensity units (eps 0.1), the
# smoothness term in px.
_EPS2_DATA = 1e-2
_EPS2_SMOOTH = 1e-6


def _coords(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column indices [h, 1] and [1, w] as int64, made on the device."""
    return (torch.arange(h, device=device)[:, None],
            torch.arange(w, device=device)[None, :])


def refine_warp_plain(planes: torch.Tensor, flow: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample stacked ``planes`` [(B,) H, W, C] at ``x + flow`` (flow
    [(B,) H, W, 2], edge clamp) with one shared set of four taps (the
    JAX package's ``take4`` route).  Returns (warped [(B,) H, W, C],
    in_bounds [(B,) H, W] bool).  The plain version of kernel R1."""
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


def refine_weights_plain(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv,
                         alpha: float, delta: float, gamma: float):
    """One lagged weight update from the increments ``du``, ``dv`` (every
    plane [(B,) h, w]): the robust data and gradient weights, the
    smoothness diffusivity and its four edge weights, and the 2x2 system
    of each pixel, fixed over the SOR sweeps that follow.  Returns (wE,
    wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0).  The plain
    version of kernel R2."""
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
    ws_c = alpha * _psi_deriv(Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy, _EPS2_SMOOTH)

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
    # Fixed over the sweeps of this weight update (the JAX package writes
    # them inside each half-sweep; the values are the same).
    det = A11 * A22 - A12 * A12
    det = det.masked_fill(det.abs() < 1e-12, 1e-12)
    return wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, S * u0, S * v0


def refine_sor_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det,
                     Su0, Sv0, color: int, omega: float):
    """One masked half-sweep of red-black block SOR over the pixels of
    ``color`` (0: red, ``(x + y) % 2 == 0``; 1: black): the exact 2x2
    point solve of each, over-relaxed by ``omega`` (``omega == 1`` is
    plain Gauss-Seidel, kept as the direct assignment).  Returns the new
    (du, dv); the other colour's pixels pass through.  The plain version
    of kernel R3."""
    ys, xs = _coords(*du.shape[-2:], du.device)
    mask = (xs + ys) % 2 == color
    nU = _neighbour_sum(u0 + du, wE, wW, wS, wN)
    nV = _neighbour_sum(v0 + dv, wE, wW, wS, wN)
    b1 = b1c + nU - Su0
    b2 = b2c + nV - Sv0
    du_new = (A22 * b1 - A12 * b2) / det
    dv_new = (A11 * b2 - A12 * b1) / det
    if omega != 1.0:
        du_new = du + omega * (du_new - du)
        dv_new = dv + omega * (dv_new - dv)
    return torch.where(mask, du_new, du), torch.where(mask, dv_new, dv)


def refine_planes_plain(img1: torch.Tensor, img2: torch.Tensor, p: int, h: int, w: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Sobel planes of one refinement level (``planes6``): I1 and I2
    are the windows [(B,) h, w] at offset ``p`` of the planes ``img1`` and
    ``img2`` [(B,) H, W].  Returns (I1x, I1y, planes [(B,) h, w, 6]), the
    stack ``[I2, I2x, I2y, I2xx, I2xy, I2yy]`` that R1 warps; the second
    Sobels reflect the first Sobel planes at the border (reflect-101 as
    ``np.pad`` reflects: a window of one row or column repeats it).  The
    plain version of kernel R0."""
    I1 = img1[..., p:p + h, p:p + w]
    I2 = img2[..., p:p + h, p:p + w]
    I1x = im.sobel3(I1, "x")
    I1y = im.sobel3(I1, "y")
    I2x = im.sobel3(I2, "x")
    I2y = im.sobel3(I2, "y")
    I2xx = im.sobel3(I2x, "x")
    I2xy = im.sobel3(I2x, "y")
    I2yy = im.sobel3(I2y, "y")
    return I1x, I1y, torch.stack([I2, I2x, I2y, I2xx, I2xy, I2yy], dim=-1)


def refine_setup_plain(planes: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor,
                       I1x: torch.Tensor, I1y: torch.Tensor, p: int):
    """The warp of an outer iteration (``planes6``) and the weight
    update's thirteen inputs made from it: (Iz, Izx, Izy, Wx, Wy, Wxx,
    Wxy, Wyy, m, u0, v0, du, dv), every plane [(B,) h, w], in the order of
    :func:`refine_weights_plain`'s arguments.  ``planes`` and ``flow`` are
    R1's; I1 is the window of ``img1`` at offset ``p``; the mask ``m`` is
    1.0 where the warp fell inside the plane, u0 and v0 the flow's
    components and du = dv = 0.  The plain version of R1's setup mode."""
    h, w = flow.shape[-3:-1]
    I1 = img1[..., p:p + h, p:p + w]
    u0, v0 = flow.unbind(-1)
    warped, inb = refine_warp_plain(planes, flow)
    W, Wx, Wy, Wxx, Wxy, Wyy = warped.unbind(-1)
    return (W - I1, Wx - I1x, Wy - I1y, Wx, Wy, Wxx, Wxy, Wyy, inb.to(torch.float32),
            u0, v0, torch.zeros_like(u0), torch.zeros_like(v0))


def refine_setup_warp1_plain(img2: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor,
                             p: int):
    """The warp of an outer iteration under the ``warp1`` scheme and the
    weight update's thirteen inputs made from it, every plane [(B,) h, w]
    in the order of :func:`refine_weights_plain`'s arguments.  I1 and I2
    are the windows at offset ``p`` of ``img1`` and ``img2`` [(B,) H, W];
    only I2 is warped (at ``x + flow``, R1's taps), and the gradients come
    from the Sobels of the warped image W, averaged with I1's (the
    gradient-averaging linearization of the DIS authors' OpenCV
    refinement): Wx = 0.5 (I1x + sobel(W)), the second Sobels of those
    means, Iz = W - I1, Izx and Izy the first Sobels' differences, the
    mask, u0, v0 and du = dv = 0.  The plain version of R1's warp1 mode."""
    h, w = flow.shape[-3:-1]
    I1 = img1[..., p:p + h, p:p + w]
    I1x = im.sobel3(I1, "x")
    I1y = im.sobel3(I1, "y")
    u0, v0 = flow.unbind(-1)
    warped, inb = refine_warp_plain(img2[..., p:p + h, p:p + w][..., None], flow)
    W = warped[..., 0]
    Wxr = im.sobel3(W, "x")
    Wyr = im.sobel3(W, "y")
    Wx = 0.5 * (I1x + Wxr)
    Wy = 0.5 * (I1y + Wyr)
    Wxx = im.sobel3(Wx, "x")
    Wxy = im.sobel3(Wx, "y")
    Wyy = im.sobel3(Wy, "y")
    return (W - I1, Wxr - I1x, Wyr - I1y, Wx, Wy, Wxx, Wxy, Wyy, inb.to(torch.float32),
            u0, v0, torch.zeros_like(u0), torch.zeros_like(v0))


def refine_compose_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det,
                         Su0, Sv0, color: int, omega: float,
                         bound: Optional[float] = None) -> torch.Tensor:
    """The last half-sweep of an outer iteration and the flow it leaves:
    [(B,) h, w, 2] = (u0 + du, v0 + dv), du and dv the half-sweep's new
    increments, clipped to [-bound, bound] where ``bound`` is given.  The
    plain version of R3's compose mode."""
    du, dv = refine_sor_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det,
                              Su0, Sv0, color, omega)
    return refine_nosweep_plain(u0, v0, du, dv, bound)


def refine_nosweep_plain(u0, v0, du, dv, bound: Optional[float] = None) -> torch.Tensor:
    """The flow of an outer iteration that makes no half-sweep (no weight
    update or no SOR sweep): (u0 + du, v0 + dv) [(B,) h, w, 2], clipped to
    [-bound, bound] where ``bound`` is given (as ``jnp.clip`` with a
    float32 bound: NaN passes, -0.0 stays).  The plain version of R3's
    no-sweep mode, and the end of its compose mode's."""
    flow = torch.stack([u0 + du, v0 + dv], dim=-1)
    return flow if bound is None else flow.clamp(-bound, bound)


def variational_refinement(img1_padded: torch.Tensor, img2_padded: torch.Tensor,
                           flow: torch.Tensor, cfg: DISConfig,
                           pad: Optional[int] = None, plain: bool = False,
                           bound: Optional[float] = None) -> torch.Tensor:
    """Refine ``flow`` [(B,) h, w, 2] given the level image planes
    [(B,) h + 2 pad, w + 2 pad].

    ``pad`` is the border width to slice off the planes (default
    ``cfg.img_padding``, matching the Q1 pyramid levels; 0 for the
    exact-size intensity planes of ``refinement_planes="intensity"``).
    Where ``bound`` is given, the last outer iteration clips the flow it
    writes to [-bound, bound] (``refined_init_clamp``).  A leading pair
    axis runs through every step.  On CUDA tensors the ``planes6`` scheme
    launches R0 once, each outer iteration R1 once (in its setup mode;
    under ``warp1`` in its warp1 mode, and no R0), each weight update R2
    once and each half-sweep R3 once (the last in its compose mode, which
    writes the flow; an outer iteration without a half-sweep launches R3
    once in its no-sweep mode instead), and runs no torch op;
    ``plain=True`` runs their plain versions on any device.  Returns the
    refined flow, of the shape of ``flow``.
    """
    if plain:
        planes_fn, setup, setup_warp1 = (refine_planes_plain, refine_setup_plain,
                                         refine_setup_warp1_plain)
        weights, sor, compose, nosweep = (refine_weights_plain, refine_sor_plain,
                                          refine_compose_plain, refine_nosweep_plain)
    else:
        from .cuda import refine_kernel as rk
        planes_fn, setup, setup_warp1 = rk.refine_planes, rk.refine_setup, rk.refine_setup_warp1
        weights, sor, compose, nosweep = (rk.refine_weights, rk.refine_sor, rk.refine_compose,
                                          rk.refine_nosweep)
    h, w = flow.shape[-3:-1]
    p = cfg.img_padding if pad is None else pad
    warp1 = cfg.refinement_scheme == "warp1"
    if not warp1:
        I1x, I1y, planes = planes_fn(img1_padded, img2_padded, p, h, w)

    alpha = cfg.refinement_alpha
    delta = cfg.refinement_delta
    gamma = cfg.refinement_gamma
    omega = cfg.refinement_omega
    last = (cfg.refinement_inner_sweeps - 1, cfg.refinement_sor_sweeps - 1)

    for it in range(cfg.refinement_iters):
        clip = bound if it == cfg.refinement_iters - 1 else None
        flow = flow.contiguous()
        if warp1:
            ins = setup_warp1(img2_padded, flow, img1_padded, p)
        else:
            ins = setup(planes, flow, img1_padded, I1x, I1y, p)
        u0, v0, du, dv = ins[9:]
        composed = None
        for k in range(cfg.refinement_inner_sweeps):
            coef = weights(*ins[:11], du, dv, alpha, delta, gamma)
            for s in range(cfg.refinement_sor_sweeps):
                du, dv = sor(u0, v0, du, dv, *coef, 0, omega)   # red
                if (k, s) == last:   # black, and the flow
                    composed = compose(u0, v0, du, dv, *coef, 1, omega, clip)
                else:
                    du, dv = sor(u0, v0, du, dv, *coef, 1, omega)
        # Without a half-sweep (no weight update or no SOR sweep) the flow
        # is u0 + 0 and v0 + 0.
        flow = nosweep(u0, v0, du, dv, clip) if composed is None else composed
    return flow
