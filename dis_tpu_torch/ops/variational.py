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
(:func:`refine_planes_plain`), R1 the warp (:func:`refine_warp_plain`'s
taps) in its setup mode, :func:`refine_setup_plain`, which also writes
the weight update's inputs, or in its warp1 mode,
:func:`refine_setup_warp1_plain`, the ``warp1`` scheme's warp, Sobels
and inputs, and R23 one weight update with all its half-sweeps
(:func:`refine_update_plain`: the coefficients of
:func:`refine_weights_plain`, then :func:`refine_sor_plain` a
half-sweep; in its compose mode, the last update of an outer iteration,
:func:`refine_compose_plain` last, which also writes the flow, clipped
where a bound is given); R3 in its no-sweep mode
(:func:`refine_nosweep_plain`) writes the flow of an outer iteration
without a half-sweep.  So a ``planes6`` level of ``DIS_MEDIUM`` makes 7
launches (R0, R1 and five R23).  These plain functions are the kernels'
plain versions: torch ops, which CPU tensors (and ``plain=True``) run.

R23 holds a tile of the planes on chip through its update:
:func:`update_plan` picks the tiles from the level's shape, the pair
count and the sweeps, and :func:`refine_update_tiled` runs the same
tiles through the plain versions, which tests hold bitwise to the
untiled update.  Its bound on the H100 is the halo's repeated work and
the latency of its chain of half-sweeps, not the bytes of the update,
which it reads once and writes once.

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

import functools
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
    in_bounds [(B,) H, W] bool).  R1's warp: its setup and warp1 modes
    (:func:`refine_setup_plain`, :func:`refine_setup_warp1_plain`) take
    their taps from it."""
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
    wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0).  The head of
    R23's plain version (:func:`refine_update_plain`)."""
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
    (du, dv); the other colour's pixels pass through.  A half-sweep of
    R23's plain version (:func:`refine_update_plain`)."""
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
    end of R23's plain version in its compose mode."""
    du, dv = refine_sor_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det,
                              Su0, Sv0, color, omega)
    return refine_nosweep_plain(u0, v0, du, dv, bound)


def refine_nosweep_plain(u0, v0, du, dv, bound: Optional[float] = None) -> torch.Tensor:
    """The flow of an outer iteration that makes no half-sweep (no weight
    update or no SOR sweep): (u0 + du, v0 + dv) [(B,) h, w, 2], clipped to
    [-bound, bound] where ``bound`` is given (as ``jnp.clip`` with a
    float32 bound: NaN passes, -0.0 stays).  The plain version of R3's
    no-sweep mode, and the end of :func:`refine_compose_plain`."""
    flow = torch.stack([u0 + du, v0 + dv], dim=-1)
    return flow if bound is None else flow.clamp(-bound, bound)


def refine_update_plain(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv,
                        alpha: float, delta: float, gamma: float, sweeps: int, omega: float,
                        compose: bool = False, bound: Optional[float] = None):
    """One weight update: :func:`refine_weights_plain`, then ``sweeps``
    red-black SOR sweeps (:func:`refine_sor_plain`, red first).  Returns
    the new (du, dv); where ``compose``, the last half-sweep is
    :func:`refine_compose_plain`'s and the flow [(B,) h, w, 2] is
    returned, clipped to [-bound, bound] where ``bound`` is given.  The
    plain version of kernel R23."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    return _update_launch_plain(ins, du, dv, alpha, delta, gamma, omega, 0, 2 * sweeps,
                                compose, bound)


def _update_launch_plain(ins, du, dv, alpha, delta, gamma, omega, j0: int, nh: int,
                         compose: bool, bound: Optional[float], parity: int = 0):
    """One R23 launch's work: the coefficients from the thirteen ``ins``
    (the update's increments among them), then the update's half-sweeps
    ``j0`` to ``j0 + nh - 1`` (colour ``j & 1``) from ``du`` and ``dv``,
    the last one composing the flow where ``compose``.  ``parity`` is that
    of the planes' first row and column in the whole plane (a tile's)."""
    coef = refine_weights_plain(*ins, alpha, delta, gamma)
    u0, v0 = ins[9:11]
    for j in range(j0, j0 + nh):
        color = (j + parity) & 1
        if compose and j == j0 + nh - 1:
            return refine_compose_plain(u0, v0, du, dv, *coef, color, omega, bound)
        du, dv = refine_sor_plain(u0, v0, du, dv, *coef, color, omega)
    return du, dv


# R23's tiles (csrc/variational.cu): its threads, the pixel pairs (a
# row's pixels 2k and 2k + 1) a thread holds, so the pairs a tile may
# hold, and the H100's multiprocessors.
UPDATE_THREADS = 512
UPDATE_PAIRS = 3
UPDATE_CAPACITY = UPDATE_THREADS * UPDATE_PAIRS
H100_SMS = 132
# The least interior side that a launch's halo leaves a square tile of
# the capacity; more half-sweeps are split over launches.
UPDATE_MIN_INTERIOR = 14
# A block's time beside its tile's pixels, in pixels (update_plan).
UPDATE_BLOCK_COST = 2048


def tile_extent(n: int, inner: int, tiles: int, nh: int) -> int:
    """Rows (or columns) that R23's tiles of ``inner`` interior rows load
    on a plane of ``n``, ``tiles`` of them across it, for ``nh``
    half-sweeps: the interior with its halo (``nh`` before it, ``nh + 1``
    after it, where it is inside the plane), cut at the plane; the same
    formula as the kernel's."""
    return n if tiles == 1 else min(n, inner + (nh + 1) + (nh if tiles > 2 else 0))


def tile_pairs(th: int, tw: int) -> int:
    """The pixel pairs of a tile of ``th`` x ``tw``: its rows' pixels 2k
    and 2k + 1, the last one alone where ``tw`` is odd."""
    return th * ((tw + 1) // 2)


def _splits(n: int):
    """The distinct (tiles, interior) that cut ``n`` rows into tiles of an
    equal interior (the last one shorter)."""
    seen = {}
    for k in range(1, n + 1):
        inner = -(-n // k)
        seen.setdefault(inner, -(-n // inner))
    return [(tiles, inner) for inner, tiles in seen.items()]


@functools.lru_cache(maxsize=None)
def update_plan(nb: int, h: int, w: int, sweeps: int, capacity: int = UPDATE_CAPACITY,
                sms: int = H100_SMS) -> Tuple[Tuple[int, int, int, int], ...]:
    """R23's launches for one weight update of ``sweeps`` SOR sweeps over
    ``nb`` planes of ``h`` x ``w``: (ih, iw, j0, nh) each, tiles of ih x iw
    interior pixels running the half-sweeps ``j0`` to ``j0 + nh - 1``.

    A launch takes at most the half-sweeps whose halo leaves a square tile
    of ``capacity`` pixel pairs an interior of ``UPDATE_MIN_INTERIOR`` (20
    half-sweeps at the H100's capacity), the update's split evenly over as
    few launches as that allows; a plane of at most ``capacity`` pairs may
    instead be one tile, with no halo, for all of them.  Of the tilings
    that fit ``capacity``, a launch takes the one with the least ``waves x
    (tile pixels + UPDATE_BLOCK_COST)``, a wave being ``sms`` blocks (one
    a multiprocessor): small planes take more, smaller tiles, which spread
    over the card, large ones the largest tiles, whose halo repeats the
    least work."""
    total = 2 * sweeps
    if total < 1:
        raise ValueError(f"sweeps must be 1 or more, got {sweeps}")
    side = int((2 * capacity) ** 0.5)
    per = max(1, (side - 1 - UPDATE_MIN_INTERIOR) // 2)
    if tile_pairs(h, w) <= capacity and total > per:
        return ((h, w, 0, total),)
    n = -(-total // per)
    q, r = divmod(total, n)
    out, j0 = [], 0
    for k in range(n):
        nh = q + (k < r)
        best = None
        for ty, ih in _splits(h):
            eh = tile_extent(h, ih, ty, nh)
            for tx, iw in _splits(w):
                ew = tile_extent(w, iw, tx, nh)
                if tile_pairs(eh, ew) > capacity:
                    continue
                waves = -(-nb * ty * tx // sms)
                key = (waves * (eh * ew + UPDATE_BLOCK_COST), nb * ty * tx, -ih)
                best = min(best, (key, ih, iw)) if best else (key, ih, iw)
        if best is None:
            raise ValueError(f"no tile of {capacity} pixel pairs holds {nh} half-sweeps' halo")
        out.append((best[1], best[2], j0, nh))
        j0 += nh
    return tuple(out)


def refine_update_tiled(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv,
                        alpha: float, delta: float, gamma: float, sweeps: int, omega: float,
                        compose: bool = False, bound: Optional[float] = None,
                        capacity: int = UPDATE_CAPACITY, sms: int = H100_SMS,
                        halo: Optional[Tuple[int, int]] = None):
    """:func:`refine_update_plain` as R23 computes it: the launches and
    tiles of :func:`update_plan`, each tile's loaded window (its interior
    and ``halo`` rows and columns before and after it, (nh, nh + 1) by
    default, the kernel's) run through the plain versions on its own, with
    the replicate border at the window's edges, and only its interior
    kept.  Equal to :func:`refine_update_plain` bitwise exactly where the
    halo holds every pixel that a window edge inside the plane reaches."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    nb = Iz.shape[0] if Iz.ndim == 3 else 1
    h, w = Iz.shape[-2:]
    plan = update_plan(nb, h, w, sweeps, capacity, sms)
    for k, (ih, iw, j0, nh) in enumerate(plan):
        last = compose and k == len(plan) - 1
        out = Iz.new_empty(Iz.shape + (2,)) if last else Iz.new_empty((2,) + Iz.shape)
        before, after = (nh, nh + 1) if halo is None else halo
        for r0 in range(0, h, ih):
            y0, y1 = max(0, r0 - before), min(h, r0 + ih + after)
            for c0 in range(0, w, iw):
                x0, x1 = max(0, c0 - before), min(w, c0 + iw + after)
                win = (..., slice(y0, y1), slice(x0, x1))
                got = _update_launch_plain([t[win] for t in ins], du[win], dv[win], alpha,
                                           delta, gamma, omega, j0, nh, last, bound,
                                           (y0 + x0) & 1)
                inner = (..., slice(r0 - y0, min(h, r0 + ih) - y0),
                         slice(c0 - x0, min(w, c0 + iw) - x0))
                dst = (..., slice(r0, r0 + ih), slice(c0, c0 + iw))
                if last:
                    out[dst + (slice(None),)] = got[inner + (slice(None),)]
                else:
                    out[(0,) + dst] = got[0][inner]
                    out[(1,) + dst] = got[1][inner]
        if last:
            return out
        du, dv = out.unbind(0)
    return du, dv


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
    launches R0 once, then each outer iteration R1 once in its setup mode
    (under ``warp1`` in its warp1 mode, and no R0) and R23 once a weight
    update (the last in its compose mode, which writes the flow; an outer
    iteration without a half-sweep launches R3 once in its no-sweep mode
    instead), and runs no torch op;
    ``plain=True`` runs their plain versions on any device.  Returns the
    refined flow, of the shape of ``flow``.
    """
    if plain:
        planes_fn, setup, setup_warp1 = (refine_planes_plain, refine_setup_plain,
                                         refine_setup_warp1_plain)
        update, nosweep = refine_update_plain, refine_nosweep_plain
    else:
        from .cuda import refine_kernel as rk
        planes_fn, setup, setup_warp1 = rk.refine_planes, rk.refine_setup, rk.refine_setup_warp1
        update, nosweep = rk.refine_update, rk.refine_nosweep
    h, w = flow.shape[-3:-1]
    p = cfg.img_padding if pad is None else pad
    warp1 = cfg.refinement_scheme == "warp1"
    if not warp1:
        I1x, I1y, planes = planes_fn(img1_padded, img2_padded, p, h, w)

    alpha = cfg.refinement_alpha
    delta = cfg.refinement_delta
    gamma = cfg.refinement_gamma
    omega = cfg.refinement_omega
    sweeps = cfg.refinement_sor_sweeps
    # Without a half-sweep the weight updates change nothing.
    updates = cfg.refinement_inner_sweeps if sweeps > 0 else 0

    for it in range(cfg.refinement_iters):
        clip = bound if it == cfg.refinement_iters - 1 else None
        flow = flow.contiguous()
        if warp1:
            ins = setup_warp1(img2_padded, flow, img1_padded, p)
        else:
            ins = setup(planes, flow, img1_padded, I1x, I1y, p)
        u0, v0, du, dv = ins[9:]
        composed = None
        for k in range(updates):
            if k == updates - 1:   # the last update's last half-sweep writes the flow
                composed = update(*ins[:11], du, dv, alpha, delta, gamma, sweeps, omega,
                                  True, clip)
            else:
                du, dv = update(*ins[:11], du, dv, alpha, delta, gamma, sweeps, omega)
        # Without a half-sweep (no weight update or no SOR sweep) the flow
        # is u0 + 0 and v0 + 0.
        flow = nosweep(u0, v0, du, dv, clip) if composed is None else composed
    return flow
