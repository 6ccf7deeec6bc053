"""R0-R3: the variational refinement's device loop (``csrc/refine_planes.cu``,
``csrc/variational.cu``).

No Pallas kernel backs them: the JAX package writes the refinement as
elementwise code (``dis_tpu/ops/variational.py``) that XLA fuses into a
few loops per half-sweep.  They replace those fusions, one launch per
step of ``ops/variational.py::variational_refinement``:

- R0 :func:`refine_planes`, a level's Sobel planes (``planes6``): I1x,
  I1y and the six planes R1 warps (:188-204 there), once per level;
- R1 :func:`refine_warp`, the bilinear warp of C = 1 or 6 planes
  (``_warp_bilinear`` there), once per outer iteration; in its setup mode,
  :func:`refine_setup` (``planes6``), it also writes R2's thirteen inputs
  (:220-250 and :312 there: the differences to I1, the mask, u0 and v0,
  du = dv = 0); in its warp1 mode, :func:`refine_setup_warp1` (``warp1``,
  R1w), it warps I2 alone and writes the same thirteen inputs from the
  Sobels of the warped plane and of I1 (:191-197 and :223-242 there);
- R2 :func:`refine_weights`, one lagged weight update with its 2x2
  systems (the head of ``inner``), once per update;
- R3 :func:`refine_sor`, one red or black half-sweep (``half_sweep``),
  twice per SOR sweep; in its compose mode, :func:`refine_compose`, the
  last half-sweep of an outer iteration, which writes the flow (u0 + du,
  v0 + dv) (:314 there), clipped to a bound where one is given
  (``refined_init_clamp``, ``dis_tpu/models/dis.py:101-103``); in its
  no-sweep mode, :func:`refine_nosweep`, that flow of an outer iteration
  that makes no half-sweep, with the same clip.

Each is bound by bytes on the H100: one thread per pixel (R0 and R1w a
tile of them, staged in shared memory), the planes read and written in
coalesced rows, the stencils' neighbours from cache.  Their plain
versions are ``refine_planes_plain``, ``refine_warp_plain``,
``refine_setup_plain``, ``refine_setup_warp1_plain``,
``refine_weights_plain``, ``refine_sor_plain``, ``refine_compose_plain``
and ``refine_nosweep_plain`` of ``ops/variational.py``; each kernel keeps
their operations and rounding, so it equals them bitwise.

The ops return new tensors, stacked along a leading axis where there are
several: R0's I1x and I1y [2, (B,) h, w] and its planes [(B,) h, w, 6];
R1's warped planes [C, (B,) h, w] (the wrapper hands them back as
[(B,) h, w, C], a view whose planes stay contiguous for R2) and its mask,
or in its setup and warp1 modes R2's thirteen inputs [13, (B,) h, w];
R2's twelve planes [12, (B,) h, w]; R3's new du and dv [2, (B,) h, w],
or in its compose and no-sweep modes the flow [(B,) h, w, 2].  So
``torch.export`` and CUDA graphs need no handling of mutation.  A mode's
launch counts in its kernel's ``launches`` (R1's, R3's) and in its own
wrapper's; R3's clip, a flag of its compose and no-sweep modes, also in
``clamped.launches``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from ... import _build
from ..variational import (refine_compose_plain, refine_nosweep_plain, refine_planes_plain,
                           refine_setup_plain, refine_setup_warp1_plain, refine_sor_plain,
                           refine_warp_plain, refine_weights_plain)
from . import all_on_cpu, check_input, dispatch, launched, register

WARP_CHANNELS = (1, 6)   # the kernel's instances: warp1 and planes6
WEIGHT_INPUTS = ("Iz", "Izx", "Izy", "Wx", "Wy", "Wxx", "Wxy", "Wyy", "m", "u0", "v0",
                 "du", "dv")
WEIGHT_OUTPUTS = 12
SOR_INPUTS = ("u0", "v0", "du", "dv", "wE", "wW", "wS", "wN", "A11", "A12", "A22", "b1c",
              "b2c", "det", "Su0", "Sv0")
MAX_PIXELS = 2 ** 31 - 256   # the kernels' 1-D grid of nb * h * w threads
MAX_PLANES = 65535           # R0's and R1w's gridDim.z
T = torch.Tensor             # the ops' schemas come from these annotations


def _plane_dims(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """(nb, h, w) of a plane [h, w] or a batch of planes [B, h, w]."""
    if t.ndim not in (2, 3):
        raise ValueError(f"{name} must be [h, w] or [B, h, w], got {tuple(t.shape)}")
    nb = t.shape[0] if t.ndim == 3 else 1
    h, w = t.shape[-2:]
    if not (nb >= 1 and h >= 1 and w >= 1 and nb * h * w <= MAX_PIXELS):
        raise ValueError(f"{name}: {nb} planes of {h}x{w}; the kernels take 1 to "
                         f"{MAX_PIXELS} pixels")
    return nb, h, w


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


# -- R0: the level's Sobel planes -----------------------------------------------

def refine_planes(img1: torch.Tensor, img2: torch.Tensor, p: int, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(I1x, I1y [(B,) h, w], planes [(B,) h, w, 6]) of the windows [h, w]
    at offset ``p`` of the level planes ``img1`` and ``img2`` [(B,) H, W]
    (``planes6``).  One launch of R0."""
    if all_on_cpu(img1, img2):
        return refine_planes_plain(img1, img2, p, h, w)
    if img1.ndim not in (2, 3):
        raise ValueError(f"img1 must be [H, W] or [B, H, W], got {tuple(img1.shape)}")
    nb, (ih, iw) = (img1.shape[0] if img1.ndim == 3 else 1), img1.shape[-2:]
    if not (1 <= nb <= MAX_PLANES and nb * h * w <= MAX_PIXELS):
        raise ValueError(f"{nb} planes of {h}x{w}: the kernel takes 1 to {MAX_PLANES} "
                         f"planes and {MAX_PIXELS} pixels")
    if h < 1 or w < 1:
        raise ValueError(f"a window of {h}x{w}: the kernel takes 1 or more rows and "
                         "columns")
    if p < 0 or p + h > ih or p + w > iw:
        raise ValueError(f"the window [{h}, {w}] at offset {p} is outside the planes "
                         f"[{ih}, {iw}]")
    dev = img1.device
    check_input(img1, "img1", dev, torch.float32, img1.shape)
    check_input(img2, "img2", dev, torch.float32, img1.shape)
    grads, planes = dispatch(refine_planes_op, _planes_cuda, dev, img1, img2, p, h, w)
    return (*grads.unbind(0), planes)


def _planes_empty(img1: torch.Tensor, img2: torch.Tensor, p: int, h: int, w: int):
    lead = tuple(img1.shape[:-2])
    return img1.new_empty((2,) + lead + (h, w)), img1.new_empty(lead + (h, w, 6))


def _planes_cuda(img1: T, img2: T, p: int, h: int, w: int) -> Tuple[T, T]:
    """R0 on checked inputs: I1x and I1y [2, (B,) h, w] and the planes."""
    grads, planes = _planes_empty(img1, img2, p, h, w)
    nb = img1.shape[0] if img1.ndim == 3 else 1
    _build.launch("dis_refine_planes", img1.device, img1.data_ptr(), img2.data_ptr(), nb,
                  *img1.shape[-2:], p, h, w, grads.data_ptr(), planes.data_ptr())
    launched("refine_planes", "R0", refine_planes)
    return grads, planes


def _planes_cpu(img1, img2, p, h, w):
    I1x, I1y, planes = refine_planes_plain(img1, img2, p, h, w)
    return torch.stack([I1x, I1y]), planes


# -- R1: the warp --------------------------------------------------------------

def refine_warp(planes: torch.Tensor, flow: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(warped [(B,) h, w, C], in_bounds [(B,) h, w] bool): ``planes``
    [(B,) h, w, C] sampled at ``x + flow`` (flow [(B,) h, w, 2]) with edge
    clamp.  One launch of R1."""
    if all_on_cpu(planes, flow):
        return refine_warp_plain(planes, flow)
    if planes.ndim not in (3, 4):
        raise ValueError(f"planes must be [h, w, C] or [B, h, w, C], got {tuple(planes.shape)}")
    c = planes.shape[-1]
    if c not in WARP_CHANNELS:
        raise ValueError(f"planes has {c} channels; the kernel takes {WARP_CHANNELS}")
    _plane_dims(planes[..., 0], "planes")
    dev = planes.device
    check_input(planes, "planes", dev, torch.float32, planes.shape)
    check_input(flow, "flow", dev, torch.float32, planes.shape[:-1] + (2,))
    warped, inb = dispatch(refine_warp_op, _warp_cuda, dev, planes, flow)
    return warped.movedim(0, -1), inb


def _warp_empty(planes: torch.Tensor, flow: torch.Tensor):
    lead_hw = tuple(planes.shape[:-1])
    return (planes.new_empty((planes.shape[-1],) + lead_hw),
            torch.empty(lead_hw, dtype=torch.bool, device=planes.device))


def _warp_cuda(planes: T, flow: T) -> Tuple[T, T]:
    """R1 on checked inputs: the warped planes [C, (B,) h, w] and the mask."""
    out, inb = _warp_empty(planes, flow)
    nb, h, w = _plane_dims(planes[..., 0], "planes")
    _build.launch("dis_refine_warp", planes.device, planes.data_ptr(), flow.data_ptr(),
                  nb, h, w, planes.shape[-1], out.data_ptr(), inb.data_ptr())
    launched("refine_warp", "R1", refine_warp)
    return out, inb


def _warp_cpu(planes: torch.Tensor, flow: torch.Tensor):
    warped, inb = refine_warp_plain(planes, flow)
    return torch.stack(warped.unbind(-1)), inb


def refine_setup(planes: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor,
                 I1x: torch.Tensor, I1y: torch.Tensor, p: int):
    """R2's thirteen inputs (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0,
    du, dv), every plane [(B,) h, w]: ``planes`` [(B,) h, w, 6] warped at
    ``x + flow``, less I1 (the window at offset ``p`` of ``img1``), I1x and
    I1y.  One launch of R1 in its setup mode."""
    if all_on_cpu(planes, flow, img1, I1x, I1y):
        return refine_setup_plain(planes, flow, img1, I1x, I1y, p)
    if planes.ndim not in (3, 4) or planes.shape[-1] != 6:
        raise ValueError(f"planes must be [h, w, 6] or [B, h, w, 6], got "
                         f"{tuple(planes.shape)}")
    lead, (h, w) = tuple(planes.shape[:-3]), planes.shape[-3:-1]
    _plane_dims(planes[..., 0], "planes")
    if img1.ndim != planes.ndim - 1 or p < 0 or p + h > img1.shape[-2] or \
            p + w > img1.shape[-1]:
        raise ValueError(f"img1 {tuple(img1.shape)} holds no window [{h}, {w}] at offset {p}")
    dev = planes.device
    check_input(planes, "planes", dev, torch.float32, planes.shape)
    check_input(flow, "flow", dev, torch.float32, planes.shape[:-1] + (2,))
    check_input(img1, "img1", dev, torch.float32, lead + tuple(img1.shape[-2:]))
    for t, name in ((I1x, "I1x"), (I1y, "I1y")):
        check_input(t, name, dev, torch.float32, planes.shape[:-1])
    return dispatch(refine_setup_op, _setup_cuda, dev, planes, flow, img1, I1x, I1y,
                    p).unbind(0)


def _setup_empty(planes, flow, img1, I1x, I1y, p):
    return planes.new_empty((len(WEIGHT_INPUTS),) + tuple(planes.shape[:-1]))


def _setup_cuda(planes: T, flow: T, img1: T, I1x: T, I1y: T, p: int) -> T:
    """R1's setup mode on checked inputs: R2's inputs [13, (B,) h, w]."""
    out = _setup_empty(planes, flow, img1, I1x, I1y, p)
    nb, h, w = _plane_dims(planes[..., 0], "planes")
    _build.launch("dis_refine_setup", planes.device, planes.data_ptr(), flow.data_ptr(),
                  img1.data_ptr(), I1x.data_ptr(), I1y.data_ptr(), nb, h, w,
                  *img1.shape[-2:], p, out.data_ptr())
    launched("refine_setup", "R1s", refine_warp, refine_setup)
    return out


def _setup_cpu(planes, flow, img1, I1x, I1y, p):
    return torch.stack(refine_setup_plain(planes, flow, img1, I1x, I1y, p))


def refine_setup_warp1(img2: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor, p: int):
    """R2's thirteen inputs under the ``warp1`` scheme, every plane
    [(B,) h, w]: I2, the window at offset ``p`` of ``img2`` [(B,) H, W],
    warped at ``x + flow`` (flow [(B,) h, w, 2]), its Sobels averaged with
    those of I1 (the window of ``img1``), and their second Sobels.  One
    launch of R1 in its warp1 mode (R1w)."""
    if all_on_cpu(img2, flow, img1):
        return refine_setup_warp1_plain(img2, flow, img1, p)
    if flow.ndim not in (3, 4) or flow.shape[-1] != 2:
        raise ValueError(f"flow must be [h, w, 2] or [B, h, w, 2], got {tuple(flow.shape)}")
    nb, h, w = _plane_dims(flow[..., 0], "flow")
    if nb > MAX_PLANES:
        raise ValueError(f"{nb} planes: the kernel takes 1 to {MAX_PLANES}")
    if img2.ndim != flow.ndim - 1 or p < 0 or p + h > img2.shape[-2] or \
            p + w > img2.shape[-1]:
        raise ValueError(f"img2 {tuple(img2.shape)} holds no window [{h}, {w}] at offset {p}")
    dev = flow.device
    check_input(flow, "flow", dev, torch.float32, flow.shape)
    check_input(img2, "img2", dev, torch.float32, flow.shape[:-3] + tuple(img2.shape[-2:]))
    check_input(img1, "img1", dev, torch.float32, img2.shape)
    return dispatch(refine_setup_warp1_op, _setup_warp1_cuda, dev, img2, flow, img1,
                    p).unbind(0)


def _setup_warp1_empty(img2, flow, img1, p):
    return flow.new_empty((len(WEIGHT_INPUTS),) + tuple(flow.shape[:-1]))


def _setup_warp1_cuda(img2: T, flow: T, img1: T, p: int) -> T:
    """R1's warp1 mode on checked inputs: R2's inputs [13, (B,) h, w]."""
    out = _setup_warp1_empty(img2, flow, img1, p)
    nb, h, w = _plane_dims(flow[..., 0], "flow")
    _build.launch("dis_refine_setup_warp1", flow.device, img1.data_ptr(), img2.data_ptr(),
                  flow.data_ptr(), nb, *img2.shape[-2:], p, h, w, out.data_ptr())
    launched("refine_setup_warp1", "R1w", refine_warp, refine_setup_warp1)
    return out


def _setup_warp1_cpu(img2, flow, img1, p):
    return torch.stack(refine_setup_warp1_plain(img2, flow, img1, p))


# -- R2: one weight update -------------------------------------------------------

def refine_weights(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv,
                   alpha: float, delta: float, gamma: float):
    """(wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0), every
    plane [(B,) h, w]: one lagged weight update.  One launch of R2."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    if all_on_cpu(*ins):
        return refine_weights_plain(*ins, alpha, delta, gamma)
    _plane_dims(Iz, "Iz")
    dev = Iz.device
    for t, name in zip(ins, WEIGHT_INPUTS):
        check_input(t, name, dev, torch.float32, Iz.shape)
    return dispatch(refine_weights_op, _weights_cuda, dev, *ins, alpha, delta,
                    gamma).unbind(0)


def _weights_empty(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv, alpha, delta,
                   gamma):
    return Iz.new_empty((WEIGHT_OUTPUTS,) + tuple(Iz.shape))


def _weights_cuda(Iz: T, Izx: T, Izy: T, Wx: T, Wy: T, Wxx: T, Wxy: T, Wyy: T, m: T, u0: T,
                  v0: T, du: T, dv: T, alpha: float, delta: float, gamma: float) -> T:
    """R2 on checked inputs: the twelve planes [12, (B,) h, w]."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    out = _weights_empty(*ins, alpha, delta, gamma)
    nb, h, w = _plane_dims(Iz, "Iz")
    _build.launch("dis_refine_weights", Iz.device, _pointers(ins), nb, h, w, alpha, delta,
                  gamma, out.data_ptr())
    launched("refine_weights", "R2", refine_weights)
    return out


def _weights_cpu(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv, alpha, delta,
                 gamma):
    return torch.stack(refine_weights_plain(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0,
                                            v0, du, dv, alpha, delta, gamma))


# -- R3: one half-sweep ----------------------------------------------------------

def refine_sor(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
               color: int, omega: float):
    """The new (du, dv) [(B,) h, w] after one red (``color`` 0) or black
    (1) half-sweep over-relaxed by ``omega``.  One launch of R3."""
    ins = (u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0)
    if all_on_cpu(*ins):
        return refine_sor_plain(*ins, color, omega)
    _check_sor(ins, color)
    return dispatch(refine_sor_op, _sor_cuda, u0.device, *ins, color, omega).unbind(0)


def refine_compose(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
                   color: int, omega: float, bound: Optional[float] = None) -> torch.Tensor:
    """The flow [(B,) h, w, 2] = (u0 + du, v0 + dv) after the half-sweep of
    :func:`refine_sor`, du and dv its new increments, clipped to [-bound,
    bound] (a float32 bound) where ``bound`` is given.  One launch of R3 in
    its compose mode."""
    ins = (u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0)
    if all_on_cpu(*ins):
        return refine_compose_plain(*ins, color, omega, bound)
    _check_sor(ins, color)
    return dispatch(refine_compose_op, _compose_cuda, u0.device, *ins, color, omega,
                    *_clip(bound))


def refine_nosweep(u0, v0, du, dv, bound: Optional[float] = None) -> torch.Tensor:
    """The flow [(B,) h, w, 2] = (u0 + du, v0 + dv) of an outer iteration
    that makes no half-sweep, clipped to [-bound, bound] where ``bound`` is
    given.  One launch of R3 in its no-sweep mode, which reads these four
    planes only."""
    ins = (u0, v0, du, dv)
    if all_on_cpu(*ins):
        return refine_nosweep_plain(*ins, bound)
    _check_sor(ins, 0)
    return dispatch(refine_nosweep_op, _nosweep_cuda, u0.device, *ins, *_clip(bound))


def _clip(bound: Optional[float]) -> Tuple[bool, float]:
    """The clip's flag and bound as the ops take them: a flag, never a
    missing value."""
    return (False, 0.0) if bound is None else (True, float(bound))


def _check_sor(ins, color: int) -> None:
    if color not in (0, 1):
        raise ValueError(f"color must be 0 (red) or 1 (black), got {color}")
    _plane_dims(ins[0], "u0")
    for t, name in zip(ins, SOR_INPUTS):
        check_input(t, name, ins[0].device, torch.float32, ins[0].shape)


def _sor_empty(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
               color, omega):
    return u0.new_empty((2,) + tuple(u0.shape))


def _sor_cuda(u0: T, v0: T, du: T, dv: T, wE: T, wW: T, wS: T, wN: T, A11: T, A12: T,
              A22: T, b1c: T, b2c: T, det: T, Su0: T, Sv0: T, color: int, omega: float) -> T:
    """R3 on checked inputs: the new du and dv [2, (B,) h, w].  The kernel
    over-relaxes where the plain version does, where ``omega != 1.0`` in
    double precision."""
    ins = (u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0)
    out = _sor_empty(*ins, color, omega)
    _sor_launch(ins, color, omega, False, out)
    return out


def _sor_launch(ins, color: int, omega: float, compose: bool, out: torch.Tensor,
                clamp: bool = False, bound: float = 0.0, nosweep: bool = False) -> None:
    nb, h, w = _plane_dims(ins[0], "u0")
    _build.launch("dis_refine_sor", ins[0].device, _pointers(ins), nb, h, w, color, omega,
                  int(omega != 1.0), int(compose), int(clamp), bound, int(nosweep),
                  out.data_ptr())
    if nosweep:
        op, kernel, mode = "refine_nosweep", "R3n", (refine_nosweep,)
    elif compose:
        op, kernel, mode = "refine_compose", "R3c", (refine_compose,)
    else:
        op, kernel, mode = "refine_sor", "R3", ()
    launched(op, kernel, refine_sor, *mode, *((clamped,) if clamp else ()))


def _sor_cpu(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
             color, omega):
    return torch.stack(refine_sor_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c,
                                        b2c, det, Su0, Sv0, color, omega))


def _compose_empty(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
                   color, omega, clamp=False, bound=0.0):
    return u0.new_empty(tuple(u0.shape) + (2,))


def _compose_cuda(u0: T, v0: T, du: T, dv: T, wE: T, wW: T, wS: T, wN: T, A11: T, A12: T,
                  A22: T, b1c: T, b2c: T, det: T, Su0: T, Sv0: T, color: int, omega: float,
                  clamp: bool = False, bound: float = 0.0) -> T:
    """R3's compose mode on checked inputs: the flow [(B,) h, w, 2],
    clipped to [-bound, bound] where ``clamp``."""
    ins = (u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0)
    out = _compose_empty(*ins, color, omega, clamp, bound)
    _sor_launch(ins, color, omega, True, out, clamp, bound)
    return out


def _compose_cpu(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
                 color, omega, clamp=False, bound=0.0):
    return refine_compose_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det,
                                Su0, Sv0, color, omega, bound if clamp else None)


def _nosweep_empty(u0, v0, du, dv, clamp, bound):
    return u0.new_empty(tuple(u0.shape) + (2,))


def _nosweep_cuda(u0: T, v0: T, du: T, dv: T, clamp: bool, bound: float) -> T:
    """R3's no-sweep mode on checked inputs: the flow [(B,) h, w, 2].  The
    kernel reads u0, v0, du and dv only; u0 stands in the other twelve
    planes' places, which its flag keeps it from reading."""
    out = _nosweep_empty(u0, v0, du, dv, clamp, bound)
    _sor_launch((u0, v0, du, dv) + (u0,) * (len(SOR_INPUTS) - 4), 0, 1.0, True, out, clamp,
                bound, nosweep=True)
    return out


def _nosweep_cpu(u0, v0, du, dv, clamp, bound):
    return refine_nosweep_plain(u0, v0, du, dv, bound if clamp else None)


refine_planes.launches = 0
refine_warp.launches = 0
refine_setup.launches = 0
refine_setup_warp1.launches = 0
refine_weights.launches = 0
refine_sor.launches = 0
refine_compose.launches = 0
refine_nosweep.launches = 0
# R3's launches with its clip on (its compose or no-sweep mode).
clamped = SimpleNamespace(launches=0)
refine_planes_op = register("refine_planes", _planes_cuda, _planes_empty, _planes_cpu)
refine_warp_op = register("refine_warp", _warp_cuda, _warp_empty, _warp_cpu)
refine_setup_op = register("refine_setup", _setup_cuda, _setup_empty, _setup_cpu)
refine_setup_warp1_op = register("refine_setup_warp1", _setup_warp1_cuda, _setup_warp1_empty,
                                 _setup_warp1_cpu)
refine_weights_op = register("refine_weights", _weights_cuda, _weights_empty, _weights_cpu)
refine_sor_op = register("refine_sor", _sor_cuda, _sor_empty, _sor_cpu)
refine_compose_op = register("refine_compose", _compose_cuda, _compose_empty, _compose_cpu)
refine_nosweep_op = register("refine_nosweep", _nosweep_cuda, _nosweep_empty, _nosweep_cpu)
