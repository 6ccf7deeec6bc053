"""R1-R3: the variational refinement's device loop (``csrc/variational.cu``).

No Pallas kernel backs them: the JAX package writes the refinement as
elementwise code (``dis_tpu/ops/variational.py``) that XLA fuses into a
few loops per half-sweep.  They replace those fusions, one launch per
step of ``ops/variational.py::variational_refinement``:

- R1 :func:`refine_warp`, the bilinear warp of C = 1 or 6 planes
  (``_warp_bilinear`` there), once per outer iteration;
- R2 :func:`refine_weights`, one lagged weight update with its 2x2
  systems (the head of ``inner``), once per update;
- R3 :func:`refine_sor`, one red or black half-sweep (``half_sweep``),
  twice per SOR sweep.

Each is bound by bytes on the H100: one thread per pixel, the planes
read and written in coalesced rows, the stencils' neighbours from cache.
Their plain versions are ``refine_warp_plain``, ``refine_weights_plain``
and ``refine_sor_plain`` of ``ops/variational.py``; each kernel keeps
their operations and rounding, so it equals them bitwise.

The ops return new tensors, stacked along a leading axis where there are
several: R1's warped planes [C, (B,) h, w] (the wrapper hands them back as
[(B,) h, w, C], a view whose planes stay contiguous for R2) and its mask,
R2's twelve planes [12, (B,) h, w], R3's new du and dv [2, (B,) h, w].
So ``torch.export`` and CUDA graphs need no handling of mutation.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import _build
from ..variational import refine_sor_plain, refine_warp_plain, refine_weights_plain
from . import all_on_cpu, check_input, dispatch, register

WARP_CHANNELS = (1, 6)   # the kernel's instances: warp1 and planes6
WEIGHT_INPUTS = ("Iz", "Izx", "Izy", "Wx", "Wy", "Wxx", "Wxy", "Wyy", "m", "u0", "v0",
                 "du", "dv")
WEIGHT_OUTPUTS = 12
SOR_INPUTS = ("u0", "v0", "du", "dv", "wE", "wW", "wS", "wN", "A11", "A12", "A22", "b1c",
              "b2c", "det", "Su0", "Sv0")
MAX_PIXELS = 2 ** 31 - 256   # the kernels' 1-D grid of nb * h * w threads
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
    refine_warp.launches += 1
    return out, inb


def _warp_cpu(planes: torch.Tensor, flow: torch.Tensor):
    warped, inb = refine_warp_plain(planes, flow)
    return torch.stack(warped.unbind(-1)), inb


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
    refine_weights.launches += 1
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
    if color not in (0, 1):
        raise ValueError(f"color must be 0 (red) or 1 (black), got {color}")
    _plane_dims(u0, "u0")
    dev = u0.device
    for t, name in zip(ins, SOR_INPUTS):
        check_input(t, name, dev, torch.float32, u0.shape)
    return dispatch(refine_sor_op, _sor_cuda, dev, *ins, color, omega).unbind(0)


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
    nb, h, w = _plane_dims(u0, "u0")
    _build.launch("dis_refine_sor", u0.device, _pointers(ins), nb, h, w, color, omega,
                  int(omega != 1.0), out.data_ptr())
    refine_sor.launches += 1
    return out


def _sor_cpu(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c, b2c, det, Su0, Sv0,
             color, omega):
    return torch.stack(refine_sor_plain(u0, v0, du, dv, wE, wW, wS, wN, A11, A12, A22, b1c,
                                        b2c, det, Su0, Sv0, color, omega))


refine_warp.launches = 0
refine_weights.launches = 0
refine_sor.launches = 0
refine_warp_op = register("refine_warp", _warp_cuda, _warp_empty, _warp_cpu)
refine_weights_op = register("refine_weights", _weights_cuda, _weights_empty, _weights_cpu)
refine_sor_op = register("refine_sor", _sor_cuda, _sor_empty, _sor_cpu)
