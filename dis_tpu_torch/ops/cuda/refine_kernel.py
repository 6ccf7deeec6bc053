"""R0, R1, R23 and R3: the variational refinement's device loop
(``csrc/refine_planes.cu``, ``csrc/variational.cu``).

No Pallas kernel backs them: the JAX package writes the refinement as
elementwise code (``dis_tpu/ops/variational.py``) that XLA fuses into a
few loops per half-sweep.  They replace those fusions, one launch per
step of ``ops/variational.py::variational_refinement``:

- R0 :func:`refine_planes`, a level's Sobel planes (``planes6``): I1x,
  I1y and the six planes R1 warps (:188-204 there), once per level;
- R1, the bilinear warp (``_warp_bilinear`` there), once per outer
  iteration: in its setup mode, :func:`refine_setup` (``planes6``, R1s),
  it warps the six planes and writes R23's thirteen inputs (:220-250 and
  :312 there: the differences to I1, the mask, u0 and v0, du = dv = 0);
  in its warp1 mode, :func:`refine_setup_warp1` (``warp1``, R1w), it
  warps I2 alone and writes the same thirteen inputs from the Sobels of
  the warped plane and of I1 (:191-197 and :223-242 there);
- R23 :func:`refine_update`, one lagged weight update (the head of
  ``inner``) and all its red and black half-sweeps (``half_sweep``) on
  tiles held on chip, once per update; in its compose mode, the
  last update of an outer iteration, it writes the flow (u0 + du, v0 +
  dv) (:314 there), clipped to a bound where one is given
  (``refined_init_clamp``, ``dis_tpu/models/dis.py:101-103``);
- R3 in its no-sweep mode, :func:`refine_nosweep` (R3n), that flow of an
  outer iteration that makes no half-sweep, with the same clip.

R0, R1 and R3n are bound by bytes on the H100: one thread per pixel
(R0 and R1w a tile of them, staged in shared memory), the planes read
and written in coalesced rows, the stencils' neighbours from cache; R23
by its halo's repeated work and the latency of its chain of half-sweeps.
Their plain versions are ``refine_planes_plain``, ``refine_setup_plain``,
``refine_setup_warp1_plain``, ``refine_update_plain`` and
``refine_nosweep_plain`` of ``ops/variational.py``; each kernel keeps
their operations and rounding, so it equals them bitwise.

The ops return new tensors, stacked along a leading axis where there are
several: R0's I1x and I1y [2, (B,) h, w] and its planes [(B,) h, w, 6];
R1's thirteen inputs of R23 [13, (B,) h, w]; R23's new du and dv
[2, (B,) h, w], or in its compose mode and R3's no-sweep mode the flow
[(B,) h, w, 2].  So ``torch.export`` and CUDA graphs need no handling of
mutation.  Each launch counts in its wrapper's ``launches`` (R23's
compose mode also in ``composed.launches``); the clip, a flag of R3's
no-sweep mode and of R23's compose mode, also in ``clamped.launches``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from ... import _build
from ..variational import (H100_SMS, refine_nosweep_plain, refine_planes_plain,
                           refine_setup_plain, refine_setup_warp1_plain, refine_update_plain,
                           update_plan)
from . import all_on_cpu, check_input, dispatch, launched, register

WEIGHT_INPUTS = ("Iz", "Izx", "Izy", "Wx", "Wy", "Wxx", "Wxy", "Wyy", "m", "u0", "v0",
                 "du", "dv")
NOSWEEP_INPUTS = ("u0", "v0", "du", "dv")
MAX_PIXELS = 2 ** 31 - 256   # the kernels' 1-D grid of nb * h * w threads
MAX_PLANES = 65535           # R0's and R1w's gridDim.z, R23's gridDim.y
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


# -- R1: the warp, in its setup and warp1 modes ---------------------------------

def refine_setup(planes: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor,
                 I1x: torch.Tensor, I1y: torch.Tensor, p: int):
    """R23's thirteen inputs (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0,
    du, dv), every plane [(B,) h, w]: ``planes`` [(B,) h, w, 6] warped at
    ``x + flow``, less I1 (the window at offset ``p`` of ``img1``), I1x and
    I1y.  One launch of R1 in its setup mode (R1s)."""
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
    """R1's setup mode on checked inputs: R23's inputs [13, (B,) h, w]."""
    out = _setup_empty(planes, flow, img1, I1x, I1y, p)
    nb, h, w = _plane_dims(planes[..., 0], "planes")
    _build.launch("dis_refine_setup", planes.device, planes.data_ptr(), flow.data_ptr(),
                  img1.data_ptr(), I1x.data_ptr(), I1y.data_ptr(), nb, h, w,
                  *img1.shape[-2:], p, out.data_ptr())
    launched("refine_setup", "R1s", refine_setup)
    return out


def _setup_cpu(planes, flow, img1, I1x, I1y, p):
    return torch.stack(refine_setup_plain(planes, flow, img1, I1x, I1y, p))


def refine_setup_warp1(img2: torch.Tensor, flow: torch.Tensor, img1: torch.Tensor, p: int):
    """R23's thirteen inputs under the ``warp1`` scheme, every plane
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
    """R1's warp1 mode on checked inputs: R23's inputs [13, (B,) h, w]."""
    out = _setup_warp1_empty(img2, flow, img1, p)
    nb, h, w = _plane_dims(flow[..., 0], "flow")
    _build.launch("dis_refine_setup_warp1", flow.device, img1.data_ptr(), img2.data_ptr(),
                  flow.data_ptr(), nb, *img2.shape[-2:], p, h, w, out.data_ptr())
    launched("refine_setup_warp1", "R1w", refine_setup_warp1)
    return out


def _setup_warp1_cpu(img2, flow, img1, p):
    return torch.stack(refine_setup_warp1_plain(img2, flow, img1, p))


# -- R3: the flow of an outer iteration without a half-sweep ---------------------

def refine_nosweep(u0, v0, du, dv, bound: Optional[float] = None) -> torch.Tensor:
    """The flow [(B,) h, w, 2] = (u0 + du, v0 + dv) of an outer iteration
    that makes no half-sweep, clipped to [-bound, bound] where ``bound`` is
    given.  One launch of R3 in its no-sweep mode (R3n)."""
    ins = (u0, v0, du, dv)
    if all_on_cpu(*ins):
        return refine_nosweep_plain(*ins, bound)
    _plane_dims(u0, "u0")
    for t, name in zip(ins, NOSWEEP_INPUTS):
        check_input(t, name, u0.device, torch.float32, u0.shape)
    return dispatch(refine_nosweep_op, _nosweep_cuda, u0.device, *ins, *_clip(bound))


def _clip(bound: Optional[float]) -> Tuple[bool, float]:
    """The clip's flag and bound as the ops take them: a flag, never a
    missing value."""
    return (False, 0.0) if bound is None else (True, float(bound))


def _nosweep_empty(u0, v0, du, dv, clamp, bound):
    return u0.new_empty(tuple(u0.shape) + (2,))


def _nosweep_cuda(u0: T, v0: T, du: T, dv: T, clamp: bool, bound: float) -> T:
    """R3's no-sweep mode on checked inputs: the flow [(B,) h, w, 2],
    clipped to [-bound, bound] where ``clamp``."""
    out = _nosweep_empty(u0, v0, du, dv, clamp, bound)
    nb, h, w = _plane_dims(u0, "u0")
    _build.launch("dis_refine_nosweep", u0.device, u0.data_ptr(), v0.data_ptr(), du.data_ptr(),
                  dv.data_ptr(), nb, h, w, int(clamp), bound, out.data_ptr())
    launched("refine_nosweep", "R3n", refine_nosweep, *((clamped,) if clamp else ()))
    return out


def _nosweep_cpu(u0, v0, du, dv, clamp, bound):
    return refine_nosweep_plain(u0, v0, du, dv, bound if clamp else None)


# -- R23: one weight update -------------------------------------------------------

def refine_update(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv,
                  alpha: float, delta: float, gamma: float, sweeps: int, omega: float,
                  compose: bool = False, bound: Optional[float] = None):
    """One weight update, every plane [(B,) h, w]: the coefficients from
    the increments ``du``, ``dv``, then ``sweeps`` red-black SOR sweeps
    over-relaxed by ``omega``.  Returns the new (du, dv); where
    ``compose``, the flow [(B,) h, w, 2] = (u0 + du, v0 + dv) of the last
    half-sweep, clipped to [-bound, bound] (a float32 bound) where
    ``bound`` is given.  One launch of R23 (``update_plan``: more where
    the half-sweeps' halo would leave a tile no interior, each of some of
    the half-sweeps)."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    if all_on_cpu(*ins):
        return refine_update_plain(*ins, alpha, delta, gamma, sweeps, omega, compose, bound)
    if sweeps < 1:
        raise ValueError(f"sweeps must be 1 or more, got {sweeps}")
    nb, _, _ = _plane_dims(Iz, "Iz")
    if nb > MAX_PLANES:
        raise ValueError(f"{nb} planes: the kernel takes 1 to {MAX_PLANES}")
    if bound is not None and not compose:
        raise ValueError("the clip is a flag of the compose mode")
    dev = Iz.device
    for t, name in zip(ins, WEIGHT_INPUTS):
        check_input(t, name, dev, torch.float32, Iz.shape)
    out = dispatch(refine_update_op, _update_cuda, dev, *ins, alpha, delta, gamma, sweeps,
                   omega, compose, *_clip(bound))
    return out if compose else out.unbind(0)


def _update_empty(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv, alpha, delta, gamma,
                  sweeps, omega, compose, clamp=False, bound=0.0):
    return Iz.new_empty(tuple(Iz.shape) + (2,) if compose else (2,) + tuple(Iz.shape))


def _update_cuda(Iz: T, Izx: T, Izy: T, Wx: T, Wy: T, Wxx: T, Wxy: T, Wyy: T, m: T, u0: T,
                 v0: T, du: T, dv: T, alpha: float, delta: float, gamma: float, sweeps: int,
                 omega: float, compose: bool, clamp: bool = False, bound: float = 0.0) -> T:
    """R23 on checked inputs: the new du and dv [2, (B,) h, w], or where
    ``compose`` the flow [(B,) h, w, 2], clipped where ``clamp``.  A launch
    after the update's first starts from the previous one's du and dv."""
    ins = (Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv)
    nb, h, w = _plane_dims(Iz, "Iz")
    plan = update_plan(nb, h, w, sweeps, sms=_multiprocessors(Iz.device))
    for k, (ih, iw, j0, nh) in enumerate(plan):
        last = k == len(plan) - 1
        out = _update_empty(*ins, alpha, delta, gamma, sweeps, omega, compose and last)
        _build.launch("dis_refine_update", Iz.device, _pointers(ins + (du, dv)), nb, h, w, ih, iw,
                      j0, nh, alpha, delta, gamma, omega, int(omega != 1.0),
                      int(compose and last), int(clamp and last), bound, out.data_ptr())
        modes = ((composed,) if compose else ()) + ((clamped,) if clamp else ())
        launched("refine_update", "R23", refine_update, *(modes if last else ()))
        if not last:
            du, dv = out.unbind(0)
    return out


def _multiprocessors(device: torch.device) -> int:
    """The card's multiprocessors (the H100's for CPU tensors, which reach
    the CUDA function only where a test stubs the launch)."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _update_cpu(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv, alpha, delta, gamma,
                sweeps, omega, compose, clamp=False, bound=0.0):
    out = refine_update_plain(Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv, alpha,
                              delta, gamma, sweeps, omega, compose, bound if clamp else None)
    return out if compose else torch.stack(out)


refine_planes.launches = 0
refine_setup.launches = 0
refine_setup_warp1.launches = 0
refine_nosweep.launches = 0
refine_update.launches = 0
# The launches with the clip on: R3's (its no-sweep mode) and R23's (its
# compose mode).
clamped = SimpleNamespace(launches=0)
# R23's launches in its compose mode, which write the flow.
composed = SimpleNamespace(launches=0)
refine_planes_op = register("refine_planes", _planes_cuda, _planes_empty, _planes_cpu)
refine_setup_op = register("refine_setup", _setup_cuda, _setup_empty, _setup_cpu)
refine_setup_warp1_op = register("refine_setup_warp1", _setup_warp1_cuda, _setup_warp1_empty,
                                 _setup_warp1_cpu)
refine_nosweep_op = register("refine_nosweep", _nosweep_cuda, _nosweep_empty, _nosweep_cpu)
refine_update_op = register("refine_update", _update_cuda, _update_empty, _update_cpu)
