"""The static cost of a flow program: operations and bytes, from shapes.

Each kernel's work is a formula of its launch's shapes
(:func:`pyramid_cost`, :func:`extract_cost`, :func:`search_cost` (in
K1's plane mode :func:`search_plane_cost`), the
refinement's :func:`refine_planes_cost`, :func:`refine_setup_cost` (in
its warp1 mode :func:`refine_setup_warp1_cost`),
:func:`refine_update_cost` (a weight update's
:func:`refine_weights_cost` and its half-sweeps' :func:`refine_sor_cost`)
and :func:`refine_nosweep_cost`,
each scale's :func:`templates_cost` (plus :func:`start_cost` where S1
writes the start), :func:`weights_cost`, :func:`densify_cost`, and the
frame's :func:`frame_pad_cost`, :func:`intensity_levels_cost`,
:func:`frame_finish_cost`): each
input read once, each output written once, and the operations its
arithmetic does.  ``chip_smoke.py`` reads the same formulas for the
bounds of its ``kernels`` line, with the trips that its run's data
needs; :func:`flow_cost` counts K1's fixed loop instead, ``iterations +
1`` trips for every patch, as a compiler counts a fixed program.

:func:`flow_cost` traces one call of ``dis_flow`` for a shape bucket on
fake CPU tensors (``FakeTensorMode``: nothing is computed), with the
kernels routed through their ops (``ops/cuda::ops_on_cpu``), under a
dispatch mode that sees every top-level op once.  A kernel op is counted
by its formula; every other non-view ATen op (the glue) by the bytes it
must move (:func:`glue_bytes`) and, for an elementwise op, its output
elements as operations.  Nothing inside a kernel's plain version is
glue.  The trace does not depend on the device, so a bucket and config
give the same numbers on the CPU and on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves

from .config import DISConfig
from .ops.cuda.pyramid_kernel import first_level_dims

# The kernel each op launches, by op name (K1's plane mode, R1's setup and
# warp1 modes and R3's no-sweep mode count as K1, R1 and R3).
KERNELS = {"pyramid_levels": "K3", "extract_regions": "K2",
           "extract_regions_banded": "K2c", "iclk_search": "K1", "iclk_search_plane": "K1",
           "refine_planes": "R0", "refine_setup": "R1", "refine_setup_warp1": "R1",
           "refine_nosweep": "R3", "refine_update": "R23",
           "scale_templates": "S1", "fixed_weights": "S3", "densify": "S4",
           "frame_pad": "F1", "intensity_levels": "F2", "frame_finish": "F3"}
# The kernels every count names; the refinement's (R0, R1, R23, and R3 in
# its no-sweep mode) appear only where a program refines (R0 with the
# planes6 scheme, R23 where it makes a half-sweep), each scale's (S1,
# S3, S4) where they launch (S3 in fixed mode only), the frame's F1 where
# it pads, F2 where the refinement reads intensity planes, F3 where
# finest_scale > 0.
CORE_KERNELS = ("K3", "K2", "K2c", "K1")

F32 = 4

# Glue ops that move no data: an allocation, or a new tensor over its
# input's storage.
NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "_unsafe_view"}
# Fills: they write their output and read no tensor's data.
FILLS = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
         "new_ones", "new_full", "arange", "scalar_tensor"}
# Gathers: each output element reads one element of the source (their
# first argument), so the source counts at most the output's bytes.
GATHERS = {"gather", "index", "index_select"}


def pyramid_cost(nplanes: int, h: int, w: int, p: int, levels: int,
                 base: bool = True) -> Tuple[int, int]:
    """(bytes, operations) of one K3 launch over ``nplanes`` images whose
    first level is [h, w] (unpadded): the source read once (the raw image,
    or the finer level's padded plane where ``base`` is false) and every
    level's three padded planes written once; about 24 operations per
    base-level pixel (two Sobels, the magnitude, two more Sobels) and 14
    per decimated pixel."""
    src = h * w if base else (2 * h + 2 * p) * (2 * w + 2 * p)
    planes = sum(3 * ((h >> s) + 2 * p) * ((w >> s) + 2 * p) for s in range(levels))
    ops = sum((h >> s) * (w >> s) * (24 if s == 0 and base else 14) for s in range(levels))
    return nplanes * (src + planes) * F32, nplanes * ops


def extract_cost(nb: int, th: int, tw: int, n: int, ps: int) -> Tuple[int, int]:
    """(bytes, operations) of one K2/K2b/K2c launch over ``nb`` padded
    planes [th, tw] and ``n`` patches each: planes and positions read
    once, regions and bases written once; about 12 operations per patch
    for its two bases."""
    rc = 2 * ps + 3
    return nb * (th * tw + n * 2 + n * (rc * rc + 2)) * F32, 12 * nb * n


def search_cost(nb: int, n: int, ps: int, fixed: bool, normalize: bool,
                active_trips: int, frozen0: int = 0) -> Tuple[int, int]:
    """(bytes, operations) of one K1/K1b launch over ``nb`` pairs of ``n``
    patches: inputs read once (the raw template only for the ``frozen0``
    patches frozen at the start, which take it as their Q), outputs
    written once; the operations of ``active_trips`` patch trips (the sum
    over trips of the patches still active) plus the start resample of
    every patch not frozen at the start."""
    taps = ps * ps
    rc = 2 * ps + 3
    sample = 9 * taps + 6 + (2 * taps if normalize else 0)
    trip = 4 * taps + (taps if fixed else 0) + 21 + (5 if fixed else 0) + sample
    per_patch = (rc * rc + 2) * F32 + 2 * taps * F32 + 4 * F32 + 2 * F32 + 1
    per_patch += (taps * F32 if fixed else 0) + 2 * F32 + taps * F32 + 1
    nbytes = nb * n * per_patch + n * 2 * F32 + frozen0 * taps * F32
    return nbytes, active_trips * trip + (nb * n - frozen0) * sample


def search_plane_cost(nb: int, th: int, tw: int, n: int, ps: int, fixed: bool,
                      normalize: bool, active_trips: int, frozen0: int = 0
                      ) -> Tuple[int, int]:
    """(bytes, operations) of one K1/K1b launch in its plane mode over
    ``nb`` padded planes [th, tw] and ``n`` patches each:
    :func:`search_cost` with the planes and the starts read once in place
    of the regions and their bases, and 12 operations a patch for the
    bases (K2's)."""
    rc = 2 * ps + 3
    nbytes, ops = search_cost(nb, n, ps, fixed, normalize, active_trips, frozen0)
    return (nbytes - nb * n * (rc * rc + 2) * F32 + nb * (th * tw + n * 2) * F32,
            ops + 12 * nb * n)


def refine_planes_cost(nb: int, h: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of one R0 launch over ``nb`` windows of ``h`` x
    ``w`` pixels: the two windows read once, I1x, I1y and the six planes
    written once; seven Sobels a pixel, 7 operations each."""
    px = nb * h * w
    return px * 10 * F32, px * 49


def refine_setup_cost(nb: int, h: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of one R1 launch in its setup mode over ``nb``
    planes of ``h`` x ``w``: the six planes, the flow, I1, I1x and I1y read
    once and R23's 13 inputs written once; about 37 operations a pixel for
    the taps and weights, 7 a channel for the blend of the six planes, and
    three differences."""
    px = nb * h * w
    return px * 24 * F32, px * (37 + 7 * 6 + 3)


def refine_setup_warp1_cost(nb: int, h: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of one R1 launch in its warp1 mode over ``nb``
    windows of ``h`` x ``w``: I1, I2 and the flow read once and R23's 13
    inputs written once; the warp's operations for one plane (37 and 7),
    seven Sobels a pixel (7 operations each), the two means and three
    differences."""
    px = nb * h * w
    return px * 17 * F32, px * (37 + 7 + 7 * 7 + 2 * 2 + 3)


def refine_weights_cost(nb: int, h: int, w: int) -> Tuple[int, int]:
    """(bytes, operations) of a weight update's coefficients over ``nb``
    planes of ``h`` x ``w`` (R23's head), were they a pass of their own: 13
    planes read once and 12 written once; about 195 operations a pixel (the
    smoothness weights of the pixel and of its four neighbours take 110 of
    them)."""
    px = nb * h * w
    return px * 25 * F32, px * 195


def refine_sor_cost(nb: int, h: int, w: int, color: int, relax: bool) -> Tuple[int, int]:
    """(bytes, operations) of one half-sweep of R23 over ``nb`` planes of
    ``h`` x ``w``, were it a pass of its own: 16 planes read once and 2
    written once; 34 operations for each pixel of ``color`` (0: ``x + y``
    even), 40 where it over-relaxes."""
    px = nb * h * w
    updated = nb * ((h * w + 1) // 2 if color == 0 else h * w // 2)
    return px * 18 * F32, updated * (40 if relax else 34)


def refine_nosweep_cost(nb: int, h: int, w: int, clamp: bool) -> Tuple[int, int]:
    """(bytes, operations) of one R3 launch in its no-sweep mode: u0, v0,
    du and dv read once and the flow's two planes written once; two sums a
    pixel (and two comparisons a value where it ``clamp``s)."""
    px = nb * h * w
    return px * 6 * F32, px * (6 if clamp else 2)


def refine_update_cost(nb: int, h: int, w: int, sweeps: int, relax: bool,
                       compose: bool = False, clamp: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one R23 launch, a weight update of ``sweeps``
    SOR sweeps over ``nb`` planes of ``h`` x ``w``: its 13 planes read
    once and du and dv (or the flow) written once; the coefficients'
    operations and each half-sweep's (:func:`refine_weights_cost`,
    :func:`refine_sor_cost`), and in the compose mode two sums a pixel (and
    two comparisons a value where it ``clamp``s).  The halo's repeated work
    is not counted."""
    ops = refine_weights_cost(nb, h, w)[1]
    ops += sum(refine_sor_cost(nb, h, w, j & 1, relax)[1] for j in range(2 * sweeps))
    px = nb * h * w
    return px * 15 * F32, ops + ((6 if clamp else 2) * px if compose else 0)


def frame_pad_cost(nb: int, h: int, w: int, top: int, bottom: int, left: int,
                   right: int) -> Tuple[int, int]:
    """(bytes, operations) of one F1 launch over ``nb`` pairs [h, w]: both
    images read once and both padded images written once; no arithmetic."""
    return 2 * nb * (h * w + (h + top + bottom) * (w + left + right)) * F32, 0


def intensity_levels_cost(nb: int, h: int, w: int, levels: int) -> Tuple[int, int]:
    """(bytes, operations) of one F2 launch over ``nb`` pairs [h, w]: both
    sources read once and ``levels`` levels of both written once; four
    operations a level pixel."""
    out = sum((h >> s) * (w >> s) for s in range(1, levels + 1))
    return 2 * nb * (h * w + out) * F32, 2 * nb * out * 4


def frame_finish_cost(nb: int, fh: int, fw: int, height: int, width: int) -> Tuple[int, int]:
    """(bytes, operations) of one F3 launch: the finest flow [nb, fh, fw, 2]
    read once and the cropped flow [nb, height, width, 2] written once;
    per output value four scaled taps, six products, three sums and two
    complements, and about 10 operations a pixel for its coordinates."""
    px = nb * height * width
    return (nb * fh * fw + px) * 2 * F32, px * (2 * 15 + 10)


def templates_cost(nb: int, th: int, tw: int, n: int, ps: int,
                   residual: bool) -> Tuple[int, int]:
    """(bytes, operations) of one S1 launch over ``nb`` triples of padded
    planes [th, tw] (level, dx, dy) and ``n`` patches each: the planes read
    once, T, Tdx, Tdy (and Tn where ``residual``) and the 2x2 inverses
    written once; per patch three products and three sums a tap, about 12
    operations for the inverse, and for Tn a sum and a subtraction a tap."""
    taps = ps * ps
    per_patch = (3 * taps + 4 + (taps if residual else 0)) * F32
    ops = 6 * taps + 12 + (2 * taps + 1 if residual else 0)
    return nb * (3 * th * tw * F32 + n * per_patch), nb * n * ops


def start_cost(nb: int, num_w: int, num_h: int, coarser: bool) -> Tuple[int, int]:
    """(bytes, operations) of the search start that an S1 launch writes
    beside the templates (once a launch of its own, S2) over ``nb`` pairs
    of a ``num_w`` x ``num_h`` grid: the picks (int64) and centers read once, each
    patch's picked flow value where there is a ``coarser`` flow, init_u
    and pos0 (two floats each) and the start flag (a byte) written once;
    about 8 operations a patch."""
    n = num_w * num_h
    read = (num_w + num_h) * 8 + n * 2 * F32 + (nb * n * 2 * F32 if coarser else 0)
    return read + nb * n * (4 * F32 + 1), nb * n * 8


def weights_cost(nb: int, n: int, ps: int, normalize: bool) -> Tuple[int, int]:
    """(bytes, operations) of one S3 launch over ``nb`` pairs of ``n``
    patches: Q and T read once, the start flags (a byte) read and the
    weights written once; per tap a subtraction, a product and a sum (and
    for the mean a sum and a subtraction), and 3 operations a patch."""
    taps = ps * ps
    ops = 3 * taps + 3 + (2 * taps + 1 if normalize else 0)
    return nb * n * (2 * taps * F32 + 1 + F32), nb * n * ops


def densify_cost(nb: int, n: int, out_h: int, width: int, kr: int, kc: int,
                 weighted: bool) -> Tuple[int, int]:
    """(bytes, operations) of one S4 launch over ``nb`` pairs of ``n``
    patches into [out_h, width] pixels: u (and the weights) read once, the
    cover indices (int64) read once, the uniform weight plane read once
    where there are no weights, the flow written once; per pixel ``kr *
    kc`` adds a channel (and the weight's sum and two products a term where
    ``weighted``), two divisions and a test."""
    px = out_h * width
    read = nb * n * (3 if weighted else 2) * F32 + (out_h * kr + width * kc) * 8
    read += 0 if weighted else px * F32
    per_px = (5 if weighted else 2) * kr * kc + 3
    return read + nb * px * 2 * F32, nb * px * per_px


def op_cost(name: str, args) -> Tuple[int, int]:
    """(bytes, operations) of one call of the kernel op ``name`` with the
    op's arguments, K1 for its fixed loop (every patch, every trip)."""
    if name == "pyramid_levels":
        src, p, levels, base = args
        nplanes = src.shape[0] if src.ndim == 3 else 1
        return pyramid_cost(nplanes, *first_level_dims(src, p, base), p, levels, base)
    if name in ("extract_regions", "extract_regions_banded"):
        img2, pos0, ps = args[:3]
        nb = img2.shape[0] if img2.ndim == 3 else 1
        return extract_cost(nb, *img2.shape[-2:], pos0.shape[-2], ps)
    if name == "iclk_search":
        init_u, ps, iterations = args[9], args[11], args[12]
        normalize, fixed = args[16], args[17]
        nb = init_u.shape[0] if init_u.ndim == 3 else 1
        n = init_u.shape[-2]
        return search_cost(nb, n, ps, fixed, normalize, nb * n * (iterations + 1))
    if name == "iclk_search_plane":
        img2, init_u, ps, iterations = args[0], args[8], args[10], args[11]
        normalize, fixed = args[15], args[16]
        nb = init_u.shape[0] if init_u.ndim == 3 else 1
        n = init_u.shape[-2]
        return search_plane_cost(nb, *img2.shape[-2:], n, ps, fixed, normalize,
                                 nb * n * (iterations + 1))
    if name == "refine_planes":
        img1, h, w = args[0], args[3], args[4]
        return refine_planes_cost(img1.shape[0] if img1.ndim == 3 else 1, h, w)
    if name in ("refine_setup", "refine_setup_warp1"):
        lead_hw = args[0 if name == "refine_setup" else 1].shape[:-1]
        setup = refine_setup_cost if name == "refine_setup" else refine_setup_warp1_cost
        return setup(lead_hw[0] if len(lead_hw) == 3 else 1, *lead_hw[-2:])
    if name == "refine_update":
        plane = args[0]
        sweeps, omega, compose = args[16:19]
        return refine_update_cost(plane.shape[0] if plane.ndim == 3 else 1, *plane.shape[-2:],
                                  sweeps, omega != 1.0, compose, len(args) > 19 and args[19])
    if name == "refine_nosweep":
        plane = args[0]
        return refine_nosweep_cost(plane.shape[0] if plane.ndim == 3 else 1,
                                   *plane.shape[-2:], args[4])
    if name == "frame_pad":
        img1 = args[0]
        return frame_pad_cost(img1.shape[0] if img1.ndim == 3 else 1, *img1.shape[-2:],
                              *args[2:6])
    if name == "intensity_levels":
        img1, levels = args[0], args[2]
        return intensity_levels_cost(img1.shape[0] if img1.ndim == 3 else 1,
                                     *img1.shape[-2:], levels)
    if name == "frame_finish":
        flow, height, width = args[0], args[4], args[5]
        return frame_finish_cost(flow.shape[0] if flow.ndim == 4 else 1, *flow.shape[-3:-1],
                                 height, width)
    if name == "scale_templates":
        img, num_w, num_h, ps, residual = args[0], args[3], args[4], args[8], args[9]
        flow, centers = args[10], args[14]
        nb = img.shape[0] if img.ndim == 3 else 1
        nbytes, ops = templates_cost(nb, *img.shape[-2:], num_w * num_h, ps, residual)
        if centers is None:
            return nbytes, ops
        sbytes, sops = start_cost(nb, num_w, num_h, flow is not None)
        return nbytes + sbytes, ops + sops
    if name == "fixed_weights":
        Q, ps, normalize = args[0], args[3], args[4]
        nb = Q.shape[0] if Q.ndim == 3 else 1
        return weights_cost(nb, Q.shape[-2], ps, normalize)
    if name == "densify":
        u, weights, cover_rows, cover_cols = args[:4]
        nb = u.shape[0] if u.ndim == 3 else 1
        return densify_cost(nb, u.shape[-2], cover_rows.shape[0], cover_cols.shape[0],
                            cover_rows.shape[1], cover_cols.shape[1], weights is not None)
    raise ValueError(f"no cost formula for the op {name!r}")


def glue_bytes(func, args, kwargs, out) -> int:
    """The bytes one glue op ``func`` must move: its tensor inputs read
    once and its outputs written once, except as ``NO_BYTES``, ``FILLS``
    and ``GATHERS`` say."""
    name = func._overloadpacket.__name__
    if name in NO_BYTES:
        return 0
    written = sum(t.nbytes for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    if name in FILLS:
        return written
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    if name in GATHERS and ins and ins[0] is args[0]:
        return written + min(ins[0].nbytes, written) + sum(t.nbytes for t in ins[1:])
    return written + sum(t.nbytes for t in ins)


def kernel_ops(program) -> Dict[str, int]:
    """The kernel ops in an exported program's graph, by kernel: K3, K2,
    K2c and K1 always, the others where they launch (``KERNELS``)."""
    ops = dict.fromkeys(CORE_KERNELS, 0)
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if name.startswith("dis_tpu_torch::"):
            k = KERNELS[name.split("::")[1]]
            ops[k] = ops.get(k, 0) + 1
    return ops


def flow_cost(cfg: DISConfig, height: int, width: int,
              batch: Optional[int] = None) -> Dict:
    """``{"flops", "bytes accessed", "kernels", "glue"}`` of one
    ``dis_flow`` call on a [(batch,) height, width] bucket: totals, each
    kernel launch's ``{"flops", "bytes accessed"}`` in launch order by
    kernel (K3, K2, K2c and K1 always, the others where they launch),
    and the glue's op count and totals.  The CPU plans of the
    bucket are built (and cached) first: the trace reads them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from .models.dis import dis_flow, flow_plans
    from .ops.cuda import ops_on_cpu

    kernels = {k: [] for k in CORE_KERNELS}
    glue = {"ops": 0, "flops": 0, "bytes accessed": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "dis_tpu_torch":
                name = func.name().split("::")[1].split(".")[0]
                nbytes, ops = op_cost(name, args)
                kernels.setdefault(KERNELS[name], []).append(
                    {"flops": ops, "bytes accessed": nbytes})
            elif func.namespace == "aten" and not func.is_view:
                glue["ops"] += 1
                glue["bytes accessed"] += glue_bytes(func, args, kwargs, out)
                if torch.Tag.pointwise in func.tags:
                    glue["flops"] += sum(t.numel() for t in tree_leaves(out)
                                         if isinstance(t, torch.Tensor))
            return out

    cpu = torch.device("cpu")
    flow_plans(cfg, height, width, cpu)
    shape = (height, width) if batch is None else (batch, height, width)
    with FakeTensorMode(allow_non_fake_inputs=True):
        a, b = torch.empty(shape), torch.empty(shape)
        with Count(), ops_on_cpu():
            dis_flow(a, b, cfg)
    launches = [c for calls in kernels.values() for c in calls]
    return {"flops": glue["flops"] + sum(c["flops"] for c in launches),
            "bytes accessed": glue["bytes accessed"] + sum(c["bytes accessed"]
                                                           for c in launches),
            "kernels": kernels, "glue": glue}
