"""The plain reference of the DIS pipeline, in PyTorch, on one pair.

A frozen restatement of the reference semantics (the NumPy oracle of the
JAX package, ``oracle/reference_semantics.py``: pyramid, patch grid,
IC-LK search, densification) and of the variational refinement of the
JAX package's ``ops/variational.py``, to whose recorded outputs it is held
by ``flowbench/tests/test_flowbench_reference_vs_oracle.py``.  It imports
neither of them, nor anything of the measured program: it works out
from the two frames everything the program derives (padding, pyramids,
patch grids, intensity levels).

Every floating tensor is of ``dtype`` (float32, as the program; the
lower-precision control runs it in bfloat16).  Sums run in fixed orders,
those the JAX package fixes for its own: a patch's taps in a pair tree
(``tree_sum``), a pixel's covering patches by rows, then columns, in
increasing grid order.  The oracle sums in NumPy's order; either is
float32, but a few ulps moved by another order are enough to flip a
discrete decision of the search (the tap base ``ceil(pos + 1e-5)`` of a
position within 1e-5 of a whole pixel, the policing test) and with it a
region of the flow.  It runs on any device;
the benchmark runs it on the card after the timed window, one pair at a
time.  ``flow(img1, img2, params)`` returns the flow [H, W, 2] and the
search's patch trips per scale (``Trips``), which the search layer's
roofline counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

# Charbonnier epsilons of the refinement (ops/variational.py): the data
# terms in intensity units on 0..255 planes, the smoothness in px.
EPS2_DATA = 1e-2
EPS2_SMOOTH = 1e-6


@dataclasses.dataclass(frozen=True)
class Params:
    """The DIS parameters a configuration file states (its ``dis`` group);
    the derived values as the reference C++ defines them."""

    iterations: int
    patch_size: int
    coarsest_scale: int
    finest_scale: int
    patch_overlap: float
    patch_normalization: bool
    mode: str
    refinement_iters: int
    refinement_alpha: float
    refinement_delta: float
    refinement_gamma: float
    refine_per_level: bool
    refined_init_clamp: bool
    refinement_inner_sweeps: int
    refinement_sor_sweeps: int
    refinement_omega: float
    refinement_scheme: str
    refinement_planes: str
    conv_eps: float

    @classmethod
    def from_fields(cls, fields: Dict) -> "Params":
        """From a configuration's ``dis`` group; fields that select the
        program's routes and not the result (``sampler``, ``kernel``,
        ``early_exit``) are not read."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})

    @property
    def steps(self) -> int:
        return max(1, int(math.floor(self.patch_size * (1.0 - self.patch_overlap))))

    @property
    def outlier_thresh(self) -> float:
        return float(self.patch_size) / 2.0

    @property
    def img_padding(self) -> int:
        return self.patch_size


@dataclasses.dataclass
class Trips:
    """Per scale, coarsest first: (scale, patches, patch trips of the
    search loop, the level's [h, w])."""

    scales: List[Tuple[int, int, int, Tuple[int, int]]] = dataclasses.field(
        default_factory=list)


# --- borders ---------------------------------------------------------------


def _reflect101_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of positions [lo, hi) of a length-n axis, reflected about
    its end samples without repeating them (np.pad mode "reflect")."""
    i = torch.arange(lo, hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def reflect101_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    h, w = img.shape
    ri = _reflect101_index(h, -r, h + r, img.device)
    ci = _reflect101_index(w, -r, w + r, img.device)
    return img[ri][:, ci]


def replicate_pad(img: torch.Tensor, t: int, b: int, l: int, r: int) -> torch.Tensor:
    h, w = img.shape
    ri = torch.arange(-t, h + b, device=img.device).clamp(0, h - 1)
    ci = torch.arange(-l, w + r, device=img.device).clamp(0, w - 1)
    return img[ri][:, ci]


def zero_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    h, w = img.shape
    out = torch.zeros((h + 2 * p, w + 2 * p), dtype=img.dtype, device=img.device)
    out[p:p + h, p:p + w] = img
    return out


def _shift_edge(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The neighbour at (y + dy, x + dx), replicating the border."""
    if dx == 1:
        x = torch.cat([x[:, 1:], x[:, -1:]], 1)
    elif dx == -1:
        x = torch.cat([x[:, :1], x[:, :-1]], 1)
    if dy == 1:
        x = torch.cat([x[1:], x[-1:]], 0)
    elif dy == -1:
        x = torch.cat([x[:1], x[:-1]], 0)
    return x


# --- image primitives (cv::Sobel, cv::resize) ------------------------------


def sobel3(img: torch.Tensor, axis: str) -> torch.Tensor:
    """3x3 Sobel scaled by 1/8, reflect-101 border."""
    p = reflect101_pad(img, 1)
    if axis == "x":
        d = p[:, 2:] - p[:, :-2]
        out = d[:-2, :] + 2.0 * d[1:-1, :] + d[2:, :]
    else:
        d = p[2:, :] - p[:-2, :]
        out = d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]
    return out * (1.0 / 8.0)


def resize_half(img: torch.Tensor) -> torch.Tensor:
    """x0.5 INTER_LINEAR of even dims: the 2x2 box mean."""
    h, w = img.shape
    x = img.reshape(h // 2, 2, w // 2, 2)
    return (x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]) * 0.25


def resize_bilinear(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """INTER_LINEAR to [out_h, out_w(, C)]: ``src = (dst + 0.5) * scale -
    0.5``, clamped at the edges."""
    in_h, in_w = img.shape[:2]
    dev = img.device
    xs = (torch.arange(out_w, dtype=torch.float64, device=dev) + 0.5) * (in_w / out_w) - 0.5
    ys = (torch.arange(out_h, dtype=torch.float64, device=dev) + 0.5) * (in_h / out_h) - 0.5
    x0, y0 = torch.floor(xs).long(), torch.floor(ys).long()
    ax = torch.where(x0 < 0, 0.0, xs - x0).to(img.dtype)
    ay = torch.where(y0 < 0, 0.0, ys - y0).to(img.dtype)
    x0c, x1c = x0.clamp(0, in_w - 1), (x0 + 1).clamp(0, in_w - 1)
    y0c, y1c = y0.clamp(0, in_h - 1), (y0 + 1).clamp(0, in_h - 1)
    if img.ndim == 3:
        ax, ay = ax[None, :, None], ay[:, None, None]
    else:
        ax, ay = ax[None, :], ay[:, None]
    top, bot = img[y0c], img[y1c]
    r0 = top[:, x0c] * (1 - ax) + top[:, x1c] * ax
    r1 = bot[:, x0c] * (1 - ax) + bot[:, x1c] * ax
    return r0 * (1 - ay) + r1 * ay


# --- pyramid and grid --------------------------------------------------------


def construct_pyramid(img: torch.Tensor, coarsest: int, pad: int):
    """Padded (image, dx, dy) per level, finest first: level 0 is the
    Sobel gradient magnitude, each further level its x0.5 decimation;
    images replicate-padded, gradients zero-padded."""
    out = []
    cur = None
    for i in range(coarsest + 1):
        if i == 0:
            dx, dy = sobel3(img, "x"), sobel3(img, "y")
            cur = torch.sqrt(dx * dx + dy * dy)
        else:
            cur = resize_half(cur)
        dx, dy = sobel3(cur, "x"), sobel3(cur, "y")
        out.append((replicate_pad(cur, pad, pad, pad, pad), zero_pad(dx, pad),
                    zero_pad(dy, pad)))
    return out


def grid_shape(width: int, height: int, steps: int) -> Tuple[int, int, int, int]:
    """(patches across, patches down, x offset, y offset) of a level."""
    npw, nph = math.ceil(width / steps), math.ceil(height / steps)
    offw = math.floor((width - (npw - 1) * steps) / 2)
    offh = math.floor((height - (nph - 1) * steps) / 2)
    return npw, nph, offw, offh


def grid_centers(width: int, height: int, steps: int, dtype, device) -> torch.Tensor:
    """Patch centers [N, 2] (x, y), x-outer and y-inner."""
    npw, nph, offw, offh = grid_shape(width, height, steps)
    xs = torch.arange(npw, device=device) * steps + offw
    ys = torch.arange(nph, device=device) * steps + offh
    cx, cy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([cx.reshape(-1), cy.reshape(-1)], -1).to(dtype)


# --- the search --------------------------------------------------------------


def extract_templates(img, dx, dy, centers, ps: int, pad: int):
    offs = torch.arange(-(ps // 2), ps // 2, device=img.device)
    px = (torch.round(centers[:, 0].float()).long() + pad).clamp(ps // 2, img.shape[1] - ps // 2)
    py = (torch.round(centers[:, 1].float()).long() + pad).clamp(ps // 2, img.shape[0] - ps // 2)
    rows = (py[:, None, None] + offs[None, :, None]).expand(-1, ps, ps)
    cols = (px[:, None, None] + offs[None, None, :]).expand(-1, ps, ps)
    n = centers.shape[0]
    return tuple(p[rows, cols].reshape(n, ps * ps) for p in (img, dx, dy))


def hessians(Tdx, Tdy):
    """Entries (a, b, c) of the 2x2 Gauss-Newton Hessians, with the
    det == 0 guard."""
    a = tree_sum(Tdx * Tdx)
    b = tree_sum(Tdx * Tdy)
    c = tree_sum(Tdy * Tdy)
    guard = (a * c - b * b == 0).to(a.dtype) * 1e-10
    return a + guard, b, c + guard


def solve2x2(H, r0, r1):
    a, b, d = H
    det = a * d - b * b
    return (d * r0 - b * r1) / det, (-b * r0 + a * r1) / det


def sample_patches(img2, pos, ps: int, pad: int, normalize: bool):
    """Bilinear query patches [N, ps*ps] at ``pos`` [N, 2]: weights from
    the floor fractions, taps from ``ceil(pos + 1e-5)``, clamped to the
    padded plane."""
    n = pos.shape[0]
    half = ps // 2
    px, py = pos[:, 0], pos[:, 1]
    a = px - torch.floor(px)
    b = py - torch.floor(py)
    w0 = (1 - a) * (1 - b)
    w1 = a * (1 - b)
    w2 = b * (1 - a)
    w3 = a * b
    cpx = torch.ceil(px + 1e-5).long() + pad
    cpy = torch.ceil(py + 1e-5).long() + pad
    d = torch.arange(ps + 1, device=img2.device)
    rows = ((cpy - half - 1)[:, None, None] + d[None, :, None]).clamp(0, img2.shape[0] - 1)
    cols = ((cpx - half - 1)[:, None, None] + d[None, None, :]).clamp(0, img2.shape[1] - 1)
    W = img2[rows.expand(-1, -1, ps + 1), cols.expand(-1, ps + 1, -1)]
    q = (w3[:, None, None] * W[:, 1:, 1:] + w2[:, None, None] * W[:, 1:, :-1]
         + w1[:, None, None] * W[:, :-1, 1:] + w0[:, None, None] * W[:, :-1, :-1])
    q = q.reshape(n, ps * ps)
    if normalize:
        q = q - patch_mean(q)
    return q


def _norm(x0, x1):
    return torch.sqrt(x0 * x0 + x1 * x1)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pair tree: pairs (0, 1), (2, 3),
    ... per level, an odd length padded with a zero."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def patch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of each patch's taps [N, 1], a true division by their
    number."""
    s = tree_sum(x)[:, None]
    return s / torch.full_like(s, x.shape[-1])


def inverse_search(img2, T, Tdx, Tdy, H, centers, init_u, prm: Params,
                   width: int, height: int):
    """The IC-LK search of one scale: returns (u [N, 2], patch trips)."""
    ps, pad = prm.patch_size, prm.img_padding
    lb = -float(ps) / 2.0
    ub_w, ub_h = float(width + ps // 2 - 2), float(height + ps // 2 - 2)
    fixed = prm.mode == "fixed"
    Tn = T
    if fixed and prm.patch_normalization:
        Tn = T - patch_mean(T)

    def oob(p):
        return (p[:, 0] < lb) | (p[:, 1] < lb) | (p[:, 0] > ub_w) | (p[:, 1] > ub_h)

    u = init_u.clone()
    pos = centers + u
    start = pos.clone()
    converged = oob(pos)
    Q = torch.where(converged[:, None], T,
                    sample_patches(img2, pos, ps, pad, prm.patch_normalization))
    trips = 0
    for it in range(1, prm.iterations + 2):
        active = ~converged
        n_active = int(active.sum())
        if n_active == 0:
            break
        trips += n_active
        R = Q - Tn if fixed else Q
        d0, d1 = solve2x2(H, tree_sum(Tdx * R), tree_sum(Tdy * R))
        u_new = u - torch.stack([d0, d1], -1)
        p_new = centers + u_new
        gap = start - p_new
        policed = (_norm(gap[:, 0], gap[:, 1]) > prm.outlier_thresh) | oob(p_new)
        u = torch.where(active[:, None], torch.where(policed[:, None], init_u, u_new), u)
        Qs = sample_patches(img2, centers + u, ps, pad, prm.patch_normalization)
        Q = torch.where(active[:, None], Qs, Q)
        done = active & policed
        if fixed:
            done = done | (active & (_norm(d0, d1) < prm.conv_eps))
        converged = converged | done
        if it > prm.iterations:
            break
    return u, trips


def fixed_weights(img2, T, centers, u, init_u, prm: Params, width: int, height: int):
    """Residual-adaptive densification weights ``1 / max(1, |Q - Tn|^2)``;
    1.0 for patches whose start lies out of bounds."""
    ps, pad = prm.patch_size, prm.img_padding
    Q = sample_patches(img2, centers + u, ps, pad, prm.patch_normalization)
    Tn = T - patch_mean(T) if prm.patch_normalization else T
    r2 = tree_sum((Q - Tn) ** 2)
    w = 1.0 / torch.clamp(r2, min=1.0)
    p0 = centers + init_u
    lb = -float(ps) / 2.0
    oob = ((p0[:, 0] < lb) | (p0[:, 1] < lb) | (p0[:, 0] > float(width + ps // 2 - 2))
           | (p0[:, 1] > float(height + ps // 2 - 2)))
    return torch.where(oob, torch.ones_like(w), w)


def _covers(n_out: int, n_grid: int, off: int, steps: int, ps: int, device):
    """[n_out, K]: for each output row (or column), the grid rows (or
    columns) whose footprint covers it, increasing, padded with
    ``n_grid`` (a zero entry)."""
    half = ps // 2
    rows = []
    for y in range(n_out):
        # Patch i covers [off + i*steps - half, off + i*steps - half + ps).
        lo = max(0, (y - off + half - ps) // steps + 1)
        hi = min(n_grid, (y - off + half) // steps + 1)
        rows.append(list(range(lo, hi)))
    k = max(1, max(len(r) for r in rows))
    return torch.tensor([r + [n_grid] * (k - len(r)) for r in rows], device=device)


def _stencil(x: torch.Tensor, cov_rows: torch.Tensor, cov_cols: torch.Tensor):
    """Footprint sums of grid values x [nph, npw, C]: each output row sums
    its covering grid rows, then each output column its covering grid
    columns, each in increasing order."""
    xz = torch.cat([x, torch.zeros_like(x[:1])], 0)
    acc = xz[cov_rows[:, 0]]
    for k in range(1, cov_rows.shape[1]):
        acc = acc + xz[cov_rows[:, k]]
    az = torch.cat([acc, torch.zeros_like(acc[:, :1])], 1)
    out = az[:, cov_cols[:, 0]]
    for k in range(1, cov_cols.shape[1]):
        out = out + az[:, cov_cols[:, k]]
    return out


def densify(u, weights, width: int, height: int, prm: Params):
    """Each pixel's weighted mean of the flows of the patches covering it
    (weight 0.5 each without ``weights``); pixels no patch covers stay 0.
    The footprint is separable, so the sums run over rows, then columns,
    in increasing grid order: deterministic, with no atomics."""
    ps, steps = prm.patch_size, prm.steps
    npw, nph, offw, offh = grid_shape(width, height, steps)
    ug = u.reshape(npw, nph, 2).transpose(0, 1)           # [nph, npw, 2]
    if weights is None:
        wg = torch.full((nph, npw, 1), 0.5, dtype=u.dtype, device=u.device)
    else:
        wg = weights.reshape(npw, nph).transpose(0, 1)[..., None]
    cov_r = _covers(height, nph, offh, steps, ps, u.device)
    cov_c = _covers(width, npw, offw, steps, ps, u.device)
    fsum = _stencil(ug * wg, cov_r, cov_c)
    wsum = _stencil(wg, cov_r, cov_c)
    nz = wsum > 0
    return torch.where(nz, fsum / torch.where(nz, wsum, torch.ones_like(wsum)),
                       torch.zeros_like(fsum))


# --- the variational refinement ---------------------------------------------


def _warp_bilinear(planes: List[torch.Tensor], flow: torch.Tensor):
    """Each plane sampled at x + flow with edge clamping, and the mask of
    positions inside the plane."""
    h, w = flow.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device), indexing="ij")
    fx = xs.to(flow.dtype) + flow[..., 0]
    fy = ys.to(flow.dtype) + flow[..., 1]
    inb = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    fxc, fyc = fx.clamp(0.0, w - 1.0), fy.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(fxc), torch.floor(fyc)
    a, b = fxc - x0, fyc - y0
    # In float32 the clamps below change nothing; in a lower precision
    # w - 1 may round up past the plane.
    x0, y0 = x0.long().clamp(0, w - 1), y0.long().clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    out = []
    for p in planes:
        out.append((1 - a) * (1 - b) * p[y0, x0] + a * (1 - b) * p[y0, x1]
                   + (1 - a) * b * p[y1, x0] + a * b * p[y1, x1])
    return out, inb


def _psi_deriv(s2, eps2: float):
    return 0.5 * torch.rsqrt(s2 + eps2)


def refine(I1: torch.Tensor, I2: torch.Tensor, flow: torch.Tensor,
           prm: Params) -> torch.Tensor:
    """Refine ``flow`` [h, w, 2] on the planes I1, I2 [h, w]: IRLS outer
    warps, lagged robust weights and red-black block-SOR half-sweeps."""
    h, w = flow.shape[:2]
    I1x, I1y = sobel3(I1, "x"), sobel3(I1, "y")
    warp1 = prm.refinement_scheme == "warp1"
    if warp1:
        planes = [I2]
    else:
        I2x, I2y = sobel3(I2, "x"), sobel3(I2, "y")
        planes = [I2, I2x, I2y, sobel3(I2x, "x"), sobel3(I2x, "y"), sobel3(I2y, "y")]
    alpha, delta = prm.refinement_alpha, prm.refinement_delta
    gamma, omega = prm.refinement_gamma, prm.refinement_omega
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device), indexing="ij")
    red = (xs + ys) % 2 == 0
    black = ~red
    for _ in range(prm.refinement_iters):
        u0, v0 = flow[..., 0], flow[..., 1]
        warped, inb = _warp_bilinear(planes, flow)
        if warp1:
            W = warped[0]
            Wxr, Wyr = sobel3(W, "x"), sobel3(W, "y")
            Wx, Wy = 0.5 * (I1x + Wxr), 0.5 * (I1y + Wyr)
            Iz, Izx, Izy = W - I1, Wxr - I1x, Wyr - I1y
            Wxx, Wxy, Wyy = sobel3(Wx, "x"), sobel3(Wx, "y"), sobel3(Wy, "y")
        else:
            W, Wx, Wy, Wxx, Wxy, Wyy = warped
            Iz, Izx, Izy = W - I1, Wx - I1x, Wy - I1y
        m = inb.to(flow.dtype)
        du, dv = torch.zeros_like(u0), torch.zeros_like(v0)
        for _ in range(prm.refinement_inner_sweeps):
            r_d = Iz + Wx * du + Wy * dv
            wd = delta * _psi_deriv(r_d * r_d, EPS2_DATA) * m
            r_gx = Izx + Wxx * du + Wxy * dv
            r_gy = Izy + Wxy * du + Wyy * dv
            wg = gamma * _psi_deriv(r_gx * r_gx + r_gy * r_gy, EPS2_DATA) * m
            U, V = u0 + du, v0 + dv
            Ux, Uy = _shift_edge(U, 0, 1) - U, _shift_edge(U, 1, 0) - U
            Vx, Vy = _shift_edge(V, 0, 1) - V, _shift_edge(V, 1, 0) - V
            ws_c = alpha * _psi_deriv(Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy, EPS2_SMOOTH)
            wE = 0.5 * (ws_c + _shift_edge(ws_c, 0, 1))
            wW = 0.5 * (ws_c + _shift_edge(ws_c, 0, -1))
            wS = 0.5 * (ws_c + _shift_edge(ws_c, 1, 0))
            wN = 0.5 * (ws_c + _shift_edge(ws_c, -1, 0))
            S = wE + wW + wS + wN
            A11 = wd * Wx * Wx + wg * (Wxx * Wxx + Wxy * Wxy) + S
            A12 = wd * Wx * Wy + wg * (Wxy * (Wxx + Wyy))
            A22 = wd * Wy * Wy + wg * (Wxy * Wxy + Wyy * Wyy) + S
            b1c = -(wd * Wx * Iz + wg * (Wxx * Izx + Wxy * Izy))
            b2c = -(wd * Wy * Iz + wg * (Wxy * Izx + Wyy * Izy))
            det = A11 * A22 - A12 * A12
            det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)

            def neighbours(X):
                return (wE * _shift_edge(X, 0, 1) + wW * _shift_edge(X, 0, -1)
                        + wS * _shift_edge(X, 1, 0) + wN * _shift_edge(X, -1, 0))

            for _ in range(prm.refinement_sor_sweeps):
                for mask in (red, black):
                    b1 = b1c + neighbours(u0 + du) - S * u0
                    b2 = b2c + neighbours(v0 + dv) - S * v0
                    du_new = (A22 * b1 - A12 * b2) / det
                    dv_new = (A11 * b2 - A12 * b1) / det
                    if omega != 1.0:
                        du_new = du + omega * (du_new - du)
                        dv_new = dv + omega * (dv_new - dv)
                    du = torch.where(mask, du_new, du)
                    dv = torch.where(mask, dv_new, dv)
        flow = torch.stack([u0 + du, v0 + dv], -1)
    return flow


def motion_bound(prm: Params, scale: int) -> float:
    """The largest |u| the policing chain allows at ``scale``."""
    b = prm.outlier_thresh
    for _ in range(prm.coarsest_scale - scale):
        b = 2.0 * b + prm.outlier_thresh
    return b


# --- the pipeline ------------------------------------------------------------


def flow_padded(img1: torch.Tensor, img2: torch.Tensor, prm: Params,
                trips: Optional[Trips] = None) -> torch.Tensor:
    """The flow at ``finest_scale`` of a pair whose dims divide by
    ``2**coarsest_scale``."""
    h, w = img1.shape
    ps, pad = prm.patch_size, prm.img_padding
    dt = img1.dtype
    pyr1 = construct_pyramid(img1, prm.coarsest_scale, pad)
    pyr2 = construct_pyramid(img2, prm.coarsest_scale, pad)
    refining = prm.refinement_iters > 0
    planes = None
    if refining and prm.refinement_planes == "intensity":
        planes = [[img1], [img2]]
        for _ in range(prm.coarsest_scale):
            planes[0].append(resize_half(planes[0][-1]))
            planes[1].append(resize_half(planes[1][-1]))

    def refine_at(flow, scale):
        sh, sw = flow.shape[:2]
        if planes is None:
            I1 = pyr1[scale][0][pad:pad + sh, pad:pad + sw]
            I2 = pyr2[scale][0][pad:pad + sh, pad:pad + sw]
        else:
            I1, I2 = planes[0][scale], planes[1][scale]
        return refine(I1, I2, flow, prm)

    flow = None
    for scale in range(prm.coarsest_scale, prm.finest_scale - 1, -1):
        sw, sh = w >> scale, h >> scale
        centers = grid_centers(sw, sh, prm.steps, dt, img1.device)
        img, dx, dy = pyr1[scale]
        T, Tdx, Tdy = extract_templates(img, dx, dy, centers, ps, pad)
        H = hessians(Tdx, Tdy)
        if flow is None:
            init_u = torch.zeros_like(centers)
        else:
            cx = torch.floor(centers[:, 0].float() / 2).long().clamp(0, flow.shape[1] - 1)
            cy = torch.floor(centers[:, 1].float() / 2).long().clamp(0, flow.shape[0] - 1)
            init_u = flow[cy, cx] * 2.0
        u, n_trips = inverse_search(pyr2[scale][0], T, Tdx, Tdy, H, centers, init_u,
                                    prm, sw, sh)
        if trips is not None:
            trips.scales.append((scale, centers.shape[0], n_trips, (sh, sw)))
        wts = None
        if prm.mode == "fixed":
            wts = fixed_weights(pyr2[scale][0], T, centers, u, init_u, prm, sw, sh)
        flow = densify(u, wts, sw, sh, prm)
        if refining and prm.refine_per_level:
            flow = refine_at(flow, scale)
            if prm.refined_init_clamp:
                b = motion_bound(prm, scale)
                flow = flow.clamp(-b, b)
    if refining and not prm.refine_per_level:
        flow = refine_at(flow, prm.finest_scale)
    return flow


def pad_divisible(img: torch.Tensor, coarsest: int):
    """Replicate-pad to dims divisible by ``2**coarsest``, the extra row or
    column on the bottom or right; returns (padded, (padw, padh))."""
    h, w = img.shape
    f = 2 ** coarsest
    padw, padh = (f - w % f) % f, (f - h % f) % f
    if padw or padh:
        img = replicate_pad(img, padh // 2, padh - padh // 2, padw // 2, padw - padw // 2)
    return img, (padw, padh)


def flow(img1: torch.Tensor, img2: torch.Tensor, prm: Params,
         dtype: torch.dtype = torch.float32,
         trips: Optional[Trips] = None) -> torch.Tensor:
    """The flow [H, W, 2] of one pair [H, W]: the divisibility pad, the
    pipeline, the finest scale's scale-up and bilinear upsample, and the
    crop; computed in ``dtype``, returned in float32."""
    h, w = img1.shape
    p1, (padw, padh) = pad_divisible(img1.to(dtype), prm.coarsest_scale)
    p2, _ = pad_divisible(img2.to(dtype), prm.coarsest_scale)
    out = flow_padded(p1, p2, prm, trips)
    if prm.finest_scale != 0:
        out = resize_bilinear(out * float(2 ** prm.finest_scale), p1.shape[1], p1.shape[0])
    t, l = padh // 2, padw // 2
    return out[t:t + h, l:l + w].to(torch.float32)
