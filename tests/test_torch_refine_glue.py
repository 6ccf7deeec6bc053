"""The last device glue as kernels (R0, R1's setup and warp1 modes, R23's
compose mode, R3's no-sweep mode, F1-F3) and R23's tiles on the CPU.

A refinement level's Sobel planes (R0, ``refine_planes_plain``), the
weight update's inputs that R1 writes in its setup mode
(``refine_setup_plain``) and, under the ``warp1`` scheme, in its warp1
mode (``refine_setup_warp1_plain``), the flow that R23 writes in its
compose mode (``refine_compose_plain`` last, clipped to a bound where
``refined_init_clamp`` asks) and R3 in its no-sweep mode
(``refine_nosweep_plain``), the frame's padding (F1,
``frame_pad_plain``), the refinement's intensity levels (F2,
``intensity_levels_plain``) and the finest flow's upsample and crop (F3,
``frame_finish_plain``) are plain torch versions of hand-written CUDA
kernels (``csrc/refine_planes.cu``, ``csrc/variational.cu``,
``csrc/frame_glue.cu``).  On ``numpy.random.default_rng`` inputs, odd
and even sizes down to 2 x 2, B absent and 3:

- each plain version is bitwise the JAX package's function on the CPU
  (``sobel3`` chains and ``jnp.stack``; ``pad_divisible``;
  ``intensity_pyramid`` through its ``window2`` route, whose association
  the port uses; the scale, ``resize_bilinear`` and ``crop_padding``),
  pair by pair;
- R1's setup and warp1 modes, the end of R23's compose mode (with and
  without its clip) and R3's no-sweep mode are bitwise the composition
  they replaced
  (verbatim copies below), R1's warp1 mode also on windows of one row or
  column, the clip also on NaN, -0.0 and values past the bound;
- R23's tiles (``update_plan``, a halo of nh half-sweeps before a
  tile's interior and nh + 1 after it), emulated with the plain versions
  on each tile's window (``refine_update_tiled``), are bitwise the
  untiled weight update (``refine_update_plain``): a 1080p medium cell's
  coarsest level (34 x 60), as tiles and as one tile, odd sizes, a plane
  smaller than a tile, B = 2, 1 and 5 sweeps, omega 1.0 and 1.6, with
  and without the compose mode's clip, and updates split over launches;
  a halo one pixel narrower on either side is not; every plan's tiles
  fit a block and cover the plane;
- every new op passes ``torch.library.opcheck`` within ``ops_on_cpu``
  (R1's setup mode, R23 and R3's no-sweep mode with a pair axis and
  without one, the form the stream cells launch), and its wrapper
  refuses there what the plain version refuses (dims that
  do not halve), and a window of one row or column, which both take, gives
  the Sobels of a NumPy reflect reference;
- one refinement level of ``DIS_MEDIUM`` and of ``DIS_FULL`` within
  ``ops_on_cpu`` (R0, R1, and R23 once a weight update) dispatches no
  ATen op outside ``dis_tpu_torch::`` ops,
  views aside (54 before these kernels under ``planes6``, about 40 a warp
  under ``warp1``), under either scheme, clamped (``refine_level`` with
  ``refined_init_clamp``) and without a half-sweep, and a whole
  ``dis_flow`` that pads and upsamples (``DIS_ULTRAFAST``) none either.

The kernels themselves run on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phases 1e and 1g).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dis_tpu_torch
from dis_tpu.ops import image as jim
from dis_tpu.ops import pyramid as jpyr
from dis_tpu_torch.ops import cuda as kops
from dis_tpu_torch.ops import image as tim
from dis_tpu_torch.ops import pyramid as tpyr
from dis_tpu_torch.ops import variational as tvar
from dis_tpu_torch.ops.cuda import frame_kernel as fk
from dis_tpu_torch.ops.cuda import refine_kernel as rk

from torch_threads import one_thread

SHAPES = [(2, 2), (2, 7), (5, 2), (9, 13), (16, 24), (37, 53)]
BATCHES = [None, 3]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _planes(batch, h, w, seed, scale=255.0):
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    return (rng.random(lead + (h, w)) * scale).astype(np.float32)


def _pairs(x, batched):
    """The pairs of a batch (or the one array) as NumPy arrays."""
    return list(x) if batched else [x]


def _check_pairwise(got, x_np, jax_fn, batched):
    """``got`` [(B,) ...] torch equals ``jax_fn`` of each pair bitwise."""
    for i, xi in enumerate(_pairs(x_np, batched)):
        want = np.asarray(jax_fn(xi))
        np.testing.assert_array_equal((got[i] if batched else got).numpy(), want)


class _CountOps(TorchDispatchMode):
    """Counts the ops one call dispatches: ``dis_tpu_torch`` ops by name
    (``calls``), and non-view ATen ops (``aten``)."""

    def __enter__(self):
        self.calls, self.aten = {}, {}
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "dis_tpu_torch":
            name = func.name().split("::")[1].split(".")[0]
            self.calls[name] = self.calls.get(name, 0) + 1
        elif func.namespace == "aten" and not func.is_view:
            name = func.name()
            self.aten[name] = self.aten.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# -- R0: the level's Sobel planes --------------------------------------------------

def _jax_planes(i1, i2):
    I1x, I1y = jim.sobel3(i1, "x"), jim.sobel3(i1, "y")
    I2x, I2y = jim.sobel3(i2, "x"), jim.sobel3(i2, "y")
    stack = jnp.stack([i2, I2x, I2y, jim.sobel3(I2x, "x"), jim.sobel3(I2x, "y"),
                       jim.sobel3(I2y, "y")], axis=-1)
    return I1x, I1y, stack


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("p", [0, 3])
def test_refine_planes_plain_bitwise_vs_jax(shape, batch, p):
    """R0's plain version on the windows at offset ``p`` equals the JAX
    package's Sobel chains and stack on the same windows."""
    h, w = shape
    a = _planes(batch, h + 2 * p, w + 2 * p, sum(shape))
    b = _planes(batch, h + 2 * p, w + 2 * p, sum(shape) + 1)
    got = tvar.refine_planes_plain(torch.from_numpy(a), torch.from_numpy(b), p, h, w)
    assert tuple(got[2].shape) == a.shape[:-2] + (h, w, 6)
    win = (Ellipsis, slice(p, p + h), slice(p, p + w))
    for i, (ai, bi) in enumerate(zip(_pairs(a[win], batch), _pairs(b[win], batch))):
        for g, v in zip(got, _jax_planes(jnp.asarray(ai), jnp.asarray(bi))):
            np.testing.assert_array_equal((g if batch is None else g[i]).numpy(),
                                          np.asarray(v))


def _np_sobel3(x, axis):
    """``sobel3`` in NumPy on ``np.pad(mode="reflect")`` (the NumPy oracle's
    border, which repeats a plane of one row or column)."""
    p = np.pad(x, 1, mode="reflect")
    if axis == "x":
        d = p[:, 2:] - p[:, :-2]
        out = d[:-2, :] + 2.0 * d[1:-1, :] + d[2:, :]
    else:
        d = p[2:, :] - p[:-2, :]
        out = d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]
    return out * np.float32(0.125)


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (1, 1)])
def test_refine_planes_refuses_a_window_of_one(shape):
    """A window of one row or column (a coarse level of a small frame):
    R0's plain version, and its wrapper within ``ops_on_cpu`` (the CUDA
    path's checks), give the Sobel chains of a NumPy reflect reference,
    bitwise, padded windows and whole planes alike; the wrapper still
    refuses a window outside the planes."""
    h, w = shape
    for p in (0, 2):
        a, b = (torch.from_numpy(_planes(None, h + 2 * p, w + 2 * p, s)) for s in (1, 2))
        i1, i2 = a.numpy()[p:p + h, p:p + w], b.numpy()[p:p + h, p:p + w]
        i2x, i2y = _np_sobel3(i2, "x"), _np_sobel3(i2, "y")
        want = (_np_sobel3(i1, "x"), _np_sobel3(i1, "y"),
                np.stack([i2, i2x, i2y, _np_sobel3(i2x, "x"), _np_sobel3(i2x, "y"),
                          _np_sobel3(i2y, "y")], axis=-1))
        got = tvar.refine_planes_plain(a, b, p, h, w)
        with kops.ops_on_cpu():
            wrapped = rk.refine_planes(a, b, p, h, w)
        for g, k, v in zip(got, wrapped, want):
            np.testing.assert_array_equal(g.numpy(), v)
            np.testing.assert_array_equal(k.numpy(), v)
    with kops.ops_on_cpu(), pytest.raises(ValueError, match="outside"):
        a = torch.zeros(6, 6)
        rk.refine_planes(a, a, 3, 4, 4)


# -- R1's setup mode and R23's compose-mode end ----------------------------------------

def _composition_setup(planes, flow, I1, I1x, I1y):
    """The weight update's inputs as the refinement made them before R1's
    setup mode (a verbatim copy of the loop's body)."""
    flow = flow.contiguous()
    u0, v0 = (c.contiguous() for c in flow.unbind(-1))
    warped, inb = tvar.refine_warp_plain(planes, flow)
    W, Wx, Wy, Wxx, Wxy, Wyy = warped.unbind(-1)
    Iz = W - I1
    Izx = Wx - I1x
    Izy = Wy - I1y
    m = inb.to(torch.float32)
    du = torch.zeros_like(u0)
    dv = torch.zeros_like(v0)
    return Iz, Izx, Izy, Wx, Wy, Wxx, Wxy, Wyy, m, u0, v0, du, dv


def _setup_inputs(batch, h, w, p, seed):
    a = torch.from_numpy(_planes(batch, h + 2 * p, w + 2 * p, seed))
    b = torch.from_numpy(_planes(batch, h + 2 * p, w + 2 * p, seed + 1))
    I1x, I1y, planes = tvar.refine_planes_plain(a, b, p, h, w)
    lead = () if batch is None else (batch,)
    flow = torch.from_numpy(((np.random.default_rng(seed + 2).random(lead + (h, w, 2)) - 0.5)
                             * 9).astype(np.float32))
    return planes, flow, a, I1x, I1y, p


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("p", [0, 3])
def test_setup_plain_is_the_composition(shape, batch, p):
    """R1's setup mode's plain version is bitwise the warp, differences,
    mask and zero increments it replaced, and the op's CPU function
    stacks them in R23's input order."""
    args = _setup_inputs(batch, *shape, p, sum(shape))
    planes, flow, a, I1x, I1y, _ = args
    h, w = shape
    want = _composition_setup(planes, flow, a[..., p:p + h, p:p + w], I1x, I1y)
    got = tvar.refine_setup_plain(*args)
    assert len(got) == len(rk.WEIGHT_INPUTS) == 13
    assert all(g.shape == v.shape and torch.equal(g, v) for g, v in zip(got, want))
    assert torch.equal(rk.refine_setup_op(*args), torch.stack(want))


def _sor_args(batch, h, w, seed):
    planes, flow, a, I1x, I1y, p = _setup_inputs(batch, h, w, 0, seed)
    ins = tvar.refine_setup_plain(planes, flow, a, I1x, I1y, p)
    rng = np.random.default_rng(seed + 3)
    du, dv = (torch.from_numpy((rng.standard_normal(ins[0].shape) * 0.05).astype(np.float32))
              for _ in range(2))
    coef = tvar.refine_weights_plain(*ins[:11], du, dv, 40.0, 5.0, 10.0)
    return (ins[9], ins[10], du, dv, *coef)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("omega", [1.0, 1.6])
def test_compose_plain_is_the_composition(shape, batch, color, omega):
    """The plain version of R23's compose-mode end is bitwise the
    half-sweep then ``stack([u0 + du, v0 + dv])`` it replaced."""
    args = _sor_args(batch, *shape, sum(shape) + color)
    du, dv = tvar.refine_sor_plain(*args, color, omega)
    want = torch.stack([args[0] + du, args[1] + dv], dim=-1)
    assert torch.equal(tvar.refine_compose_plain(*args, color, omega), want)


def _bits(t):
    """The float32 bits of ``t``: equal bits, equal NaNs and signed zeros."""
    return t.contiguous().view(torch.int32)


def _composition_warp1(img2, flow, img1, p):
    """The ``warp1`` scheme's weight-update inputs as the refinement made them
    before R1's warp1 mode: the level's I1 Sobels and I2 copy, then
    ``_warp1_inputs`` with R1's warp (verbatim copies)."""
    h, w = flow.shape[-3:-1]
    I1 = img1[..., p:p + h, p:p + w]
    I1x = tim.sobel3(I1, "x")
    I1y = tim.sobel3(I1, "y")
    planes = img2[..., p:p + h, p:p + w].contiguous()[..., None]
    flow = flow.contiguous()
    u0, v0 = (c.contiguous() for c in flow.unbind(-1))
    warped, inb = tvar.refine_warp_plain(planes, flow)
    W = warped[..., 0]
    Wxr = tim.sobel3(W, "x")
    Wyr = tim.sobel3(W, "y")
    Wx = 0.5 * (I1x + Wxr)
    Wy = 0.5 * (I1y + Wyr)
    Wxx = tim.sobel3(Wx, "x")
    Wxy = tim.sobel3(Wx, "y")
    Wyy = tim.sobel3(Wy, "y")
    return (W - I1, Wxr - I1x, Wyr - I1y, Wx, Wy, Wxx, Wxy, Wyy, inb.to(torch.float32),
            u0, v0, torch.zeros_like(u0), torch.zeros_like(v0))


def _warp1_args(batch, h, w, p, seed):
    """R1w's arguments: two level planes and a flow of up to 4.5 px, which
    reaches past every edge."""
    a = torch.from_numpy(_planes(batch, h + 2 * p, w + 2 * p, seed))
    b = torch.from_numpy(_planes(batch, h + 2 * p, w + 2 * p, seed + 1))
    lead = () if batch is None else (batch,)
    flow = torch.from_numpy(((np.random.default_rng(seed + 2).random(lead + (h, w, 2)) - 0.5)
                             * 9).astype(np.float32))
    return b, flow, a, p


def _check_warp1(args):
    want = _composition_warp1(*args)
    got = tvar.refine_setup_warp1_plain(*args)
    assert len(got) == len(rk.WEIGHT_INPUTS) == 13
    assert all(g.shape == v.shape and torch.equal(_bits(g), _bits(v)) for g, v in zip(got, want))
    assert torch.equal(rk.refine_setup_warp1_op(*args), torch.stack(want))
    with kops.ops_on_cpu():
        routed = rk.refine_setup_warp1(*args)
    assert all(torch.equal(g, v) for g, v in zip(routed, want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("p", [0, 3])
def test_setup_warp1_plain_is_the_composition(shape, batch, p):
    """R1's warp1 mode's plain version is bitwise the level's I1 Sobels and
    the warp, Sobels, means, differences, mask and zero increments of each
    outer iteration that it replaced, in R23's input order; so are the op's
    CPU function and the wrapper within ``ops_on_cpu``."""
    _check_warp1(_warp1_args(batch, *shape, p, sum(shape) + p))


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (1, 1)])
def test_setup_warp1_takes_a_window_of_one(shape):
    """A window of one row or column, or of one pixel (a coarse level of a
    small frame), padded and whole, B absent and 2: the same bits."""
    for p in (0, 3):
        for batch in (None, 2):
            _check_warp1(_warp1_args(batch, *shape, p, 7 + p))
    with kops.ops_on_cpu(), pytest.raises(ValueError, match="no window"):
        a = torch.zeros(6, 6)
        rk.refine_setup_warp1(a, torch.zeros(4, 4, 2), a, 3)


def _edge_values(*planes):
    """Copies of ``planes`` with a NaN, a -0.0 and values far past any bound
    written into their first pixels."""
    out = [t.clone() for t in planes]
    for k, t in enumerate(out):
        flat = t.view(-1)
        flat[k % flat.numel()] = float("nan") if k == 0 else -0.0
        flat[-1] = 1e4 * (-1) ** k
    return out


@pytest.mark.parametrize("shape", [(1, 1), (5, 2), (9, 13)])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("bound", [0.5, 2.0, 1e5])
def test_compose_clip_is_compose_then_clamp(shape, batch, bound):
    """The compose-mode end with a bound is bitwise the compose, then
    ``clamp(-bound, bound)`` as ``refine_level`` clipped it (both colours,
    omega 1.0 and 1.6; a NaN, -0.0 and +-1e4 among u0, v0, du and dv)."""
    args = _sor_args(batch, *shape, sum(shape))
    args = (*_edge_values(*args[:4]), *args[4:])
    for color in (0, 1):
        for omega in (1.0, 1.6):
            plain = tvar.refine_compose_plain(*args, color, omega)
            want = plain.clamp(-bound, bound)
            got = tvar.refine_compose_plain(*args, color, omega, bound)
            assert torch.equal(_bits(got), _bits(want))
    if bound < 1e4 and shape != (1, 1):   # (a 1 x 1 plane holds +-1e4 only)
        assert bool((want.abs() == bound).any()) and bool(want.isnan().any())


@pytest.mark.parametrize("shape", [(1, 1), (5, 2), (9, 13)])
@pytest.mark.parametrize("batch", BATCHES)
def test_nosweep_plain_is_the_stack(shape, batch):
    """R3's no-sweep mode's plain version is bitwise the ``torch.stack([u0 +
    du, v0 + dv])`` it replaced, and with a bound that stack then
    ``clamp(-bound, bound)``: a NaN passes, -0.0 + -0.0 stays -0.0, values
    past the bound clip; also through the op."""
    u0, v0, du, dv = _edge_values(*_sor_args(batch, *shape, sum(shape))[:4])
    want = torch.stack([u0 + du, v0 + dv], dim=-1)
    assert torch.equal(_bits(tvar.refine_nosweep_plain(u0, v0, du, dv)), _bits(want))
    assert torch.equal(_bits(rk.refine_nosweep_op(u0, v0, du, dv, False, 0.0)), _bits(want))
    assert bool(torch.signbit(want).any())
    for bound in (0.5, 3.0):
        clipped = want.clamp(-bound, bound)
        assert torch.equal(_bits(tvar.refine_nosweep_plain(u0, v0, du, dv, bound)),
                           _bits(clipped))
        assert torch.equal(_bits(rk.refine_nosweep_op(u0, v0, du, dv, True, bound)),
                           _bits(clipped))
        assert bool((clipped.abs() == bound).any())


# -- F1, F2, F3: the frame's glue ----------------------------------------------------

FRAMES = [(2, 2), (5, 7), (16, 24), (37, 53), (75, 118)]


@pytest.mark.parametrize("shape", FRAMES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("coarsest", [1, 3, 4])
def test_frame_pad_plain_bitwise_vs_jax(shape, batch, coarsest):
    """F1's plain version pads both images as the JAX package's
    ``pad_divisible`` pads each, with its pads."""
    a, b = _planes(batch, *shape, 1), _planes(batch, *shape, 2)
    p1, p2, pads = tim.frame_pad_plain(torch.from_numpy(a), torch.from_numpy(b), coarsest)
    assert pads == jim.pad_divisible(jnp.asarray(_pairs(a, batch)[0]), coarsest)[1]
    _check_pairwise(p1, a, lambda x: jim.pad_divisible(jnp.asarray(x), coarsest)[0], batch)
    _check_pairwise(p2, b, lambda x: jim.pad_divisible(jnp.asarray(x), coarsest)[0], batch)


@pytest.mark.parametrize("unit", [(1, 1), (3, 5), (6, 10)])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("coarsest", [0, 1, 3, 4])
def test_intensity_levels_plain_bitwise_vs_jax(unit, batch, coarsest, monkeypatch):
    """F2's plain version gives both images' chains, each bitwise the JAX
    package's ``intensity_pyramid`` (its ``window2`` route), on planes of
    ``unit`` times ``2**coarsest`` (2 x 2 the smallest that halves);
    level 0 is the image itself."""
    shape = tuple(u << coarsest for u in unit)
    monkeypatch.setenv("DIS_TPU_RESIZE", "window2")
    a, b = _planes(batch, *shape, 3), _planes(batch, *shape, 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got1, got2 = tpyr.intensity_levels_plain(ta, tb, coarsest)
    assert got1[0] is ta and got2[0] is tb and len(got1) == len(got2) == coarsest + 1
    for got, x in ((got1, a), (got2, b)):
        for s in range(coarsest + 1):
            _check_pairwise(got[s], x,
                            lambda xi: jpyr.intensity_pyramid(jnp.asarray(xi), coarsest)[s],
                            batch)


def test_intensity_levels_refuse_dims_that_do_not_halve():
    """``resize_half`` refuses odd dims; within ``ops_on_cpu`` F2's wrapper
    refuses dims not divisible by ``2**coarsest`` before any launch."""
    a = torch.zeros(12, 20)
    with pytest.raises(ValueError, match="even dims"):
        tpyr.intensity_levels_plain(a, a, 3)
    with kops.ops_on_cpu(), pytest.raises(ValueError, match="divisible"):
        fk.intensity_levels(a, a, 3)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("finest", [0, 1, 2])
def test_frame_finish_plain_bitwise_vs_jax(frame, batch, finest):
    """F3's plain version equals the JAX package's scale, ``resize_bilinear``
    and ``crop_padding`` of the finest flow of a frame padded for
    ``coarsest_scale`` 3, pair by pair."""
    hh, ww = frame
    ph, pw = -(-hh // 8) * 8, -(-ww // 8) * 8
    lead = () if batch is None else (batch,)
    flow = (np.random.default_rng(hh + finest).standard_normal(
        lead + (ph >> finest, pw >> finest, 2)) * 5).astype(np.float32)
    got = tim.frame_finish_plain(torch.from_numpy(flow), finest, pw - ww, ph - hh, ww, hh)
    assert tuple(got.shape) == lead + (hh, ww, 2)

    def jax_finish(f):
        f = jnp.asarray(f)
        if finest:
            f = jim.resize_bilinear(f * jnp.float32(2 ** finest), pw, ph)
        return jim.crop_padding(f, pw - ww, ph - hh, ww, hh)

    _check_pairwise(got, flow, jax_finish, batch)


def test_frame_wrappers_launch_nothing_where_nothing_runs():
    """F1 returns a frame that needs no padding as it is, F3 at finest
    scale 0 the crop as a view, F2 at coarsest scale 0 the images: within
    ``ops_on_cpu`` none dispatches its op."""
    a = torch.from_numpy(_planes(None, 16, 24, 5))
    flow = torch.zeros(16, 24, 2)
    with _CountOps() as ops, kops.ops_on_cpu():
        p1, p2, pads = fk.frame_pad(a, a, 3)
        crop = fk.frame_finish(flow, 0, 0, 0, 24, 16)
        l1, l2 = fk.intensity_levels(a, a, 0)
    assert ops.calls == {} and ops.aten == {}
    assert p1 is a and p2 is a and pads == (0, 0)
    assert crop.data_ptr() == flow.data_ptr() and l1 == [a] and l2 == [a]


# -- R23: a weight update on tiles ------------------------------------------------------

def _update_args(batch, h, w, seed):
    """R23's thirteen planes: R1's setup mode's, with increments of a few
    hundredths."""
    planes, flow, a, I1x, I1y, p = _setup_inputs(batch, h, w, 0, seed)
    ins = tvar.refine_setup_plain(planes, flow, a, I1x, I1y, p)
    rng = np.random.default_rng(seed + 5)
    du, dv = (torch.from_numpy((rng.standard_normal(ins[0].shape) * 0.05).astype(np.float32))
              for _ in range(2))
    return (*ins[:11], du, dv)


# (batch, h, w, the pixel pairs a tile may hold, multiprocessors): a 1080p
# medium cell's coarsest level on the H100's tiles and as one tile (one
# multiprocessor: no tile spreads the work), odd sizes whose half-sweeps
# split over launches at 5 sweeps, a plane smaller than one tile, and two
# pairs on tiles of a halo and a few rows and columns of interior, one
# half-sweep a launch.
TILE_CASES = {"34x60": (None, 34, 60, tvar.UPDATE_CAPACITY, tvar.H100_SMS),
              "34x60_one_tile": (None, 34, 60, tvar.UPDATE_CAPACITY, 1),
              "37x53_split": (None, 37, 53, 200, tvar.H100_SMS),
              "9x13_one_tile": (None, 9, 13, tvar.UPDATE_CAPACITY, 1),
              "B2_23x37_split": (2, 23, 37, 100, tvar.H100_SMS)}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
@pytest.mark.parametrize("sweeps", [1, 5])
@pytest.mark.parametrize("omega", [1.0, 1.6])
@pytest.mark.parametrize("bound", [None, 0.5])
def test_update_tiles_are_the_untiled_update(case, sweeps, omega, bound):
    """R23's tiling (``update_plan``'s launches and tiles, a halo of nh
    before a tile's interior and nh + 1 after it), emulated with the plain
    versions on each tile's window, is bitwise the untiled update: the
    coefficients, then the half-sweeps, the last one composing the flow (clipped where a
    bound is given), and without the compose mode the new du and dv."""
    batch, h, w, capacity, sms = TILE_CASES[case]
    args = _update_args(batch, h, w, h * w + sweeps)
    plan = tvar.update_plan(batch or 1, h, w, sweeps, capacity, sms)
    assert sum(nh for *_, nh in plan) == 2 * sweeps
    assert (len(plan) > 1) == (case.endswith("split") and sweeps == 5
                               or case.startswith("B2") and sweeps == 1)
    assert (plan[0][:2] == (h, w)) == case.endswith("one_tile")
    for compose in (True, False):
        got = tvar.refine_update_tiled(*args, 20.0, 5.0, 10.0, sweeps, omega, compose,
                                       bound if compose else None, capacity, sms)
        want = tvar.refine_update_plain(*args, 20.0, 5.0, 10.0, sweeps, omega, compose,
                                        bound if compose else None)
        if not compose:
            got, want = torch.stack(got), torch.stack(want)
        assert got.shape == want.shape and torch.equal(_bits(got), _bits(want)), compose


@pytest.mark.parametrize("shrink", ["before", "after"])
def test_update_halo_is_exact(shrink):
    """A halo one pixel narrower before or after a tile's interior than
    R23's (nh, nh + 1) gives other bits: the halo is no wider than the
    update needs."""
    batch, h, w, capacity, sms = TILE_CASES["34x60"]
    args = _update_args(batch, h, w, 11)
    (_, _, _, nh), = tvar.update_plan(1, h, w, 5, capacity, sms)
    halo = (nh - 1, nh + 1) if shrink == "before" else (nh, nh)
    want = tvar.refine_update_plain(*args, 20.0, 5.0, 10.0, 5, 1.6, True)
    exact = tvar.refine_update_tiled(*args, 20.0, 5.0, 10.0, 5, 1.6, True, None, capacity, sms)
    narrow = tvar.refine_update_tiled(*args, 20.0, 5.0, 10.0, 5, 1.6, True, None, capacity, sms,
                                      halo=halo)
    assert torch.equal(exact, want) and not torch.equal(narrow, want)


@pytest.mark.parametrize("nb,h,w,sweeps", [(1, 544, 960, 5), (1, 34, 60, 5), (1, 1088, 1920, 5),
                                          (8, 188, 621, 5), (1, 1, 4000, 5), (1, 544, 960, 12),
                                          (1, 136, 240, 1)])
def test_update_plan_fits_and_covers(nb, h, w, sweeps):
    """Each of ``update_plan``'s launches has tiles whose pixel pairs its
    block's threads can hold, which cover the plane and leave each an
    interior; the launches run the update's half-sweeps in order, all in
    one launch up to 10 sweeps."""
    plan = tvar.update_plan(nb, h, w, sweeps)
    assert [j0 for _, _, j0, _ in plan] == [sum(p[3] for p in plan[:k]) for k in range(len(plan))]
    assert sum(p[3] for p in plan) == 2 * sweeps and (len(plan) == 1) == (sweeps <= 10)
    for ih, iw, _, nh in plan:
        ty, tx = -(-h // ih), -(-w // iw)
        assert 1 <= ih <= h and 1 <= iw <= w
        assert (tvar.tile_pairs(tvar.tile_extent(h, ih, ty, nh), tvar.tile_extent(w, iw, tx, nh))
                <= tvar.UPDATE_CAPACITY)


# -- the ops -----------------------------------------------------------------------

def _opcheck_cases():
    t = torch.from_numpy
    img = lambda b, h, w, s: t(_planes(b, h, w, s))
    setup = _setup_inputs(2, 7, 9, 3, 11)
    sor = _sor_args(2, 6, 9, 12)
    update = _update_args(2, 6, 9, 16)
    single = _update_args(None, 5, 7, 17)
    flow = t((np.random.default_rng(13).standard_normal((2, 6, 8, 2)) * 3).astype(np.float32))
    return [
        ("refine_planes", rk.refine_planes_op, (img(2, 13, 15, 1), img(2, 13, 15, 2), 3, 7, 9)),
        ("refine_planes_1", rk.refine_planes_op, (img(None, 5, 6, 1), img(None, 5, 6, 2), 0,
                                                  5, 6)),
        ("refine_setup", rk.refine_setup_op, setup),
        ("refine_setup_1", rk.refine_setup_op, _setup_inputs(None, 5, 7, 2, 18)),
        ("refine_setup_warp1", rk.refine_setup_warp1_op, _warp1_args(2, 7, 9, 3, 14)),
        ("refine_setup_warp1_1", rk.refine_setup_warp1_op, _warp1_args(None, 1, 5, 0, 15)),
        ("refine_nosweep", rk.refine_nosweep_op, (*sor[:4], False, 0.0)),
        ("refine_nosweep_1", rk.refine_nosweep_op, (*sor[:4], True, 0.5)),
        ("refine_nosweep_2", rk.refine_nosweep_op, (*single[9:], True, 0.5)),
        ("refine_update", rk.refine_update_op, (*update, 40.0, 5.0, 10.0, 2, 1.6, False)),
        ("refine_update_1", rk.refine_update_op, (*update, 40.0, 5.0, 10.0, 1, 1.0, True)),
        ("refine_update_2", rk.refine_update_op, (*update, 40.0, 5.0, 10.0, 3, 1.6, True, True,
                                                  0.5)),
        ("refine_update_3", rk.refine_update_op, (*single, 40.0, 5.0, 10.0, 5, 1.6, True, True,
                                                  0.5)),
        ("frame_pad", fk.frame_pad_op, (img(2, 5, 7, 3), img(2, 5, 7, 4), 1, 2, 0, 1)),
        ("intensity_levels", fk.intensity_levels_op, (img(2, 16, 24, 5), img(2, 16, 24, 6),
                                                      3)),
        ("frame_finish", fk.frame_finish_op, (flow, 1, 1, 2, 9, 13)),
    ]


@pytest.mark.parametrize("case", _opcheck_cases(), ids=lambda c: c[0])
def test_opcheck_new_ops(case):
    """Each new op passes ``torch.library.opcheck`` (its fake function
    against its CPU function, its schema, no mutation) within
    ``ops_on_cpu``."""
    _, op, args = case
    with kops.ops_on_cpu():
        torch.library.opcheck(op, args)


def test_new_ops_priced_and_counted():
    """Each new op has a kernel id in ``cost.KERNELS`` (the modes count as
    R1 and R3) and its wrapper a launch count, which a CPU call leaves
    at 0, as it leaves the counts of the clip and of R23's compose mode."""
    import re

    from dis_tpu_torch import cost

    names = ("refine_planes", "refine_setup", "refine_setup_warp1", "refine_nosweep",
             "refine_update", "frame_pad", "intensity_levels", "frame_finish")
    assert {n: cost.KERNELS[n] for n in names} == {
        "refine_planes": "R0", "refine_setup": "R1", "refine_setup_warp1": "R1",
        "refine_nosweep": "R3", "refine_update": "R23",
        "frame_pad": "F1", "intensity_levels": "F2", "frame_finish": "F3"}
    for case, _, args in _opcheck_cases():
        nbytes, ops = cost.op_cost(re.sub(r"_\d$", "", case), args)
        assert nbytes > 0 and ops >= 0
    wrappers = (rk.refine_planes, rk.refine_setup, rk.refine_setup_warp1,
                rk.refine_nosweep, rk.refine_update, rk.clamped, rk.composed, fk.frame_pad,
                fk.intensity_levels, fk.frame_finish)
    for w in wrappers:
        w.launches = 0
    with kops.ops_on_cpu():
        for _, op, args in _opcheck_cases():
            op(*args)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)


# -- the slice: no torch op left in a refinement level or around the frame ------------

LEVEL_CASES = [(planes, preset, variant) for variant in ("planes6", "warp1", "clamped", "nosweep")
               for preset in ("DIS_MEDIUM", "DIS_FULL") for planes in ("intensity", "q1")]


@pytest.mark.parametrize("planes,preset,variant", LEVEL_CASES,
                         ids=[f"{pl}-{pr}" + ("" if v == "planes6" else f"-{v}")
                              for pl, pr, v in LEVEL_CASES])
def test_refinement_level_dispatches_only_kernel_ops(preset, planes, variant):
    """One refinement level within ``ops_on_cpu`` (as a CUDA tensor
    routes): under ``planes6`` R0 once and R1 once (its setup mode), under
    ``warp1`` R1 once in its warp1 mode and no R0; R23 once a weight
    update (the last in its compose mode); ``clamped``, a ``planes6`` ``refine_level`` with
    ``refined_init_clamp`` at the coarsest scale, whose clip binds, the
    same launches; ``nosweep`` (no weight update) R3 once in its no-sweep
    mode instead; and no ATen op besides (views aside; 54 before these
    kernels, about 40 a warp under ``warp1``), with the bits of the inline
    plain path."""
    import dataclasses
    from types import SimpleNamespace

    from dis_tpu_torch.models import dis as tdis

    cfg = dataclasses.replace(getattr(dis_tpu_torch, preset), refinement_planes=planes,
                              refinement_scheme="warp1" if variant == "warp1" else "planes6",
                              refined_init_clamp=variant == "clamped",
                              refinement_inner_sweeps=(0 if variant == "nosweep" else
                                                       getattr(dis_tpu_torch,
                                                               preset).refinement_inner_sweeps))
    h, w, p = 12, 20, (0 if planes == "intensity" else cfg.img_padding)
    a, b = (torch.from_numpy(_planes(None, h + 2 * p, w + 2 * p, s)) for s in (1, 2))
    flow = torch.from_numpy((np.random.default_rng(3).standard_normal((h, w, 2))
                             * (8 if variant == "clamped" else 2)).astype(np.float32))
    scale = cfg.coarsest_scale
    if variant == "clamped":
        levels = [SimpleNamespace(img=x) for x in (a, b)]
        per_scale = None if planes == "q1" else [{scale: x} for x in (a, b)]

        def run():
            return tdis.refine_level(*levels, flow, cfg, scale, per_scale)
    else:
        def run():
            return tvar.variational_refinement(a, b, flow, cfg, pad=p)
    want = run()
    with _CountOps() as ops, kops.ops_on_cpu():
        got = run()
    updates = cfg.refinement_inner_sweeps
    assert ops.aten == {}
    setup = {"refine_setup_warp1": 1} if variant == "warp1" else {"refine_planes": 1,
                                                                  "refine_setup": 1}
    assert ops.calls == {**setup, **({"refine_update": updates} if updates else
                                     {"refine_nosweep": 1})}
    assert torch.equal(got, want)
    if variant == "clamped":
        bound = tdis.motion_bound(cfg, scale)
        assert float(got.abs().max()) == bound and float(flow.abs().max()) > bound
        assert torch.equal(got, tvar.variational_refinement(a, b, flow, cfg, pad=p)
                           .clamp(-bound, bound))
    if variant == "nosweep":
        assert torch.equal(got, flow)


def test_flow_frame_dispatches_only_kernel_ops():
    """``dis_flow`` on an odd-size frame under ``DIS_ULTRAFAST`` (it pads
    and upsamples) and ``DIS_MEDIUM`` (it pads and refines on the
    intensity levels) within ``ops_on_cpu``: F1 once, F3 or F2 once, and
    besides the kernels' ops only the scale plans' reads and small fills
    of the search, none of them a pad, a resize or a stack."""
    from conftest import synthetic_pair

    a, b = (torch.from_numpy(x) for x in synthetic_pair(45, 61))
    for cfg, frame in ((dis_tpu_torch.DIS_ULTRAFAST, {"frame_pad": 1, "frame_finish": 1}),
                       (dis_tpu_torch.DIS_MEDIUM, {"frame_pad": 1, "intensity_levels": 1})):
        want = dis_tpu_torch.dis_flow(a, b, cfg)
        with _CountOps() as ops, kops.ops_on_cpu():
            got = dis_tpu_torch.dis_flow(a, b, cfg)
        assert {k: v for k, v in ops.calls.items()
                if k in ("frame_pad", "intensity_levels", "frame_finish")} == frame
        assert ops.aten == {}
        assert torch.equal(got, want)


def test_trace_budget_names_every_kernel():
    """The trace budget names each of the port's kernels by its id from
    its function's name in a trace (R3's no-sweep mode and R23 share a
    name, their arguments tell them apart), and none of torch's."""
    from dis_tpu_torch.tools.trace_budget import kernel_id

    names = {
        "void (anonymous namespace)::pyramid_kernel<true>(float const*, int)": "K3",
        "extract_kernel(dis_extract::Args)": "K2", "banded_kernel(dis_extract::Args)": "K2c",
        "iclk_kernel<8, 8, 8>(float const*)": "K1", "planes_kernel(float const*)": "R0",
        "warp_kernel<6, true>(float const*)": "R1", "warp1_kernel(float const*)": "R1",
        "void (anonymous namespace)::sor_kernel<true>(float const*, float const*, float const*, "
        "float const*, long, int, float, float*)": "R3",
        "void (anonymous namespace)::sor_kernel<true>((anonymous namespace)::UpdateArgs, int)":
            "R23",
        "sor_kernel<false>(UpdateArgs, int)": "R23", "templates_kernel<8, 8>(TemplateGrid)": "S1",
        "weights_kernel<8, 8>(float const*)": "S3", "densify_kernel<3, 3, true>(D)": "S4",
        "pad_kernel(float const*)": "F1", "levels_kernel(float const*)": "F2",
        "finish_kernel(float const*)": "F3",
        "void at::native::(anonymous namespace)::replication_pad2d_kernel<float>()": None,
        "[aten::copy_] Memcpy DtoD (Device -> Device)": None,
        "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>()": None}
    assert {n: kernel_id(n) for n in names} == names
