"""The port at small frames, whose coarse levels are shorter than a
patch's sampling region (rc = 2 ps + 3 = 19 at ps 8) or only one or two
rows or columns: 8 x 64 (level 3 one row), 9 x 64 and 16 x 64 (two rows;
9 rows pad to 16), 64 x 16 (two columns).

The port follows the NumPy oracle (``dis_tpu/oracle/reference_semantics
.py``) there: reflect-101 pads as ``np.pad(mode="reflect")`` does at every
size (a plane of one row or column repeats it), and a tap past the plane
reads its edge.  It does not follow the JAX package's accident (its
``xla_regions`` clamps a region's base to a negative row, which
``jnp.take`` wraps), and at 64 x 16 the JAX package raises.

- ``reflect101_pad`` equals ``np.pad(mode="reflect")`` for sizes 1-4 and
  pads 1-2, batched.
- K2's plain version on planes shorter or narrower than a region samples
  what the oracle's ``sample_patches`` samples, and the pyramid's plain
  chain down to levels of one row or column is the oracle's.
- ``dis_flow`` under ``DIS_COMPAT_DEFAULT`` and ``DIS_FAST`` against
  ``dis_flow_oracle`` (padded, cropped): max |d| within the JAX package's
  own departure from the oracle at that size (``ORACLE_BOUND``).
- ``DIS_MEDIUM`` (refinement on every level, 1 x 8 at 8 x 64): a finite
  flow, and against the JAX package's flow where it has one (8 x 64,
  9 x 64, 16 x 64) under the refinement gate of
  ``tests/test_torch_refine_flow.py``.  The JAX flows are stored in
  ``tests/data/small_frames_jax.npz``: each takes about 80 s of JAX
  compilation on the CPU.  ``python tests/test_torch_small_frames.py``
  recomputes them (``--write`` stores them) and prints the readings
  behind the bounds.
- ``DIS_ULTRAFAST`` (F3's path) and ``DIS_FULL`` (scales 4..0) finite.

The pairs are the suite's smooth textures (``conftest.synthetic_pair``)
shifted by one column.  On white noise, compat's 1000 trips drive some
patches to the policing radius, where the last ulp of a sum decides
whether one is reset: there the port and the oracle part by up to 0.14 px
at 64 x 96 as well, a frame of no small plane.

The kernels at these shapes run on the card (``chip_smoke.py`` phase 2i,
``tests/test_torch_kernels_cuda.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dis_tpu_torch as dt
from dis_tpu import config as jc
from dis_tpu.oracle import reference_semantics as spec
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.ops import image as tim
from dis_tpu_torch.ops.pyramid import construct_pyramid

from conftest import synthetic_pair
from torch_threads import one_thread

SIZES = ((8, 64), (9, 64), (16, 64), (64, 16))
# The bound on max |port - oracle| at each size, no larger than the JAX
# package's own departure from the oracle there: on white-noise pairs
# shifted one column (seeds 0-3, compat and fast; ``_readings`` prints
# them) it departs by up to 0.048 px at 8 x 64, 0.083 px at 9 x 64 and
# 0.365 px at 16 x 64.  At 64 x 16 the JAX package raises, and the port is
# held to the oracle alone, at the tightest of the bounds.
ORACLE_BOUND = {(8, 64): 0.038, (9, 64): 0.023, (16, 64): 0.023, (64, 16): 0.023}
NOISE_SEEDS = range(4)
JAX_FLOWS = Path(__file__).parent / "data" / "small_frames_jax.npz"
MEDIUM_JAX_SIZES = ((8, 64), (9, 64), (16, 64))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread(), torch.inference_mode():
        yield


def _pair(h, w):
    return synthetic_pair(h, w, shift=(1.0, 0.0), seed=0)


def _oracle_flow(i1, i2, cfg):
    """``dis_flow_oracle`` on the padded pair, upsampled and cropped as
    ``dis_flow`` does (``main.cpp:191-198``)."""
    h, w = i1.shape
    p1, (padw, padh) = spec.pad_divisible(i1, cfg.coarsest_scale)
    p2, _ = spec.pad_divisible(i2, cfg.coarsest_scale)
    flow = spec.dis_flow_oracle(p1, p2, cfg)
    if cfg.finest_scale:
        f = 2 ** cfg.finest_scale
        flow = spec.resize_bilinear(flow * np.float32(f), flow.shape[1] * f, flow.shape[0] * f)
    return spec.crop_padding(flow, padw, padh, w, h)


def _port_flow(i1, i2, cfg):
    return dt.dis_flow(torch.from_numpy(i1), torch.from_numpy(i2), cfg).numpy()


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 3, 4])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_reflect101_pad_matches_np_pad(h, w, r):
    x = np.random.default_rng(h * 10 + w).random((2, h, w)).astype(np.float32)
    got = tim.reflect101_pad(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (r, r), (r, r)), mode="reflect"))
    np.testing.assert_array_equal(tim.reflect101_pad(torch.from_numpy(x[0]), r).numpy(),
                                  np.pad(x[0], r, mode="reflect"))


@pytest.mark.parametrize("plane", [(17, 40), (18, 18), (40, 18), (17, 17)])
def test_small_plane_regions_sample_as_the_oracle(plane):
    """K2's plain version on a padded plane with fewer rows or columns than
    a region: the base is 0 on that axis and a window index past the plane
    reads its edge, so the windows sampled from the regions are the
    oracle's clipped taps, at start positions over the whole policed range
    (the level is ``plane - 2 ps`` wide)."""
    ps, pad = 8, 8
    th, tw = plane
    rng = np.random.default_rng(th * tw)
    img = (rng.random(plane) * 255).astype(np.float32)
    lo, hi_x, hi_y = -ps / 2, tw - 2 * ps + ps // 2 - 2, th - 2 * ps + ps // 2 - 2
    n = 64
    pos = np.stack([rng.uniform(lo, hi_x, n), rng.uniform(lo, hi_y, n)], -1).astype(np.float32)
    pos[:4] = [[lo, lo], [hi_x, hi_y], [lo, hi_y], [hi_x, lo]]
    regions, by, bx = iclk.extract_regions_plain(torch.from_numpy(img), torch.from_numpy(pos),
                                                 ps, pad)
    rc = 2 * ps + 3
    assert tuple(regions.shape) == (n, rc, rc)
    if th < rc:
        assert (by.numpy() == 0).all()
    if tw < rc:
        assert (bx.numpy() == 0).all()
    for normalize in (False, True):
        got = iclk.sample_from_regions(regions, by, bx, torch.from_numpy(pos), ps, pad,
                                       normalize).numpy()
        want = spec.sample_patches(img, pos, ps, pad, tw, normalize)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_levels_match_the_oracle(size):
    """The pyramid's plain chain (Sobel magnitude, box means, each level's
    reflect-101 Sobels) down to levels of one or two rows or columns
    equals the oracle's within float32 rounding (the oracle sums a box
    mean in another order)."""
    cfg = dt.DIS_COMPAT_DEFAULT
    i1, _ = _pair(*size)
    p1, _ = spec.pad_divisible(i1, cfg.coarsest_scale)
    levels = construct_pyramid(torch.from_numpy(p1), cfg.coarsest_scale, cfg.img_padding)
    imgs, dxs, dys = spec.construct_pyramid(p1, cfg.coarsest_scale, cfg.img_padding)
    for lv, a, b, c in zip(levels, imgs, dxs, dys):
        for got, want in ((lv.img, a), (lv.dx, b), (lv.dy, c)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("cfg_name", ["DIS_COMPAT_DEFAULT", "DIS_FAST"])
@pytest.mark.parametrize("size", SIZES)
def test_dis_flow_matches_the_oracle(size, cfg_name):
    i1, i2 = _pair(*size)
    got = _port_flow(i1, i2, getattr(dt, cfg_name))
    want = _oracle_flow(i1, i2, getattr(jc, cfg_name))
    assert got.shape == want.shape == (*size, 2)
    assert np.isfinite(got).all()
    d = float(np.abs(got - want).max())
    assert d <= ORACLE_BOUND[size], d


@pytest.fixture(scope="module")
def jax_flows():
    with np.load(JAX_FLOWS) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("size", SIZES)
def test_medium_flow_is_finite_and_matches_jax(jax_flows, size):
    """``DIS_MEDIUM`` refines every level, down to 1 x 8 at 8 x 64: a
    finite flow; against the JAX package's where it returns one, mean |d|
    <= 1e-3 px and at most 1% of pixels over 1e-2 px."""
    i1, i2 = _pair(*size)
    got = _port_flow(i1, i2, dt.DIS_MEDIUM)
    assert got.shape == (*size, 2) and np.isfinite(got).all()
    if size not in MEDIUM_JAX_SIZES:
        return
    ref = jax_flows["medium_%dx%d" % size]
    d = np.sqrt(((got - ref) ** 2).sum(-1))
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 1e-2).mean() <= 0.01, (d > 1e-2).mean()


@pytest.mark.parametrize("cfg_name,size", [("DIS_ULTRAFAST", s) for s in SIZES]
                         + [("DIS_FULL", (8, 64)), ("DIS_MEDIUM", (1, 1)), ("DIS_FULL", (1, 1))])
def test_other_presets_are_finite(cfg_name, size):
    """``DIS_ULTRAFAST`` upsamples from scale 1 (F3's plain version);
    ``DIS_FULL`` pads 8 rows to 16 and refines down to a 1 x 4 level; the
    smallest frame, 1 x 1, pads to 2^coarsest square and refines every
    level."""
    i1, i2 = _pair(*size)
    got = _port_flow(i1, i2, getattr(dt, cfg_name))
    assert got.shape == (*size, 2) and np.isfinite(got).all()


def _noise_pair(h, w, seed):
    """A white-noise frame and the same frame shifted one column."""
    a = (np.random.default_rng(seed).random((h, w + 1)) * 255).astype(np.float32)
    return np.ascontiguousarray(a[:, 1:]), np.ascontiguousarray(a[:, :-1])


def _readings(write: bool) -> None:
    """The readings behind the bounds: the JAX package's departures from
    the oracle on white-noise pairs (``NOISE_SEEDS``), and on the test's
    pairs each size's departures of the port and of the JAX package (where
    it runs) and the port against the JAX package under DIS_MEDIUM;
    ``write`` stores the JAX package's DIS_MEDIUM flows.  JAX on the CPU,
    about 20 minutes."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from dis_tpu.models import dis as jdis

    for size in SIZES[:3]:
        for name in ("DIS_COMPAT_DEFAULT", "DIS_FAST"):
            d = []
            for seed in NOISE_SEEDS:
                i1, i2 = _noise_pair(*size, seed)
                ref = np.asarray(jdis.dis_flow(jnp.asarray(i1), jnp.asarray(i2),
                                               getattr(jc, name)))
                d.append(float(np.abs(ref - _oracle_flow(i1, i2, getattr(jc, name))).max()))
            print(size, name, "white noise: JAX vs oracle max |d|",
                  ", ".join(f"{v:.3g}" for v in d), flush=True)
    stored = {}
    for size in SIZES:
        i1, i2 = _pair(*size)
        for name in ("DIS_COMPAT_DEFAULT", "DIS_FAST", "DIS_MEDIUM"):
            port = _port_flow(i1, i2, getattr(dt, name))
            try:
                ref = np.asarray(jdis.dis_flow(jnp.asarray(i1), jnp.asarray(i2),
                                               getattr(jc, name)))
            except IndexError as e:
                ref, why = None, f"the JAX package raises ({e})"
            if name == "DIS_MEDIUM":
                if ref is not None:
                    stored["medium_%dx%d" % size] = ref
                    d = np.sqrt(((port - ref) ** 2).sum(-1))
                    why = f"port vs JAX mean {d.mean():.3g} max {d.max():.3g} px"
                print(size, name, why, flush=True)
                continue
            oracle = _oracle_flow(i1, i2, getattr(jc, name))
            jax_d = why if ref is None else f"{np.abs(ref - oracle).max():.3g}"
            print(size, name, f"port {np.abs(port - oracle).max():.3g} px, JAX {jax_d} "
                  f"(bound {ORACLE_BOUND[size]})", flush=True)
    if write:
        JAX_FLOWS.parent.mkdir(exist_ok=True)
        np.savez_compressed(JAX_FLOWS, **stored)
        print("wrote", JAX_FLOWS)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    torch.set_num_threads(1)
    _readings("--write" in sys.argv[1:])
