"""The order in which kernel K1 (``dis_tpu_torch/csrc/iclk.cu``) sums a
patch's taps, emulated in torch on the CPU.

K1 gives each patch a group of G lanes, lane g holding the K consecutive
taps [g K, g K + K) (``ops/cuda/iclk_kernel.py::search_layout``; S1 and
S3 sum in ``lane_layout``'s).  A sum is the pair tree over a lane's K
taps, then log2(G) xor-butterfly levels in which each lane adds its
partner's value to its own.  In K1's split layout (ps 12: G K = 128 main
taps, 16 lanes of 8) lane g also holds the extra tap G K + g, and the sum
is the main taps' plus (a butterfly over the extra taps + 0.0).  Here
that is emulated on the zero-padded taps and held bitwise (as bit
patterns, so -0.0 counts) to the port's ``pairwise_sum``, which the plain
version of K1 uses, and to the JAX package's ``pairwise_sum``, in both
layouts, for every patch size the kernel compiles a layout for, on random
and adversarial values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.ops.iclk import pairwise_sum as jpairwise_sum
from dis_tpu_torch.ops.cuda.iclk_kernel import MAX_TAPS, lane_layout, search_layout
from dis_tpu_torch.ops.iclk import pairwise_sum


def lane_group_sum(x: torch.Tensor, k: int, g: int) -> torch.Tensor:
    """Each lane's result [N, G] of K1's sum over taps ``x`` [N, np]; in
    the split layout (G K < np) the G K main taps' sum plus (the sum of
    the extra taps, one a lane and zero past np - G K, + 0.0)."""
    n, np_ = x.shape
    if k * g < np_:
        extra = lane_group_sum(x[:, k * g:], 1, g)
        return lane_group_sum(x[:, :k * g], k, g) + (extra + 0.0)
    t = torch.nn.functional.pad(x, (0, k * g - np_)).reshape(n, g, k)
    while t.shape[-1] > 1:                     # the in-lane pair tree
        t = t[..., 0::2] + t[..., 1::2]
    s = t[..., 0]
    off = 1
    while off < g:                             # lane l adds lane l ^ off
        s = s + s[:, torch.arange(g) ^ off]
        off *= 2
    return s


def _inputs(kind: str, n: int, np_: int) -> np.ndarray:
    r = np.random.default_rng(np_)
    if kind == "random":
        return (r.standard_normal((n, np_)) * 10.0 ** r.integers(-3, 4, (n, 1))).astype(np.float32)
    pool = np.array([1e30, -1e30, -0.0, 0.0, 1.0, -1.0, 1e-30, 3.0e-39], np.float32)
    x = pool[r.integers(0, len(pool), (n, np_))]
    x[0] = -0.0                                # every tap -0.0
    x[1, :] = 0.0
    x[1, -1] = -0.0
    x[2, 0::2], x[2, 1::2] = 1e30, -1e30       # cancels pair by pair
    x[3] = 1e30
    x[3, -1] = -1e30
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.int32)


# (ps, layout): S1's and S3's lane_layout, then K1's search_layout.
LAYOUTS = ([pytest.param(ps, lane_layout, id=str(ps)) for ps in (8, 10, 12, 16)]
           + [pytest.param(ps, search_layout, id=f"{ps}-search_layout")
              for ps in (8, 10, 12, 16)])


@pytest.mark.parametrize("ps,layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_lane_sum_equals_pairwise_sum(ps, kind, layout):
    k, g = layout(ps)
    np_ = ps * ps
    x = _inputs(kind, 257, np_)
    lanes = lane_group_sum(torch.from_numpy(x), k, g)
    want = _bits(pairwise_sum(torch.from_numpy(x)))
    assert np.array_equal(want, np.asarray(jpairwise_sum(jnp.asarray(x))).view(np.int32))
    for lane in range(g):                      # every lane holds the same bits
        assert np.array_equal(_bits(lanes[:, lane]), want), f"lane {lane}"


def test_lane_layout():
    """K = 8 and the group sizes of the kernel's compiled instances for
    the preset sizes; every even ps up to the tap limit gets a layout
    whose G K is the smallest power of two >= ps^2, K a multiple of 4
    (16-byte template loads), G at most a warp; others raise."""
    assert [lane_layout(ps) for ps in (8, 10, 12, 16)] == [(8, 8), (8, 16), (8, 32), (8, 32)]
    for ps in range(2, 24, 2):
        k, g = lane_layout(ps)
        p = k * g
        assert p >= ps * ps and p // 2 < ps * ps and p & (p - 1) == 0
        assert k % 4 == 0 and g & (g - 1) == 0 and 1 <= g <= 32
    for bad in (7, 24, 0):
        for layout in (lane_layout, search_layout):
            with pytest.raises(ValueError):
                layout(bad)
    assert 22 * 22 <= MAX_TAPS < 24 * 24
    # K1's layout: lane_layout's, but at ps 12 the split one, 16 lanes of
    # 8 main taps and one extra tap each, two patches a warp.
    assert search_layout(12) == (8, 16) and lane_layout(12) == (8, 32)
    for ps in range(2, 24, 2):
        if ps != 12:
            assert search_layout(ps) == lane_layout(ps)
