"""The torch families of ``flowbench/traffic`` against the program's
``utils/synth.py`` (NumPy and SciPy) on the same random draws, and the
pool's dependence on the seed and on its mix's entries."""

import numpy as np
import pytest
import torch

from dis_tpu_torch.utils import synth
from flowbench.traffic import families
from flowbench.traffic.pool import make_pool

H, W = 48, 80


def _numpy_rand(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: torch.from_numpy(rng.random(shape))


@pytest.mark.parametrize("name", sorted(families.FAMILIES))
@pytest.mark.parametrize("seed", [0, 11])
def test_family_matches_synth(name, seed):
    want = synth.FAMILIES[name](H, W, seed=seed)
    kw = {"fg_rand": _numpy_rand(seed + 1000)} if name == "discontinuous" else {}
    got = families.FAMILIES[name](_numpy_rand(seed), H, W, "cpu", **kw)
    for w, g in zip(want[:2], got[:2]):
        assert g.dtype == torch.float32 and g.shape == (H, W)
        # Intensities 0..255: SciPy's box filter sums in float32.
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3])


ENTRIES = [
    {"name": "translation", "family": "translation", "pairs": 1, "params": {}},
    {"name": "far", "family": "translation", "pairs": 1,
     "params": {"texture": "natural", "shift": [20.0, -9.0], "margin": 40}},
    {"name": "zoom", "family": "zoom", "pairs": 1, "params": {"texture": "natural"}},
    {"name": "discontinuous", "family": "discontinuous", "pairs": 1,
     "params": {"texture": "natural"}},
    {"name": "natural_warp", "family": "natural_warp", "pairs": 1, "params": {}},
]


def test_same_seed_same_pool():
    a = make_pool(ENTRIES, 2 ** 33 + 5, 32, 48, "cpu")
    b = make_pool(ENTRIES, 2 ** 33 + 5, 32, 48, "cpu")
    assert a.names == b.names
    for x, y in ((a.img1, b.img1), (a.img2, b.img2), (a.gt, b.gt), (a.valid, b.valid)):
        assert torch.equal(x, y)


def test_another_seed_another_pool_of_the_same_entries():
    a = make_pool(ENTRIES, 1, 32, 48, "cpu")
    b = make_pool(ENTRIES, 2, 32, 48, "cpu")
    assert sorted(a.names) == sorted(b.names) == sorted(e["name"] for e in ENTRIES)
    assert not torch.equal(a.img1, b.img1)
    assert a.img1.shape == (5, 32, 48) and a.gt.shape == (5, 32, 48, 2)
    far = a.names.index("far")
    np.testing.assert_allclose(a.gt[far].reshape(-1, 2).numpy(), [[20.0, -9.0]] * (32 * 48))


@pytest.mark.parametrize("name", ["translation", "rotation", "shear", "smooth_warp"])
def test_natural_texture_is_natural_warps(name):
    """A family on the natural texture starts from the texture that
    ``natural_warp`` (``synth``'s) draws from the same draws."""
    want = synth.natural_warp(H, W, seed=4)[0]
    got = families.FAMILIES[name](_numpy_rand(4), H, W, "cpu", texture="natural")[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_a_wider_margin_moves_nothing_but_the_texture():
    a = families.translation(_numpy_rand(4), H, W, "cpu", shift=(40.0, 0.0))
    b = families.translation(_numpy_rand(4), H, W, "cpu", shift=(40.0, 0.0), margin=48)
    assert torch.equal(a[2], b[2])
    assert a[3].float().mean() < 1.0 == float(b[3].float().mean())


def test_entries_need_distinct_names():
    with pytest.raises(ValueError):
        make_pool(ENTRIES + ENTRIES[:1], 1, 32, 48, "cpu")
