"""The port's copy of the synthetic motion families
(``dis_tpu_torch/utils/synth.py``, NumPy and SciPy only) against
``dis_tpu.utils.synth``: every family's frames, ground truth and mask,
and ``masked_epe``, bitwise."""

import numpy as np
import pytest

from dis_tpu.utils import synth as jsynth
from dis_tpu_torch.utils import synth as tsynth


@pytest.mark.parametrize("family", sorted(jsynth.FAMILIES))
def test_family_has_not_drifted(family):
    assert sorted(tsynth.FAMILIES) == sorted(jsynth.FAMILIES)
    for h, w in ((40, 56), (33, 47)):
        got, want = tsynth.make_pair(family, h, w), jsynth.make_pair(family, h, w)
        assert len(got) == len(want) == 4
        for g, r in zip(got, want):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


def test_family_arguments_have_not_drifted():
    for family, kw in (("translation", {"shift": (-1.5, 0.25), "seed": 9}),
                       ("rotation", {"degrees": -3.0}), ("zoom", {"scale": 0.97}),
                       ("shear", {"kx": -0.03, "ky": 0.02}),
                       ("discontinuous", {"fg_shift": (3.0, -1.0), "radius_frac": 0.3}),
                       ("smooth_warp", {"amp": 3.5, "periods": 2.0}),
                       ("natural_warp", {"amp": 1.0, "seed": 11})):
        for g, r in zip(tsynth.make_pair(family, 36, 52, **kw),
                        jsynth.make_pair(family, 36, 52, **kw)):
            np.testing.assert_array_equal(g, r)


def test_masked_epe_has_not_drifted():
    r = np.random.default_rng(3)
    _, _, gt, valid = jsynth.discontinuous(48, 64)
    flow = gt + r.normal(0, 0.5, gt.shape).astype(np.float32)
    for border in (1, 6, 12):
        assert tsynth.masked_epe(flow, gt, valid, border) == jsynth.masked_epe(
            flow, gt, valid, border)
