"""The boundary counts of the two rooflines, worked by hand at small
shapes."""

from flowbench.reference.dis import Params, Trips
from flowbench.roofline import refine, search

BASE = dict(iterations=16, patch_size=8, coarsest_scale=0, finest_scale=0,
            patch_overlap=0.3, patch_normalization=True, mode="fixed",
            refinement_iters=0, refinement_alpha=40.0, refinement_delta=5.0,
            refinement_gamma=10.0, refine_per_level=True, refined_init_clamp=False,
            refinement_inner_sweeps=5, refinement_sor_sweeps=5, refinement_omega=1.6,
            refinement_scheme="planes6", refinement_planes="intensity", conv_eps=0.01)


def test_search_one_scale():
    # ps 8: P = 64; a resample 8 + 7P + 2P = 584.  10 patches, 25 trips,
    # a 16 x 24 level padded by 8.
    prm = Params(**BASE)
    t = Trips([(0, 10, 25, (16, 24))])
    flops, nbytes = search.count(prm, 16, 24, t)
    templates = 10 * (384 + 128 + 4)             # 5160
    start = 10 * 584                             # 5840
    trips = 25 * (64 + 256 + 10 + 14 + 584)      # 23200
    weights = 10 * (584 + 192 + 2)               # 7780
    densify = 10 * 5 * 64 + 2 * 16 * 24          # 3968
    assert flops == templates + start + trips + weights + densify == 45948
    assert nbytes == 4 * 4 * 32 * 40 + 4 * 2 * 16 * 24 == 23552


def test_search_two_scales_compat():
    # Compat: no residual subtraction, no weights; the finer scale also
    # reads the coarser 8 x 12 flow.
    prm = Params(**{**BASE, "coarsest_scale": 1, "mode": "compat"})
    t = Trips([(1, 4, 8, (8, 12)), (0, 10, 25, (16, 24))])
    flops, nbytes = search.count(prm, 16, 24, t)
    per = lambda n, k: n * (516 + 584) + k * (256 + 24 + 584) + n * 320
    assert flops == per(4, 8) + 2 * 8 * 12 + per(10, 25) + 2 * 16 * 24
    assert nbytes == (16 * 24 * 28 + 8 * 96) + (16 * 32 * 40 + 8 * 8 * 12 + 8 * 384) == 35840


def test_refine_per_level():
    # DIS_MEDIUM's sweeps: 88 + 5 * (96 + 5 * 42) = 1618 operations a
    # pixel a level; levels 8 x 16 and 16 x 32 of a 16 x 32 frame.
    prm = Params(**{**BASE, "coarsest_scale": 1, "refinement_iters": 1})
    flops, nbytes = refine.count(prm, 16, 32)
    assert flops == 1618 * (128 + 512)
    assert nbytes == 24 * (128 + 512)


def test_refine_once_at_the_end_and_warp1():
    prm = Params(**{**BASE, "coarsest_scale": 2, "refinement_iters": 2,
                    "refine_per_level": False, "refinement_scheme": "warp1",
                    "refinement_inner_sweeps": 1, "refinement_sor_sweeps": 2})
    flops, nbytes = refine.count(prm, 16, 32)
    assert flops == 2 * (57 + 96 + 2 * 42) * 512
    assert nbytes == 24 * 512


def test_no_refinement():
    assert refine.count(Params(**BASE), 16, 32) == (0.0, 0.0)
