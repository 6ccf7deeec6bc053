"""The benchmark's plain reference held to the JAX package's outputs,
recorded on the CPU in ``data/oracle_small.npz``: the pipeline to the
NumPy oracle (``dis_tpu/oracle/reference_semantics.py``,
``dis_flow_oracle``) under compat, ``DIS_FAST`` and both configurations
of the benchmark (the medium one searched without refining, as the
oracle does), the refinement to ``dis_tpu/ops/variational.py``
(``variational_refinement``, ``pad=0``) under ``DIS_MEDIUM`` (both
schemes) and ``hd1080_medium``, and the frame's pad, upsample and
pyramid to the oracle's.  The inputs are ``utils/synth.py``'s pairs at
seed 3 and the NumPy draws below; nothing here loads the JAX package.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dis_tpu_torch.config import DIS_FAST, DIS_MEDIUM, DISConfig
from dis_tpu_torch.utils import synth
from flowbench.reference import dis as ref

HERE = Path(__file__).resolve().parent
ORACLE = np.load(HERE / "data" / "oracle_small.npz")


def _bench(name):
    return json.loads((HERE.parent / "configs" / f"{name}.json").read_text())["dis"]


def _params(fields):
    return ref.Params.from_fields(fields)


CASES = {
    "compat": (dataclasses.asdict(DISConfig(iterations=40)), (64, 96)),
    "fast": (dataclasses.asdict(DIS_FAST), (64, 96)),
    "hd1080_medium": ({**_bench("hd1080_medium"), "refinement_iters": 0}, (64, 96)),
    "hd1080_ultrafast": (_bench("hd1080_ultrafast"), (64, 128)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family", ["rotation", "zoom", "discontinuous", "natural_warp"])
def test_pipeline_matches_the_oracle(case, family):
    fields, (h, w) = CASES[case]
    prm = _params(fields)
    i1, i2, _, _ = synth.FAMILIES[family](h, w, seed=3)
    want = ORACLE[f"flow/{case}/{family}"]
    trips = ref.Trips()
    got = ref.flow_padded(torch.from_numpy(i1), torch.from_numpy(i2), prm, trips=trips)
    assert got.shape == want.shape
    gap = np.sqrt(((got.numpy() - want) ** 2).sum(-1))
    # The reference sums in the JAX package's fixed orders, the oracle in
    # NumPy's: a few ulps apart, which can flip a discrete decision of the
    # search where a patch sits at its edge (measured: compat's
    # natural_warp 0.087 px at most, DIS_FAST's discontinuous 0.027 px;
    # every other case under 1e-4 px).  No pixel departs by 0.1 px.
    assert gap.max() <= 0.1 and gap.mean() <= 0.01
    if family in ("rotation", "zoom"):
        assert gap.max() <= 1e-3
    scales = list(range(prm.coarsest_scale, prm.finest_scale - 1, -1))
    assert [s for s, *_ in trips.scales] == scales
    assert all(n <= t <= n * (prm.iterations + 1) for _, n, t, _ in trips.scales)


@pytest.mark.parametrize("name, fields", [
    ("medium_planes6", dataclasses.asdict(DIS_MEDIUM)),
    ("medium_warp1", dataclasses.asdict(dataclasses.replace(DIS_MEDIUM,
                                                            refinement_scheme="warp1"))),
    ("hd1080_medium", _bench("hd1080_medium")),
])
def test_refinement_matches_jax(name, fields):
    i1, i2, gt, _ = synth.zoom(32, 48, seed=3)
    flow = (gt + np.random.default_rng(0).normal(0, 0.3, gt.shape)).astype(np.float32)
    want = ORACLE[f"refine/{name}"]
    got = ref.refine(torch.from_numpy(i1), torch.from_numpy(i2), torch.from_numpy(flow),
                     _params(fields))
    assert np.abs(want - flow).mean() > 0.05          # the refinement did work
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h, w", [(61, 90), (64, 96), (5, 7)])
def test_pad_matches_the_oracle(h, w):
    img = np.random.default_rng(h * w).random((h, w)).astype(np.float32) * 255
    got, pads = ref.pad_divisible(torch.from_numpy(img), 3)
    assert list(pads) == ORACLE[f"pads/{h}x{w}"].tolist()
    np.testing.assert_array_equal(got.numpy(), ORACLE[f"pad/{h}x{w}"])


@pytest.mark.parametrize("shape, out", [((8, 12, 2), (24, 16)), ((5, 7), (14, 10))])
def test_upsample_matches_the_oracle(shape, out):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    got = ref.resize_bilinear(torch.from_numpy(img), *out)
    want = ORACLE[f"resize/{'x'.join(map(str, shape))}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sobel_and_pyramid_match_the_oracle():
    img = np.random.default_rng(2).random((16, 24)).astype(np.float32) * 255
    got = ref.construct_pyramid(torch.from_numpy(img), 2, 8)
    for level, planes in enumerate(got):
        for k, g in enumerate(planes):           # image, d/dx, d/dy
            np.testing.assert_allclose(g.numpy(), ORACLE[f"pyramid/{k}/{level}"],
                                       rtol=1e-6, atol=1e-4)
