"""OpenCV's DIS ``PRESET_MEDIUM`` at 3840x2160 (``flowbench/configs/
uhd4k_medium.json``, the benchmark's ``uhd4k_medium.stream``) on the
served path, on the CPU at smaller frames where all six scales exist.

- The configurations of the benchmark are OpenCV's presets: the coarsest
  scale is the one ``calc()`` sets at the frame, and the ``dis`` group
  holds the preset's values.  Every scale of the frame searches with K1
  in its plane mode and launches no extraction kernel (the launch
  manifest of a call whose launches do nothing).
- ``serving.aot_compile`` on the CPU against the plain reference
  (``flowbench/reference/dis.py``) on one pair of each entry of the
  cell's traffic (``flowbench/traffic``), ``off_pct`` within the cell's
  limit, at 540 x 960 (padded to 576 x 960).  At 270 x 480 the traffic's
  48 px translation is a tenth of the frame's width and DIS loses it
  (an endpoint error of about 166 px) in the reference, the JAX package
  and the port alike, each about 30% of the pixels from the others: a
  comparison there decides nothing.
- Whole runs of the cell (``flowbench.run.run_cell``) at 270 x 480, with
  the seed of ``flowbench/tests/test_flowbench_faults.py``: a sound run
  comes out correct; the lower-precision control (the reference in
  bfloat16 in the program's place) and a search that returns its start
  do not.
"""

import json
import math
from pathlib import Path

import pytest
import torch

import dis_tpu_torch
from dis_tpu_torch import serving
from dis_tpu_torch.models.dis import dis_flow_padded
from dis_tpu_torch.ops import iclk
from dis_tpu_torch.utils import profiling
from flowbench import compare, run
from flowbench.reference import dis as reference
from flowbench.traffic.pool import make_pool
from test_torch_tracing import stubbed_launches  # noqa: F401 (a fixture)

CELL = "uhd4k_medium.stream"
SEED = 2 ** 33 + 17
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]}
SPEC = run.load_cell(CELL)
ENTRIES = [e["name"] for e in SPEC["mix"]["pairs"]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_is_opencvs_preset(name):
    spec = CONFIGS[name]
    ocv, dis = spec["opencv"], spec["dis"]
    w, h, ps = spec["width"], spec["height"], ocv["patch_size"]
    coarsest = min(int(math.log2(max(w, h) / (4 * ps)) + 0.5), int(math.log2(min(w, h) / ps)))
    assert ocv["coarsest_scale"] == dis["coarsest_scale"] == coarsest
    assert dis["finest_scale"] == ocv["finest_scale"]
    assert dis["patch_size"] == ps and dis["iterations"] == ocv["grad_descent_iter"]
    assert math.floor(ps * (1 - dis["patch_overlap"])) == ocv["patch_stride"]
    assert dis["patch_normalization"] == ocv["use_mean_normalization"]
    refines = ocv["variational_refinement_iter"] > 0
    assert (dis["refinement_iters"] > 0) == refines
    if refines:
        assert dis["refine_per_level"] and dis["refinement_iters"] == 1
        assert dis["refinement_inner_sweeps"] == ocv["variational_refinement_iter"]
        assert dis["refinement_sor_sweeps"] == ocv["sor_iterations"]
        assert dis["refinement_omega"] == ocv["omega"]
        for k in ("alpha", "gamma", "delta"):
            assert dis[f"refinement_{k}"] == ocv[f"variational_refinement_{k}"]
    assert spec["reduced"] == ["use_spatial_propagation"]


@pytest.mark.parametrize("name", ["hd1080_medium", "uhd4k_medium"])
def test_every_scale_takes_k2(name, stubbed_launches):
    spec = CONFIGS[name]
    cfg = dis_tpu_torch.DISConfig(**spec["dis"])
    f = 2 ** cfg.coarsest_scale
    ph, pw = -(-spec["height"] // f) * f, -(-spec["width"] // f) * f
    x = torch.zeros(ph, pw)
    with profiling.launch_manifest() as manifest:
        dis_flow_padded(x, x, cfg)
    search = [(e.op, e.scale) for e in manifest if e.kernel.startswith(("K1", "K2"))]
    assert search == [("iclk_search_plane", s)
                      for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1)]


@pytest.fixture(scope="module")
def served():
    """The cell's served entry and its traffic's pool at 540 x 960."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        dis = SPEC["config"]["dis"]
        entry = serving.aot_compile(dis_tpu_torch.DISConfig(**dis), 540, 960, None,
                                    device="cpu")
        pool = make_pool(SPEC["mix"]["pairs"], SEED, 540, 960, "cpu")
    finally:
        torch.set_num_threads(n)
    return entry, pool, reference.Params.from_fields(dis)


@pytest.mark.parametrize("entry_name", ENTRIES)
def test_served_path_is_the_reference(entry_name, served):
    entry, pool, prm = served
    i = pool.names.index(entry_name)
    flow = entry(pool.img1[i], pool.img2[i])
    ref = reference.flow(pool.img1[i], pool.img2[i], prm)
    gaps = compare.pair_gaps(flow, ref)
    assert compare.judge(gaps, compare.limits(CELL)), gaps


def _bfloat16_control(entry):
    prm = reference.Params.from_fields(SPEC["config"]["dis"])
    return lambda a, b: reference.flow(a, b, prm, dtype=torch.bfloat16)


def _search_returns_its_start(monkeypatch):
    orig = iclk.inverse_search

    def unmoved(img2, tpl, centers, init_u, *a, **k):
        res = orig(img2, tpl, centers, init_u, *a, **k)
        return res._replace(u=init_u.expand_as(res.u).clone())
    monkeypatch.setattr(iclk, "inverse_search", unmoved)


@pytest.mark.parametrize("side", ["sound", "control", "search_returns_its_start"])
def test_whole_run_judges_the_cell(side, monkeypatch):
    if side == "search_returns_its_start":
        _search_returns_its_start(monkeypatch)
    r = run.run_cell(CELL, SEED, 0.2, False, "cpu", size=(270, 480),
                     wrap=_bfloat16_control if side == "control" else None,
                     log=lambda s: None)
    off = r["compared"]["off_pct"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    if side == "sound":
        assert r["correct"] is True and off["value"] <= off["limit"]
        assert set(r["metrics"]) == {"pairs_per_s", "latency_p95_ms", "setup_s"}
    elif side == "control":
        assert r["correct"] is False and off["value"] > 10 * off["limit"]
    else:
        assert r["correct"] is False and off["value"] > off["limit"]
