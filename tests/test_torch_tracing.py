"""The port's tracing (``dis_tpu_torch/utils/profiling.py``) on the CPU, and
one test for the card.

- The launch manifest: every launch that the kernels' CUDA functions
  count, with its stage and scale.  On the CPU the CUDA functions run
  through the ops within ``ops_on_cpu`` with ``_build.launch`` stubbed
  (the launches do nothing; the Python that counts them is the card's),
  so a whole ``dis_flow`` lists its launches in order, and their count by
  kernel equals the wrappers' ``launches`` deltas.
- Off (no profiler, no manifest, no recorder) the stages and a request's
  spans open no ``record_function``; under a profiler they open the
  stages' and the request's ranges.
- On the grid of the TPU's extraction route (the compat bench config,
  the KITTI config 3 and the ultrafast and fast presets, at padded 1080p,
  KITTI and 4K frames) and on the stripes of a 3- and 6-way 4K split,
  every scale's search is one launch of K1 in its plane mode after S1, and
  no extraction kernel launches: the card has one search path.
- ``summarize``'s interval arithmetic on synthetic stamps.
- Marked ``cuda``: after ``aot_compile`` of the benchmark's
  configurations (1080p, 4K, and 1242x375 at 8 pairs a call), a
  profiled replay's program kernels are the manifest's, one for one, no
  extraction kernel is among them (K1's plane mode at every scale),
  every scale is in the manifest, and a recorded window times the
  graph's head.
  On the card: ``python -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_tracing.py -q``.
"""

import collections
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

import dis_tpu_torch
from dis_tpu_torch import _build
from dis_tpu_torch.cost import KERNELS
from dis_tpu_torch.models.dis import dis_flow_padded, dis_flow_stripe
from dis_tpu_torch.ops import cuda as kops
from dis_tpu_torch.ops.cuda import (extract_banded_kernel, extract_kernel, frame_kernel,
                                    iclk_kernel, pyramid_kernel, refine_kernel, scale_kernel)
from dis_tpu_torch.parallel import tiles
from dis_tpu_torch.serving import aot_compile
from dis_tpu_torch.utils import profiling

KERNEL_MODULES = (extract_banded_kernel, extract_kernel, frame_kernel, iclk_kernel,
                  pyramid_kernel, refine_kernel, scale_kernel)
WRAPPERS = {"pyramid_levels": pyramid_kernel.pyramid_levels,
            "extract_regions": extract_kernel.extract_regions,
            "extract_regions_banded": extract_banded_kernel.extract_regions_banded,
            "iclk_search": iclk_kernel.iclk_search,
            "iclk_search_plane": iclk_kernel.iclk_search_plane,
            "refine_planes": refine_kernel.refine_planes,
            "refine_setup": refine_kernel.refine_setup,
            "refine_setup_warp1": refine_kernel.refine_setup_warp1,
            "refine_nosweep": refine_kernel.refine_nosweep,
            "refine_update": refine_kernel.refine_update,
            "scale_templates": scale_kernel.scale_templates,
            "fixed_weights": scale_kernel.fixed_weights, "densify": scale_kernel.densify,
            "frame_pad": frame_kernel.frame_pad, "intensity_levels": frame_kernel.intensity_levels,
            "frame_finish": frame_kernel.frame_finish}
# The ops a mode goes through, and the kernel whose launches count it too.
MODE_OF = {"iclk_search_plane": "iclk_search"}

CONFIGS = Path(__file__).resolve().parents[1] / "flowbench" / "configs"


def _bench_config(name):
    spec = json.loads((CONFIGS / f"{name}.json").read_text())
    return dis_tpu_torch.DISConfig(**spec["dis"]), spec["height"], spec["width"]


MEDIUM = dis_tpu_torch.DIS_MEDIUM
CASES = {
    "fast": (dis_tpu_torch.DIS_FAST, 64, 96, None),
    "fast_batch": (dis_tpu_torch.DIS_FAST, 64, 96, 2),
    "small_planes": (dis_tpu_torch.DIS_FAST, 16, 64, None),
    "ultrafast_pads": (dis_tpu_torch.DIS_ULTRAFAST, 75, 118, None),
    "medium": (MEDIUM, 64, 96, None),
    "medium_warp1": (dataclasses.replace(MEDIUM, refinement_scheme="warp1"), 64, 96, None),
    "medium_at_end": (dataclasses.replace(MEDIUM, refine_per_level=False), 64, 96, 2),
    # Scales 5..1 searched and refined, the frame padded as 1080 rows are.
    "hd1080_medium": (_bench_config("hd1080_medium")[0], 135, 240, None),
    # Six scales: K3 and F2 twice a frame each, scales 6..1 searched and refined.
    "uhd4k_medium": (_bench_config("uhd4k_medium")[0], 270, 480, None),
    # Scales 4..1 of 8 pairs a call: F1 pads 9 rows and 6 columns, as at
    # 1242x375, and F3 crops back to an odd frame.
    "kitti_medium": (_bench_config("kitti_medium")[0], 119, 234, 8),
}
# Launches a call of the benchmark's medium configurations: their frames at
# these sizes take the scales, pads and launches of 1920x1080, 3840x2160
# and 1242x375 (16 search and 28 refinement launches, whatever the batch).
PAIR_LAUNCHES = {"hd1080_medium": 62, "uhd4k_medium": 74, "kitti_medium": 51}


def _expected(cfg, h, w, batch):
    """(kernel, stage, scale) of every launch of ``dis_flow`` on a frame
    [(batch,) h, w], in launch order, from the pipeline's structure."""
    f = 2 ** cfg.coarsest_scale
    ph, pw = -(-h // f) * f, -(-w // f) * f
    out = [("F1", None, None)] if (ph, pw) != (h, w) else []
    per_image = -(-(cfg.coarsest_scale + 1) // pyramid_kernel.MAX_LEVELS)
    out += [("K3", "pyramid", None)] * (2 * per_image)
    refines = cfg.refinement_iters > 0
    if refines and cfg.refinement_planes == "intensity":
        out += [("F2", None, None)] * -(-cfg.coarsest_scale // frame_kernel.MAX_LEVELS)

    def refinement(stage, s):
        seq = [] if cfg.refinement_scheme == "warp1" else ["R0"]
        for _ in range(cfg.refinement_iters):
            seq.append("R1w" if cfg.refinement_scheme == "warp1" else "R1s")
            updates = cfg.refinement_inner_sweeps if cfg.refinement_sor_sweeps else 0
            seq += ["R23"] * updates or ["R3n"]
        return [(k, stage, s) for k in seq]

    for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        # K1's plane mode alone: no extraction launch.
        seq = ["S1", "K1b" if batch else "K1"] + (["S3"] if cfg.mode == "fixed" else [])
        out += [(k, f"scale_{s}", s) for k in seq + ["S4"]]
        if refines and cfg.refine_per_level:
            out += refinement(f"refine_s{s}", s)
    if refines and not cfg.refine_per_level:
        out += refinement("variational_refinement", cfg.finest_scale)
    if cfg.finest_scale > 0:
        out.append(("F3", None, None))
    return out


@pytest.fixture
def stubbed_launches(monkeypatch):
    """The kernels' CUDA functions on CPU tensors within ``ops_on_cpu``,
    each launch a no-op."""
    for mod in KERNEL_MODULES:
        monkeypatch.setattr(mod, "dispatch", lambda op, cuda_fn, device, *args: cuda_fn(*args))
    monkeypatch.setattr(_build, "launch", lambda name, device, *args: None)
    with kops.ops_on_cpu():
        yield


@pytest.mark.parametrize("case", sorted(CASES))
def test_manifest_lists_every_launch_in_order(case, stubbed_launches):
    cfg, h, w, batch = CASES[case]
    shape = (h, w) if batch is None else (batch, h, w)
    x = torch.rand(shape) * 255
    before = {op: wr.launches for op, wr in WRAPPERS.items()}
    with profiling.launch_manifest() as manifest:
        dis_tpu_torch.dis_flow(x, x.roll(1, -1), cfg)
    deltas = {op: wr.launches - before[op] for op, wr in WRAPPERS.items()}
    assert [(e.kernel, e.stage, e.scale) for e in manifest] == _expected(cfg, h, w, batch)
    assert len(manifest) == PAIR_LAUNCHES.get(case, len(manifest))
    assert all(e.op in KERNELS and re.match(r"^[a-z_0-9]+$", e.op) for e in manifest)
    assert set(e.kernel for e in manifest) <= set(profiling.KERNEL_FUNCTIONS)
    # Each launch counts in its op's wrapper, and a mode's also in its kernel's.
    by_op = collections.Counter(e.op for e in manifest)
    want = collections.Counter(by_op)
    for op, n in by_op.items():
        if op in MODE_OF:
            want[MODE_OF[op]] += n
    assert deltas == {op: want[op] for op in WRAPPERS}
    # Outside a manifest nothing is noted, and a nested one takes its own.
    with profiling.launch_manifest() as outer:
        with profiling.launch_manifest() as inner:
            dis_tpu_torch.dis_flow(x, x.roll(1, -1), cfg)
    assert outer == [] and inner == manifest


# The grid of the TPU's extraction route: the compat bench config (also
# the KITTI config 3) and the fast presets, at 1920x1080 and 1242x375
# padded for 2**3, and at 4K, whose finest scale the TPU bands.
COMPAT = dis_tpu_torch.DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                                 finest_scale=0, patch_overlap=0.3,
                                 patch_normalization=True, mode="compat", early_exit=False)
ROUTE_CONFIGS = {"compat_bench": COMPAT, "config3": COMPAT, "fast": dis_tpu_torch.DIS_FAST,
                 "ultrafast": dis_tpu_torch.DIS_ULTRAFAST}
ROUTE_SIZES = [(1920, 1088), (1248, 376), (3840, 2160)]
SEARCH_KERNELS = ("K2", "K2b", "K2s", "K2c", "K1", "K1b")


def _searches(manifest):
    """(op, kernel, scale) of each search or extraction launch, and the
    scales of the S1 launches, in launch order."""
    return ([(e.op, e.kernel, e.scale) for e in manifest if e.kernel in SEARCH_KERNELS],
            [e.scale for e in manifest if e.kernel == "S1"])


@pytest.mark.parametrize("cfg_name", sorted(ROUTE_CONFIGS))
@pytest.mark.parametrize("size", ROUTE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_scale_searches_in_the_plane_mode(cfg_name, size, stubbed_launches):
    """Each scale of a padded frame launches S1, then K1 through
    ``iclk_search_plane``, and no K2, K2b or K2c, the 4K finest scale
    included."""
    cfg = ROUTE_CONFIGS[cfg_name]
    w, h = size
    x = torch.zeros(h, w)
    with profiling.launch_manifest() as manifest:
        dis_flow_padded(x, x, cfg)
    scales = list(range(cfg.coarsest_scale, cfg.finest_scale - 1, -1))
    assert _searches(manifest) == ([("iclk_search_plane", "K1", s) for s in scales], scales)


@pytest.mark.parametrize("n", [3, 6])
def test_every_stripe_searches_in_the_plane_mode(n, stubbed_launches):
    """Each stripe of an n-way split of the compat 4K frame, with its own
    ``row0``, launches S1 then K1 through ``iclk_search_plane`` at every
    scale, and no extraction kernel."""
    w, h = 3840, 2160
    halo = tiles.min_stripe_halo(COMPAT, w, h, n)
    scales = list(range(COMPAT.coarsest_scale, COMPAT.finest_scale - 1, -1))
    row0s = []
    for i in range(n):
        row0, ext_h, own_r0, own_h = tiles.stripe_bounds(COMPAT, h, n, i, halo)
        x = torch.zeros(ext_h, w)
        with profiling.launch_manifest() as manifest:
            dis_flow_stripe(x, x, COMPAT, row0, own_r0, own_h, h)
        assert _searches(manifest) == ([("iclk_search_plane", "K1", s) for s in scales],
                                       scales), i
        row0s.append(row0)
    assert row0s[0] == 0 and len(set(row0s)) == n
    if n == 3:
        assert halo == 176 and row0s == [0, 544, 1264]


class _CountRanges:
    """Counts every ``record_function`` range opened, by name."""

    def __init__(self, monkeypatch):
        self.names = []
        cls = torch.autograd.profiler.record_function
        enter = cls.__enter__

        def counting(rf):
            self.names.append(rf.name)
            return enter(rf)
        monkeypatch.setattr(cls, "__enter__", counting)


def _frame(h=64, w=96):
    x = torch.rand(h, w) * 255
    return x, x.roll(1, 1)


def test_off_opens_no_range_and_no_request(monkeypatch):
    ranges = _CountRanges(monkeypatch)
    x, y = _frame()
    events = []
    monkeypatch.setattr(torch.cuda.Event, "record", lambda self, *a: events.append(self))
    dis_tpu_torch.dis_flow(x, y, MEDIUM)
    dis_flow_padded(x, y, MEDIUM)
    aot_compile(MEDIUM, 64, 96, device="cpu")(x, y)
    assert ranges.names == [] and events == []
    assert profiling.request() is None
    assert profiling.stage("scale_3", 3) is profiling.stage("pyramid")
    # A manifest alone keeps the stages, and opens no range either.
    with profiling.launch_manifest():
        dis_tpu_torch.dis_flow(x, y, MEDIUM)
    assert ranges.names == []


def test_profiler_opens_the_stages(monkeypatch):
    ranges = _CountRanges(monkeypatch)
    x, y = _frame()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dis_tpu_torch.dis_flow(x, y, MEDIUM)
    stages = [n for n in ranges.names if not n.startswith("aten::")]
    assert stages == ["pyramid"] + [n for s in range(3, -1, -1)
                                    for n in (f"scale_{s}", f"refine_s{s}")]


def _request(head=None, fail=False):
    """The stages of one request as ``CompiledFlow.__call__`` opens them."""
    req = profiling.request(head)
    if req is None:
        return
    with req:
        for i in range(3):
            req.stage(i)
            if fail and i == 1:
                raise RuntimeError("replay failed")


def test_request_spans_under_a_profiler(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _request()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e["ts"], -e["dur"], e["name"]) for e in json.loads(path.read_text())
                   ["traceEvents"] if e.get("cat") == "user_annotation")
    names = [n for _, _, n in spans]
    assert [n for n in names if not n.startswith(profiling.REQUEST)] == \
        list(profiling.REQUEST_SPANS) * 2
    numbers = [int(n.split()[1]) for n in names if n.startswith(profiling.REQUEST)]
    assert len(numbers) == 2 and numbers[1] == numbers[0] + 1
    # Each request's spans lie inside its own range.
    for k in (0, 4):
        t0, d0, _ = spans[k]
        assert all(t0 <= t and t - d <= t0 - d0 for t, d, _ in spans[k + 1:k + 4])


def test_recorder_keeps_host_stamps_and_drops_past_capacity():
    with profiling.recording(requests=2, device="cpu") as rec:
        for _ in range(3):
            _request()
        with pytest.raises(RuntimeError):
            _request(fail=True)
    assert profiling.request() is None
    s = rec.summary()
    assert s["requests"] == 2 and s["dropped"] == 2 and "device_ms" not in s
    assert all(v >= 0 for v in s["host_us"].values())
    assert rec.numbers[1] == rec.numbers[0] + 1
    with profiling.recording(requests=4, device="cpu") as rec:
        _request()
        with pytest.raises(RuntimeError):
            _request(fail=True)
    assert rec.summary()["requests"] == 1       # the failed request is not kept


NS = 1000   # host stamps in ns: 1 us apart per unit below


@pytest.mark.parametrize("case", ["gaps", "overlap", "no_head"])
def test_summarize_intervals(case):
    # Two requests: copy-in 0.1 ms, replay 1.0 (launch wait 0.2), copy-out
    # 0.1, then 0.5 ms to the next request.
    device = [(0.0, 0.1, 1.1, 1.2), (1.7, 1.8, 2.8, 2.9)]
    waits = [0.2, 0.2]
    host = [(0, 10 * NS, 40 * NS, 50 * NS), (450 * NS, 460 * NS, 490 * NS, 500 * NS)]
    if case == "overlap":        # a second stream's request inside the first's graph
        device[1] = (0.5, 0.6, 1.0, 1.15)
    if case == "no_head":
        waits = [None, 0.2]
    s = profiling.summarize(device, waits, host)
    assert s["requests"] == 2 and s["dropped"] == 0
    assert s["host_us"] == pytest.approx({"copy_in": 10, "replay": 30, "copy_out": 10,
                                          "between": 400})
    d = s["device_ms"]
    assert d["copy_in"] == pytest.approx(0.1)
    if case == "gaps":
        assert s["window_ms"] == pytest.approx(2.9)
        assert d == pytest.approx({"copy_in": 0.1, "launch_wait": 0.2, "graph": 0.8,
                                   "copy_out": 0.1, "gap": 0.5})
        # Busy: 2 x (0.1 + 0.8 + 0.1); idle: two launch waits and the gap.
        assert s["idle_pct"] == pytest.approx(100 * 0.9 / 2.9)
    elif case == "overlap":
        assert s["window_ms"] == pytest.approx(1.2) and d["gap"] == 0.0
        # Busy: [0, 0.1] and [0.3, 1.2]; the second request lies inside.
        assert s["idle_pct"] == pytest.approx(100 * 0.2 / 1.2)
    else:
        assert d["launch_wait"] == pytest.approx(0.2)
        assert d["graph"] == pytest.approx((1.0 + 0.8) / 2)
        assert s["idle_pct"] == pytest.approx(100 * 0.7 / 2.9)


def test_summarize_empty_and_host_only():
    assert profiling.summarize([], [], []) == {"requests": 0, "dropped": 0}
    assert profiling.summarize(None, [], [], dropped=3) == {"requests": 0, "dropped": 3}
    s = profiling.summarize(None, [None], [(0, NS, 2 * NS, 3 * NS)])
    assert s["host_us"] == {"copy_in": 1, "replay": 1, "copy_out": 1, "between": None}
    assert "idle_pct" not in s


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("config, batch", [("hd1080_medium", None),
                                           ("hd1080_ultrafast", None),
                                           ("hd1080_ultrafast", 8),
                                           ("uhd4k_medium", None),
                                           ("kitti_medium", 8)])
def test_replay_runs_the_manifest(config, batch, tmp_path):
    """A profiled replay's program kernels, in device order under its
    ``cudaGraphLaunch``, are the graph's manifest one for one; every other
    device event of the replay is torch's copy or fill.  A recorded window
    times the graph's head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    cfg, h, w = _bench_config(config)
    shape = (h, w) if batch is None else (batch, h, w)
    x = torch.rand(shape, device="cuda") * 255
    y = x.roll(2, -1)
    flow = aot_compile(cfg, h, w, batch)
    assert flow.graph_manifest and flow.graph_head is not None
    assert sum(flow.graph_launches.values()) == len(flow.graph_manifest)
    # Every scale takes the route "K2", K1's plane mode: no extraction runs.
    assert not any(e.kernel.startswith("K2") for e in flow.graph_manifest)
    assert len(flow.graph_manifest) == PAIR_LAUNCHES.get(config, len(flow.graph_manifest))
    # Every scale's search, and its refinement where the preset refines at
    # every scale, is in the manifest under that scale.
    scales = set(range(cfg.finest_scale, cfg.coarsest_scale + 1))

    def staged(prefix):
        return {e.scale for e in flow.graph_manifest if (e.stage or "").startswith(prefix)}
    assert staged("scale_") == scales
    if cfg.refinement_iters and cfg.refine_per_level:
        assert staged("refine_s") == scales
    # Off, a request opens no range and records no event.
    with pytest.MonkeyPatch.context() as mp:
        ranges = _CountRanges(mp)
        events = []
        record = torch.cuda.Event.record
        mp.setattr(torch.cuda.Event, "record",
                   lambda self, *a: (events.append(self), record(self, *a)))
        flow(x, y)
    assert ranges.names == [] and events == []
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            flow(x, y)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    launches = [e["args"]["correlation"] for e in ev if e["name"] == "cudaGraphLaunch"]
    assert len(launches) == 2
    patterns = {k: re.compile(r"(?:^|[\s:])" + p) for k, p in profiling.KERNEL_FUNCTIONS.items()}
    port = re.compile(r"(?:^|[\s:])(" + "|".join(set(profiling.KERNEL_FUNCTIONS.values())) + ")")
    for c in launches:
        replay = sorted((e for e in ev if e.get("args", {}).get("correlation") == c
                         and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                        key=lambda e: e["ts"])
        program = [e["name"] for e in replay if port.search(e["name"])]
        others = [e["name"] for e in replay if not port.search(e["name"])]
        assert len(program) == len(flow.graph_manifest)
        for name, launch in zip(program, flow.graph_manifest):
            assert patterns[launch.kernel].search(name), (name, launch)
        assert all(re.search(r"Memcpy|Memset|FillFunctor|direct_copy_kernel", n)
                   for n in others), others
    with profiling.recording(requests=8) as rec:
        for _ in range(5):
            flow(x, y)
            torch.cuda.synchronize()
    s = rec.summary()
    assert s["requests"] == 5 and s["device_ms"]["launch_wait"] is not None
    assert 0 <= s["idle_pct"] < 100 and s["device_ms"]["graph"] > 0
