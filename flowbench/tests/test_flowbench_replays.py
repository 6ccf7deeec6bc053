"""The replay matcher (``flowbench/replays.py``) on a synthetic Chrome trace
of two replays of one graph, in the format ``torch.profiler`` exports,
worked by hand; and the readers of its metrics, which read nothing where
a run gives them no input."""

import copy
from types import SimpleNamespace

import pytest

from flowbench import replays
from flowbench import run
from flowbench import trace as tr
from flowbench.reference import dis as reference

WINDOW = "flowbench.window"
# The graph's launches: a frame kernel, then scale 3's search and
# refinement, then scale 2's search (K2 on a small plane).
MANIFEST = [SimpleNamespace(kernel=k, scale=s) for k, s in (
    ("K3", None), ("S1", 3), ("K1b", 3), ("R3", 3), ("R3c", 3), ("K2s", 2), ("S4", 2))]
NAMES = {"K3": "void pyramid_kernel<true>(float const*, int)",
         "S1": "templates_kernel<8, 8>(TemplateGrid)",
         "K1b": "void iclk_kernel<8, 8, 8>(float const*, int const*)",
         "R3": "sor_kernel<false>(SorArgs, int)", "R3c": "sor_kernel<true>(SorArgs, int)",
         "K2s": "small_kernel(dis_extract::Args, long long)",
         "S4": "densify_kernel<3, 3, true>(DensifyArgs)"}


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _trace():
    """Two replays (correlations 21 and 31) inside the window, each with a
    torch fill inside the graph and the request's copies outside it, and a
    third replay launched after the window."""
    ev = [_x("user_annotation", WINDOW, 0.0, 1000.0)]
    for c, t0 in ((21, 100.0), (31, 500.0), (41, 2000.0)):
        ev.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 - 20, 5, correlation=c - 1))
        ev.append(_x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t0 - 10, 5,
                     correlation=c - 1))
        ev.append(_x("cuda_runtime", "cudaGraphLaunch", t0, 10, correlation=c))
        t = t0 + 20
        for i, m in enumerate(MANIFEST):
            ev.append(_x("kernel", NAMES[m.kernel], t, 10 * (i + 1), correlation=c))
            t += 10 * (i + 1) + 1
            if i == 2:
                ev.append(_x("kernel", "void at::native::vectorized_elementwise_kernel<4, "
                             "at::native::FillFunctor<float>>", t, 3, correlation=c))
                t += 4
    return {"traceEvents": ev}


def _match(trace):
    return replays.match(trace, WINDOW, tr.layer_patterns(), MANIFEST)


def test_match_attributes_by_layer_and_scale():
    got = _match(_trace())
    us = 1e-6
    assert got.replays == 2 and got.kernels == 14
    assert got.layer_scale_s == pytest.approx({
        ("frame and pyramid", None): 2 * 10 * us,
        ("per-scale search", 3): 2 * (20 + 30) * us,
        ("refinement", 3): 2 * (40 + 50) * us,
        ("per-scale search", 2): 2 * (60 + 70) * us})
    # Device ms a pair above the finest scale (2), over 4 pairs.
    assert got.layer_ms_per_pair("per-scale search", 4, 2) == pytest.approx(2 * 50 * us / 4 * 1e3)
    assert got.layer_ms_per_pair("refinement", 4, 2) == pytest.approx(2 * 90 * us / 4 * 1e3)
    assert got.layer_ms_per_pair("refinement", 4, 3) is None


def _kernels(trace, c):
    return [e for e in trace["traceEvents"] if e["cat"] == "kernel"
            and e["args"]["correlation"] == c and "FillFunctor" not in e["name"]]


@pytest.mark.parametrize("fault", ["reordered", "missing", "extra", "foreign"])
def test_match_raises_on_a_mismatch(fault):
    trace = _trace()
    ks = _kernels(trace, 31)
    if fault == "reordered":                 # S1 after K1b
        ks[1]["ts"], ks[2]["ts"] = ks[2]["ts"], ks[1]["ts"]
    elif fault == "missing":
        trace["traceEvents"].remove(ks[4])
    elif fault == "extra":
        extra = copy.deepcopy(ks[3])
        extra["ts"] += 0.5
        trace["traceEvents"].append(extra)
    else:                                    # a kernel neither the program's nor torch's
        ks[0]["name"] = "void at::native::mystery_kernel<float>(float*)"
    with pytest.raises(ValueError, match="replay 1"):
        _match(trace)


def test_match_needs_the_window():
    with pytest.raises(ValueError, match="no 'flowbench.window'"):
        replays.match({"traceEvents": []}, WINDOW, tr.layer_patterns(), MANIFEST)


def test_every_manifest_kernel_has_a_layer_id():
    from dis_tpu_torch.utils import profiling

    ids = {kid for _, kid, _ in tr.layer_patterns()}
    assert set(replays.KERNEL_IDS) == set(profiling.KERNEL_FUNCTIONS)
    assert set(replays.KERNEL_IDS.values()) <= ids
    assert set(replays.TORCH_IDS) <= ids


READERS = ("search_coarse_device_ms", "refine_coarse_device_ms", "idle_untraced_pct",
           "launch_wait_ms")


def _context():
    prm = reference.Params.from_fields(run.load_cell("hd1080_medium.stream")["config"]["dis"])
    return run.Context(prm, 1088, 1920, requests=10, enqueue_s=0.001)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_their_input(name):
    read = run._metric_reader(name)
    ctx = _context()
    assert read(ctx) is None                 # run.py sets neither input
    ctx.recorded = {"requests": 0, "dropped": 0}
    assert read(ctx) is None                 # an empty recording
    ctx.replays = replays.Replays(replays=0, kernels=0, layer_scale_s={})
    assert read(ctx) is None                 # no replay matched


def test_readers_read_their_input():
    ctx = _context()
    ctx.pairs_traced = 4
    ctx.replays = _match(_trace())
    ctx.recorded = {"requests": 3, "dropped": 0, "idle_pct": 7.5,
                    "device_ms": {"launch_wait": 0.012}}
    got = {name: run._metric_reader(name)(ctx) for name in READERS}
    # hd1080_medium's finest scale is 1: both scales of the trace are coarser.
    assert got == pytest.approx({"search_coarse_device_ms": 2 * 180e-6 / 4 * 1e3,
                                 "refine_coarse_device_ms": 2 * 90e-6 / 4 * 1e3,
                                 "idle_untraced_pct": 7.5, "launch_wait_ms": 0.012})
