"""Whole runs of every cell on the CPU at a small frame, past the
harness's look for a card: a sound run comes out correct, and a run with
the timed path broken underneath, or with the lower-precision control in
the program's place, comes out not correct."""

import json

import pytest
import torch

import dis_tpu_torch.models.dis as mdis
from dis_tpu_torch.ops import iclk
from flowbench import run
from flowbench.reference import dis as reference

SEED = 2 ** 33 + 17
CELLS = [c["name"] for c in run.load_cell("hd1080_medium.stream")["manifest"]["workloads"]]
# Small frames, by configuration.  A patch flipped between two float32
# orders moves a block of 2**finest_scale * patch_size pixels on a side
# (32 x 32 under hd1080_ultrafast), which has to stay a small share of
# the frame, as it is at 1080p: a quarter of the frame's sides there.
SIZES = {"hd1080_medium": (64, 96), "hd1080_ultrafast": (270, 480)}


def _run(cell, wrap=None, trace=False):
    size = SIZES[run.load_cell(cell)["cell"]["config"]]
    return run.run_cell(cell, SEED, 0.2, trace, "cpu", size=size, wrap=wrap,
                        log=lambda s: None)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"pairs_per_s", "latency_p95_ms", "setup_s"}
    assert list(r)[-1] == "compared"
    assert r["compared"]["off_pct"]["value"] <= r["compared"]["off_pct"]["limit"]
    json.dumps(r, allow_nan=False)


def test_traced_run_reads_the_host_metrics_on_the_cpu():
    r = _run("hd1080_medium.stream", trace=True)
    assert r["correct"] is True
    assert "enqueue_ms" in r["metrics"] and "busy_s" in r["device"]
    # No device events on the CPU: no device metric is read.
    assert "search_device_ms" not in r["metrics"]


def _alter_answer(monkeypatch):
    orig = mdis.dis_flow_padded

    def altered(*a, **k):
        flow = orig(*a, **k).clone()
        flow[..., : flow.shape[-3] // 4, :, 0] += 0.5
        return flow
    monkeypatch.setattr(mdis, "dis_flow_padded", altered)


def _search_returns_its_start(monkeypatch):
    orig = iclk.inverse_search

    def unmoved(img2, tpl, centers, init_u, *a, **k):
        res = orig(img2, tpl, centers, init_u, *a, **k)
        return res._replace(u=init_u.expand_as(res.u).clone())
    monkeypatch.setattr(iclk, "inverse_search", unmoved)


def _refinement_returns_its_state(monkeypatch):
    monkeypatch.setattr(mdis, "refine_level", lambda l1, l2, flow, *a, **k: flow)


def _half_the_batch_left_out(monkeypatch):
    orig = mdis.dis_flow_padded

    def half(img1, img2, cfg, *a, **k):
        if img1.ndim < 3:
            return orig(img1, img2, cfg, *a, **k)
        h = img1.shape[0] // 2
        kept = orig(img1[:h], img2[:h], cfg, *a, **k)
        return torch.cat([kept, torch.zeros_like(kept)])
    monkeypatch.setattr(mdis, "dis_flow_padded", half)


FAULTS = [(c, _alter_answer) for c in CELLS] + [
    (c, _search_returns_its_start) for c in CELLS] + [
    ("hd1080_medium.stream", _refinement_returns_its_state),
    ("hd1080_ultrafast.b8", _half_the_batch_left_out)]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert r["correct"] is False
    assert r["compared"]["off_pct"]["value"] > r["compared"]["off_pct"]["limit"]


def _control(cell):
    """The reference in bfloat16, a pair at a time, in the program's place."""
    prm = reference.Params.from_fields(run.load_cell(cell)["config"]["dis"])

    def wrap(entry):
        def control(a, b):
            if a.ndim == 2:
                return reference.flow(a, b, prm, dtype=torch.bfloat16)
            return torch.stack([reference.flow(x, y, prm, dtype=torch.bfloat16)
                                for x, y in zip(a, b)])
        return control
    return wrap


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_control_is_not_correct(cell):
    r = _run(cell, wrap=_control(cell))
    assert r["correct"] is False
    assert r["compared"]["off_pct"]["value"] > 10 * r["compared"]["off_pct"]["limit"]
