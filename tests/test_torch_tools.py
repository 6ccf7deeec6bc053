"""The port's measurement tools (``dis_tpu_torch/tools``) on the CPU at
small sizes: the quality sweep against the JAX package's ``dis_flow`` on
the same synthetic pairs, the trace budget's views of a CPU trace and of
a hand-made device trace, and the scaling projection's per-rank stripe
and window programs (stitched bitwise the untiled flow) and its
collective bytes (equal to what the engines' own calls move)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from dis_tpu.config import PRESETS as JPRESETS
from dis_tpu.models.dis import dis_flow as jdis_flow
from dis_tpu.utils import synth as jsynth
from dis_tpu_torch import PRESETS, DISConfig
from dis_tpu_torch.parallel.launch import spawn
from dis_tpu_torch.tools import quality_sweep, scaling_measure, trace_budget
from torch_threads import one_thread

FAMILIES = ("translation", "rotation", "natural_warp")


def test_quality_sweep_matches_jax():
    with one_thread():
        got = quality_sweep.sweep(PRESETS["medium"], 96, 128, FAMILIES, device="cpu")
    assert list(got) == list(FAMILIES)
    for fam in FAMILIES:
        i1, i2, gt, valid = jsynth.make_pair(fam, 96, 128)
        flow = np.asarray(jdis_flow(jnp.asarray(i1), jnp.asarray(i2), JPRESETS["medium"]))
        want = jsynth.masked_epe(flow, gt, valid)
        epe, tflow = got[fam]
        assert tflow.shape == (96, 128, 2)
        assert abs(epe - want) <= 2e-3, (fam, epe, want)


def test_quality_sweep_cli_and_overrides(capsys):
    cfg = quality_sweep.apply_overrides(PRESETS["fast"], ["iterations=4", "early_exit=0"])
    assert (cfg.iterations, cfg.early_exit) == (4, False)
    with one_thread():
        assert quality_sweep.main(["--preset", "ultrafast", "--size", "48x64", "--families",
                                   "translation,zoom", "--set", "iterations=4",
                                   "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == ["translation", "zoom"]
    rec = json.loads(lines[-1])
    assert rec["preset"] == "ultrafast" and rec["overrides"] == ["iterations=4"]
    assert set(rec["epe"]) == {"translation", "zoom", "mean"} and rec["device"] == "cpu"


def test_tools_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_sweep.sweep(PRESETS["fast"], 48, 64, ["translation"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_budget.capture(PRESETS["fast"], 48, 64, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_measure.measure("tiny", 64, 96, (2,))


def test_trace_budget_cpu_trace(tmp_path):
    with one_thread():
        paths = trace_budget.capture(trace_budget.BENCH_CFG, 64, 96, str(tmp_path), frames=2,
                                     device="cpu")
    assert list(paths) == ["eager"]
    got = trace_budget.summarize(paths["eager"], top=5)
    assert got["events"] == "cpu" and got["frames"] == 2
    assert {"pyramid", "scale_3", "scale_2", "scale_1", "scale_0"} <= set(got["scopes"])
    assert sum(got["scopes"].values()) == pytest.approx(got["total_ms"], rel=1e-9)
    assert sum(got["ops"].values()) == pytest.approx(got["total_ms"], rel=1e-9)
    assert 0 < got["busy_ms"] == got["device_ms"] <= got["span_ms"] <= got["window_ms"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


def test_trace_budget_device_trace():
    """A hand-made trace of two frames: in the first, two kernels launched
    by two ops inside ``scale_0`` (one of them inside ``refine_s0``, and
    inside the other's span) and a copy launched outside any scope and
    op; in the second,
    a graph of two kernels with 10 us between them, stamped after the
    window (a device clock ahead of the host's: they count by their
    launch); a kernel launched before the window is not counted."""
    trace = {"traceEvents": [
        _x("user_annotation", trace_budget.WINDOW, 100, 200),
        _x("user_annotation", trace_budget.FRAME, 100, 90),
        _x("user_annotation", trace_budget.FRAME, 200, 90),
        _x("user_annotation", "scale_0", 110, 50),
        _x("user_annotation", "refine_s0", 130, 10),
        _x("cpu_op", "aten::gather", 111, 5),
        _x("cpu_op", "aten::add", 131, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 112, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 132, 2, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 170, 2, correlation=3),
        _x("cuda_runtime", "cudaGraphLaunch", 205, 2, correlation=4),
        _x("kernel", "k_search", 120, 20, tid=7, correlation=1),
        _x("kernel", "k_sor", 135, 10, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoD", 175, 5, tid=7, correlation=3),
        _x("kernel", "k_search", 300, 20, tid=7, correlation=4),
        _x("kernel", "k_sor", 330, 20, tid=7, correlation=4),
        _x("kernel", "k_before", 50, 10, tid=7, correlation=9),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 2, correlation=9),
    ]}
    got = trace_budget.budget(trace)
    assert got["events"] == "device" and got["frames"] == 2 and got["kernels"] == 2
    assert got["ops"] == {"k_search": 0.02, "k_sor": 0.015, "Memcpy DtoD": 0.0025}
    assert got["scopes"] == {"(no scope)": 0.0225, "scale_0": 0.01, "refine_s0": 0.005}
    assert got["launched_by"] == {"k_search": "aten::gather", "k_sor": "aten::add"}
    assert got["total_ms"] == pytest.approx(0.0375)
    assert got["busy_ms"] == pytest.approx((0.03 + 0.04) / 2)
    # frame 1: launches of 20, 10 and 5 us; frame 2: the graph's two kernels
    assert got["device_ms"] == pytest.approx((0.035 + 0.05) / 2)
    assert got["span_ms"] == pytest.approx((0.06 + 0.05) / 2)
    assert got["window_ms"] == pytest.approx(0.1) and got["busy_share"] == pytest.approx(0.35)
    assert trace_budget.device_busy_ms(trace) == pytest.approx(0.08)     # the whole trace


def test_scaling_stripes_and_windows_stitch_bitwise():
    with one_thread():
        rec = scaling_measure.measure("64x96", 64, 96, (2,), device="cpu")
    assert rec["stripe"]["2"]["stitched_bitwise"] and rec["grid"]["2"]["stitched_bitwise"]
    assert rec["link_bytes_per_s"] == scaling_measure.LINK_GBPS * 1e9
    assert "NVLink" in rec["link_assumption"] and "projection" in rec
    s = rec["stripe"]["2"]
    assert len(s["rank_ms"]) == 2 and s["frame_ms"] == s["max_rank_ms"] + s["link_ms"]
    assert s["efficiency"] == pytest.approx(rec["t1_ms"] / (2 * s["frame_ms"]))
    assert rec["halo"]["2"]["ext_h"] == [64, 64]
    json.dumps(rec)
    with pytest.raises(ValueError, match="divisible"):
        scaling_measure.measure("bad", 72, 96, (2,), device="cpu")


# (label, engine, n, h, w): exchanged halos over 2 and 3 ranks (an
# interior stripe), gathered frames over 3, ragged windows over 3.
BYTES_CASES = [("stripe2", "stripe", 2, 64, 96), ("stripe3", "stripe", 3, 192, 64),
               ("stripe3_gather", "stripe", 3, 72, 64), ("grid3", "grid", 3, 72, 96)]


def test_collective_bytes_equal_the_engines_calls():
    cfg = DISConfig(iterations=4, patch_size=8, coarsest_scale=3, finest_scale=0,
                    patch_overlap=0.3, mode="compat", early_exit=False)
    rng = np.random.default_rng(0)
    cases = [(label, engine, cfg, n) + tuple(rng.random((2, h, w), np.float32) * 255)
             for label, engine, n, h, w in BYTES_CASES]
    out = spawn(3, torch_ranks.collective_bytes_world, cases, device="cpu")
    for label, engine, n, h, w in BYTES_CASES:
        model = scaling_measure.collective_bytes(engine, cfg, h, w, n)
        for r in range(n):
            assert [b for _, b in model[r]] == out[r][label], (label, r)
    halo = scaling_measure.collective_bytes("stripe", cfg, 192, 64, 3)
    assert all(b > 0 for _, b in halo[1]) and sum(b > 0 for _, b in halo[0]) == 2
