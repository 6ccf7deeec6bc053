"""Kernel attribution and the window's arithmetic on a small recorded
trace (``data/trace_small.json``, the Chrome trace format that
``torch.profiler`` exports), worked by hand."""

import json
from pathlib import Path

import pytest

from flowbench import trace as tr

FIXTURE = Path(__file__).resolve().parent / "data" / "trace_small.json"


@pytest.fixture(scope="module")
def window():
    return tr.read_window(json.loads(FIXTURE.read_text()), "flowbench.window",
                          tr.layer_patterns())


def test_layers_by_kernel_name(window):
    us = 1e-6
    assert window.layer_s == pytest.approx({
        "frame and pyramid": 20 * us,           # the request's copy
        "per-scale search": 250 * us,           # K1 200, S3 50
        "refinement": 350 * us,                 # R3 300, R2 50
        tr.UNATTRIBUTED: 40 * us})
    assert window.kernel_s["K1"] == pytest.approx(200 * us)
    assert window.kernel_s["S3"] == pytest.approx(50 * us)
    assert window.kernel_s["R2"] == pytest.approx(50 * us)
    assert window.kernel_s["mystery_kernel<float>(float*)"] == pytest.approx(40 * us)


def test_events_launched_outside_the_window_are_left_out(window):
    assert window.events == 6
    assert "K3" not in window.kernel_s


def test_busy_window_and_idle_gaps(window):
    us = 1e-6
    assert window.window_s == pytest.approx(1000 * us)
    assert window.busy_s == pytest.approx(660 * us)
    gaps = dict(window.idle_gaps)
    assert gaps == pytest.approx({"(host outside any span)": 160 * us,
                                  "cudaDeviceSynchronize": 100 * us,
                                  "aten::copy_": 40 * us, "flowbench.request": 40 * us})
    assert sum(gaps.values()) == pytest.approx(window.window_s - window.busy_s)
    assert window.device_ops[0] == ["R3 " + "sor_kernel<false>(SorArgs, int, int, long, int, "
                                    "float, int, int, float, int, float*)", pytest.approx(300 * us)]


@pytest.mark.parametrize("name, layer, kid", [
    ("void pyramid_kernel<true>(float const*, int)", "frame and pyramid", "K3"),
    ("levels_kernel(float const*)", "frame and pyramid", "F2"),
    ("Memset (Device)", "frame and pyramid", "fill"),
    ("void extract_kernel(dis_extract::Args)", "per-scale search", "K2"),
    ("banded_kernel(Args)", "per-scale search", "K2c"),
    ("templates_kernel<8, 8>(TemplateGrid)", "per-scale search", "S1"),
    ("densify_kernel<3, 3, true>(DensifyArgs)", "per-scale search", "S4"),
    ("planes_kernel(float const*)", "refinement", "R0"),
    ("warp_kernel<6, true>(float const*)", "refinement", "R1"),
    ("warp1_kernel(float const*)", "refinement", "R1w"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>>",
     tr.UNATTRIBUTED, None),
])
def test_attribute(name, layer, kid):
    got = tr.attribute(name, tr.layer_patterns())
    assert got[0] == layer
    if kid is not None:
        assert got[1] == kid


def test_spans_union():
    assert tr.spans_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.spans_union([]) == 0
