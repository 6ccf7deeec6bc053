"""``BENCHMARK.json`` against the benchmark's contract, and every file the
harness finds by a name in it."""

import dataclasses
import json
import re
from pathlib import Path

import pytest

from dis_tpu_torch.config import DISConfig
from flowbench.traffic import families

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = BENCH["workloads"]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and LINE.match(e["why"])
            assert e["name"] not in names
            names.add(e["name"])
    for m in METRICS:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for c in CELLS:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4)
    assert len({(c["config"], c["traffic"]) for c in CELLS}) == len(CELLS)
    assert sum(c["chips"] == 4 for c in CELLS) <= max(1, len(CELLS) // 4)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"pairs_per_s", "latency_p95_ms", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in CELLS}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        assert (ROOT / "flowbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            pytest.fail("a roofline share is named <kernel>_roofline")


def test_every_cell_reports_enough():
    for c in CELLS:
        e2e = [m for m in BENCH["end_to_end"] if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(c["name"] in m.get("workloads", [c["name"]]) for m in BENCH["per_layer"])


def test_configurations():
    used = {c["config"] for c in CELLS}
    files = set()
    for cfg in BENCH["configs"]:
        assert cfg["name"] in used, f"{cfg['name']} has no cell"
        assert cfg["file"].startswith("flowbench/") and cfg["file"] not in files
        files.add(cfg["file"])
        assert cfg["source"].startswith("https://") and len(cfg["reduced"]) <= 16
        body = json.loads((ROOT / cfg["file"]).read_text())
        assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
        assert set(body["dis"]) == {f.name for f in dataclasses.fields(DISConfig)}
        DISConfig(**body["dis"])
        assert body["height"] > 0 and body["width"] > 0 and body["assumed"]
        assert set(body["why_reduced"]) == set(cfg["reduced"])


def test_cell_files():
    for c in CELLS:
        mix = json.loads((ROOT / "flowbench" / "mixes" / f"{c['traffic']}.json").read_text())
        assert mix["batch"] >= 1 and 1 <= mix["sample_requests"]
        assert sum(e["pairs"] for e in mix["pairs"]) % mix["batch"] == 0
        assert len({e["name"] for e in mix["pairs"]}) == len(mix["pairs"])
        for e in mix["pairs"]:
            assert e["family"] in families.FAMILIES and e["pairs"] >= 1
        lim = json.loads((ROOT / "flowbench" / "limits" / f"{c['name']}.json").read_text())
        assert set(lim["limits"]) == {"off_pct"}


def test_layer_files_name_layers_of_the_manifest():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for path in (ROOT / "flowbench" / "layers").glob("*.json"):
        spec = json.loads(path.read_text())
        assert spec["layer"] in layers and spec["kernels"]
