"""BENCHMARK.json and the files it names: the contract's limits, and every
cell, configuration, traffic mix and per-layer metric found by name."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [entry["name"] for entry in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(word) for word in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(path + "/") for path in BENCH["paths"]), word
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_run_seconds_fit_the_check_with_24_cells():
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for name in names:
        assert NAME.match(name), name
    for config in BENCH["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert _line(config["source"]) and _line(config["why"]) and len(config["reduced"]) <= 16
        assert all(NAME.match(key) for key in config["reduced"])
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["traffic"]) and _line(cell["why"]) and cell["chips"] in (1, 4)
    assert len({(c["config"], c["traffic"]) for c in BENCH["workloads"]}) == len(CELLS)
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in BENCH["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for metric in METRICS:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {cell["config"] for cell in BENCH["workloads"]}
    files = [config["file"] for config in BENCH["configs"]]
    assert used == {config["name"] for config in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for config in BENCH["configs"]:
        assert any(config["file"].startswith(path + "/") for path in BENCH["paths"])
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"] and data["source"] == config["source"]
        assert data["reduced"] == config["reduced"] and data["precision"] == "float32"
        assert data["guarantees"] and "assumed" in data


def test_setup_s_is_an_end_to_end_metric_with_a_bound_of_at_most_a_quarter():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and setup[0]["unit"] == "s"


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_by_name_and_names_known_metrics(name):
    cell = harness.Cell(name)
    assert {cell.workload[key] for key in ("config", "traffic", "chips", "why")} == {
        cell.entry[key] for key in ("config", "traffic", "chips", "why")
    }
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.loop, "Loop") and hasattr(cell.loop, "check") and hasattr(cell.loop, "control_samples")
    end_to_end = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    assert end_to_end <= {"solves_per_s", "update_ms_p95", "setup_s"}
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(cell.reader(metric["name"]).read)
        assert metric["moves"] in end_to_end
    assert set(cell.workload["limits"]) == {"control_gap", "cost_gap_p99", "cost_mismatch", "exact_mismatch"}
    assert cell.workload["limits"]["exact_mismatch"] == 0


def test_every_file_under_the_benchmark_is_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        relative = path.relative_to(ROOT).as_posix()
        assert PATH.match(relative), relative


def test_compared_updates_are_drawn_from_the_seed_within_the_reach():
    workload = harness.Cell(CELLS[0]).workload
    first = harness.sample_cycles(7, workload, 30, 51)
    assert first == harness.sample_cycles(7, workload, 30, 51)
    assert first != harness.sample_cycles(8, workload, 30, 51)
    assert all(51 <= k < 30 * workload["min_rate_hz"] for k in first)
    assert len(first) == workload["compared_updates"] == len(set(first))
    big = 2**31 + 12345678
    assert harness.sample_cycles(big, workload, 30, 51)
