"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by name under portbench/, and the file keeps to the benchmark's
contract."""

import json
import os
import re

import pytest

from portbench import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found_and_matches(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and all(NAME.match(k) for k in config["reduced"])
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    with open(os.path.join(harness.ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["name"] == config["name"]
    assert os.path.isfile(os.path.join(harness.HERE, "configs", data["chains"]))
    assert set(config["reduced"]) <= set(data["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found(workload):
    assert set(workload) == {"name", "config", "traffic", "chips", "why"}
    assert workload["chips"] in (1, 4) and len(workload["why"]) <= 200
    cell = harness.load_cell(workload["name"])
    assert os.path.isfile(os.path.join(harness.HERE, "drivers", f"{cell.traffic['driver']}.py"))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for metric in cell.per_layer:
        assert metric["moves"] in reported
    # Every number the drivers compare has a limit.
    expected = ({"chunk_gap", "frame_gap", "samples_missing"} if cell.traffic["driver"] == "mitotic"
                else {"step_gap", "run_gap", "frame_gap", "wall_gap", "tick_mismatch",
                      "window_mismatch", "samples_missing"})
    assert expected <= set(cell.params["limits"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader_and_keeps_to_the_contract(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = os.path.join(harness.HERE, "metrics", f"{metric['name']}.py")
    assert os.path.isfile(path)
    assert callable(harness._module("metrics", metric["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
