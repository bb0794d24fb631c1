"""BENCHMARK.json against the benchmark's contract, and every named entry's file."""

import json
import os
import re

import pytest

from benchmark import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and not BENCH["paths"][0].endswith("_torch")
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits the day: 2 + 14 runs a cell, run_seconds + 60 each,
    # 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and isinstance(e[k], str):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_metrics_and_cells_fit_together():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = harness.load_cell(w["name"], BENCH)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:  # every per-layer metric moves a metric the cell reports
            assert m["moves"] in names
    assert {(w["config"], w["traffic"]) for w in BENCH["workloads"]}.__len__() == len(cells)


def test_every_named_entry_has_its_file():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        harness.load_module("drivers", cell.workload["driver"])
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic", w["traffic"] + ".json"))
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_release_yaml(name):
    """A configuration file holds its release YAML's TRAIN / MODEL / DATA_PRESET
    sections unchanged, and names no reduced key."""
    from poem_v2_tpu_torch.utils.config import load_yaml

    cfg = harness._load_json(os.path.join(harness.BENCH_DIR, "configs", name + ".json"))
    yaml_cfg = load_yaml(os.path.join(harness.ROOT, cfg["release_yaml"]))
    for section in ("TRAIN", "MODEL", "DATA_PRESET"):
        assert json.loads(json.dumps(yaml_cfg[section])) == cfg[section], section
    assert cfg["reduced"] == []
