"""``BENCHMARK.json`` keeps to the benchmark's contract and names only
files that exist; every configuration, workload and metric loads by
its name."""

import json
import os
import re

import pytest

from portbench import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(cfg["name"])
    assert cfg["file"].startswith("portbench/")
    data = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    _, _, workload, config, driver = harness.load_cell(cell["name"])
    assert workload["config"] == cell["config"] == config["name"]
    for fn in ("setup", "window", "traced", "release", "check"):
        assert callable(getattr(driver, fn))
    reports = harness.cell_metrics(BENCH, cell["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], "per_layer")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert hasattr(harness.load_reader(m["name"]), "read")


def test_every_file_is_named():
    """Each workload, configuration and metric file is one that
    ``BENCHMARK.json`` names."""
    cells = {c["name"] for c in BENCH["workloads"]}
    configs = {os.path.basename(c["file"]) for c in BENCH["configs"]}
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert {f[:-5] for f in os.listdir(os.path.join(PKG, "workloads"))} \
        == cells
    assert set(os.listdir(os.path.join(PKG, "configs"))) == configs
    assert {f[:-3] for f in os.listdir(os.path.join(PKG, "metrics"))
            if f.endswith(".py")} == metrics
