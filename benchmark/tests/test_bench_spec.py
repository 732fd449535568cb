"""BENCHMARK.json against the benchmark's contract: every name it gives
has its file, and every name and unit uses the allowed characters."""
import json
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry["name"]
    for cell in SPEC["workloads"]:
        yield "config", cell["config"]
        yield "traffic", cell["traffic"]
    for c in SPEC["configs"]:
        for key in c["reduced"]:
            yield "reduced", key


@pytest.mark.parametrize("group,name", list(_names()))
def test_name_characters(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    configs = {c["name"]: c for c in SPEC["configs"]}
    config = configs[cell["config"]]
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == cell["config"]
    assert (BENCH / "configs" / cfg["scene"]).is_file()
    assert sorted(config["reduced"]) == sorted(cfg["reduced"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200


def test_names_unique_and_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert "setup_s" in metrics
