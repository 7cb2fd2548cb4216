"""``BENCHMARK.json`` keeps to the benchmark's contract, and everything
it names is found by name: configuration files, traffic files, metric
readers."""

import json
import os
import re

import pytest

from benchmark.harness import cells
from benchmark.reference.compare import COMPARED

SPEC = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    with open(os.path.join(cells.REPO, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in SPEC[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("entry", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_configs(entry):
    assert entry["file"] == "benchmark/configs/{}.json".format(entry["name"])
    settings = cells.config(entry["name"])
    assert settings["name"] == entry["name"]
    assert entry["reduced"] == []
    assert cells.template(settings).shape == (4914,)
    assert set(settings["limits"]) == set(COMPARED)
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"],
                         ids=[w["name"] for w in SPEC["workloads"]])
def test_workloads(entry):
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    path = os.path.join(cells.BENCH_DIR, "traffic",
                        entry["traffic"] + ".json")
    with open(path) as f:
        mix = json.load(f)
    assert mix["input"] in ("pipe", "card")
    e2e = cells.metrics_for(SPEC, entry["name"], 0)
    assert {m["name"] for m in e2e} == {"setup_s", "iq_samples_per_s"}
    assert cells.metrics_for(SPEC, entry["name"], 1)


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_readers(metric):
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    module = cells.reader(metric["name"])
    assert callable(module.read)
    cell_names = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cell_names)) <= cell_names
