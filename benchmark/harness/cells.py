"""Everything the harness finds by name: the manifest's cell and
metrics, the configuration file, the traffic file and the per-layer
metric readers.  A new configuration, mix, cell or metric is a new file
and a new entry in ``BENCHMARK.json``; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec, name):
    """The workload entry called ``name``."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload named {!r} in BENCHMARK.json".format(name))


def config(name):
    """The settings of the configuration called ``name``
    (``benchmark/configs/<name>.json``, its ``file`` in the manifest)."""
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def template(settings):
    """The template a configuration file names, from its folder."""
    import numpy as np

    return np.load(os.path.join(BENCH_DIR, "configs", settings["template"]))


def metrics_for(spec, workload, trace):
    """The metric entries this cell reports: the end-to-end ones with
    ``trace`` 0, the per-layer ones with ``trace`` 1."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name):
    """The per-layer metric module ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
