"""Each per-layer metric reader, on profiler traces and spans recorded
on the card (``benchmark/tools/record_fixture.py``), reads what it read
there; and the trace reductions on hand-made events."""

import glob
import gzip
import json
import os
import types

import pytest

from benchmark.harness import cells, trace

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "*.json.gz")))
READERS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(cells.BENCH_DIR, "metrics", "*.py")))
SPAN_FIELDS = ("t_start", "t_ask", "t_got", "t_submit", "submit_s",
               "t_result", "t_records", "t_written")


def context(fixture):
    return {
        "settings": fixture["settings"], "device_name":
        fixture["device_name"], "overflows": fixture["overflows"],
        "trace": fixture["trace"],
        "events": fixture["events"],
        "window": [types.SimpleNamespace(**dict(zip(SPAN_FIELDS, row)))
                   for row in fixture["window"]],
    }


CASES = [(path, name) for path in FIXTURES for name in READERS]


@pytest.mark.parametrize("path,name", CASES,
                         ids=["{}-{}".format(os.path.basename(p)[:-8], n)
                              for p, n in CASES])
def test_reader_on_recorded_trace(path, name):
    with gzip.open(path, "rt") as f:
        fixture = json.load(f)
    value = cells.reader(name).read(context(fixture))
    expected = fixture["expected"].get(name)
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected, rel=1e-9)


def test_fixtures_present():
    assert len(FIXTURES) >= 2


def test_busy_union_and_gaps():
    events = [
        {"cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "c", "ts": 40.0, "dur": 5.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20.0,
         "dur": 3.0},
        {"cat": "kernel", "name": "a", "ts": 100.0, "dur": 1.0},
    ]
    assert trace.busy_us(events) == 15.0 + 5.0 + 1.0
    assert trace.kernels(events)[0]["name"] == "a"
    assert trace.top_device_ops(events)[0] == ["a", pytest.approx(11e-6)]
    gaps = trace.idle_gaps(events, [("ingest", 50.0, 90.0)])
    assert gaps[0] == ["ingest", pytest.approx(55e-6)]
    assert gaps[1] == ["loop", pytest.approx(25e-6)]


def test_power_peak_us_is_the_mean_launch():
    reader = cells.reader("power_peak_us")
    assert reader.read({"events": []}) is None
    events = [{"cat": "kernel", "name": "power_peak_kernel<1>", "ts": 0.0,
               "dur": 20.0},
              {"cat": "kernel", "name": "vector_fft", "ts": 30.0,
               "dur": 50.0},
              {"cat": "kernel", "name": "power_peak_kernel<3>", "ts": 90.0,
               "dur": 10.0}]
    assert reader.read({"events": events}) == pytest.approx(15.0)
