"""The readers of the program's own spans and counts
(``benchmark/harness/program.py``): on runs recorded on the card
(``benchmark/tools/record_program_fixture.py``), on hand-made records,
and with nothing to read; the clock check and the idle time by span."""

import glob
import gzip
import json
import os
import types

import numpy as np
import pytest

from benchmark.harness import cells, program

HERE = os.path.dirname(__file__)
FIXTURES = sorted(glob.glob(os.path.join(HERE, "fixtures", "program",
                                         "*.json.gz")))
OLD_FIXTURES = sorted(glob.glob(os.path.join(HERE, "fixtures",
                                             "*.json.gz")))
NEW = program.READERS
SPAN_FIELDS = ("t_start", "t_ask", "t_got", "t_submit", "submit_s",
               "t_result", "t_records", "t_written")


@pytest.fixture(autouse=True)
def recorder_off():
    from thrifty_tpu_torch import spans

    yield
    spans.disable()


def load(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def context(fixture):
    ctx = {
        "settings": fixture["settings"], "device_name":
        fixture["device_name"], "overflows": fixture["overflows"],
        "trace": fixture["trace"], "events": fixture["events"],
        "window": [types.SimpleNamespace(**dict(zip(SPAN_FIELDS, row)))
                   for row in fixture["window"]],
    }
    if "program" in fixture:
        ctx["program"] = fixture["program"]
    return ctx


def test_a_fixture_for_each_cell():
    cells_recorded = {load(p)["workload"] for p in FIXTURES}
    assert cells_recorded == {"rx_example.pipe_hostunfold",
                              "rx_example.pipe_devunfold"}


CASES = [(p, n) for p in FIXTURES for n in NEW]


@pytest.mark.parametrize("path,name", CASES, ids=[
    "{}-{}".format(os.path.basename(p)[:-8], n) for p, n in CASES])
def test_reader_reads_what_it_read_on_the_card(path, name):
    fixture = load(path)
    expected = fixture["expected"][name]
    assert expected is not None
    assert cells.reader(name).read(context(fixture)) == \
        pytest.approx(expected, rel=1e-9)


OLD_CASES = [(p, n) for p in OLD_FIXTURES for n in NEW]


@pytest.mark.parametrize("path,name", OLD_CASES, ids=[
    "{}-{}".format(os.path.basename(p)[:-8], n) for p, n in OLD_CASES])
def test_nothing_to_read_without_program_records(path, name):
    """The fixtures recorded before the program had spans hold no
    program records: every reader says None, with the recorder on and
    holding batches of another run."""
    from thrifty_tpu_torch import spans

    spans.enable(8)
    with spans.span("upload", 0):
        pass
    assert cells.reader(name).read(context(load(path))) is None
    assert cells.reader(name).read({"program": [], "window": []}) is None


def record(batch, t, wait_ns, carrier, corr):
    """A hand-made record: spans of 1, 2, ... ms in loop order from t
    ms, ``ingest.read`` holding ``wait_ns`` of ring wait."""
    spans, ms = {}, 1e6
    for i, name in enumerate(("ingest.read", "upload", "submit",
                              "drain.wait", "drain.copy", "drain.records")):
        spans[name] = (int(t * ms), int((t + i + 1) * ms))
        t += i + 1
    return {"batch": batch, "spans": spans,
            "counts": {"ring_wait_ns": wait_ns, "rows": 256,
                       "carrier_rows": carrier, "corr_rows": corr}}


HAND = [record(0, 0.0, 250_000, 3, 256), record(256, 30.0, 750_000, 9, 256)]
HAND_EXPECTED = {"upload_ms": 2.0, "ring_wait_ms": 0.5,
                 "ingest_copy_ms": 0.5, "device_wait_ms": 4.0,
                 "d2h_ms": 5.0, "records_ms": 6.0,
                 "corr_useful_pct": 100.0 * 12 / 512}


@pytest.mark.parametrize("name", NEW)
def test_reader_on_hand_made_records(name):
    value = cells.reader(name).read({"program": HAND})
    assert value == pytest.approx(HAND_EXPECTED[name], rel=1e-12)


def test_loading_a_reader_leaves_the_recorder_as_it_was():
    from thrifty_tpu_torch import spans

    spans.disable()
    for name in NEW:
        cells.reader(name)
    assert not spans.enabled()
    spans.enable(8)
    with spans.span("upload", 0):
        pass
    for name in NEW:
        cells.reader(name)
    assert len(spans.batches()) == 1


def test_live_records_matched_by_first_block():
    """With the recorder turned on (``program.enable``, afresh), the
    window's batches find their records by ``idx[0]``, in window
    order."""
    from thrifty_tpu_torch import spans

    spans.enable(8)
    with spans.span("upload", 1):
        pass
    program.enable()
    assert spans.enabled() and spans.batches() == []
    for bid in (0, 256, 512):
        with spans.span("upload", bid):
            pass
        spans.count(bid, carrier_rows=1, corr_rows=4)
    window = [types.SimpleNamespace(idx=np.arange(b, b + 256))
              for b in (512, 256)]
    found = program.records({"window": window})
    assert [r["batch"] for r in found] == [512, 256]
    assert program.corr_useful_pct({"window": window}) == 25.0
    spans.disable()
    assert program.records({"window": window}) == []


def test_clock_check_and_idle_by_span_on_hand_made_events():
    prog = [("submit", 10.0, 20.0), ("drain.wait", 30.0, 40.0)]
    harness = [("write", 45.0, 60.0)]
    ev = [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11.0,
           "dur": 1.0},
          {"cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 31.0,
           "dur": 1.0},
          {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 33.0,
           "dur": 1.0},
          {"cat": "cuda_runtime", "name": "cudaEventSynchronize",
           "ts": 41.0, "dur": 2.0},
          {"cat": "kernel", "name": "k", "ts": 0.0, "dur": 12.0},
          {"cat": "kernel", "name": "k", "ts": 32.0, "dur": 2.0},
          {"cat": "gpu_memcpy", "name": "c", "ts": 50.0, "dur": 2.0},
          {"cat": "kernel", "name": "k", "ts": 90.0, "dur": 1.0}]
    share, outside = program.clock_check(ev, prog)
    assert share == pytest.approx(75.0) and outside == 1
    assert program.clock_check(ev[4:], prog) == (None, 0)
    idle = program.idle_by_span_ms(ev, prog, harness, batches=2)
    # Gaps 12-32 (middle 22: no span), 34-50 (42: none), 52-90 (71:
    # none) and nothing in write: all three are the loop's.
    assert idle == {"loop": pytest.approx((20 + 16 + 38) * 1e-3 / 2)}
    harness = [("write", 40.0, 75.0)]
    idle = program.idle_by_span_ms(ev, prog, harness, batches=1)
    assert idle == {"write": pytest.approx(16e-3 + 38e-3),
                    "loop": pytest.approx(20e-3)}
    prog = [("upload", 15.0, 30.0)] + prog[1:]
    idle = program.idle_by_span_ms(ev, prog, harness, batches=1)
    assert idle["upload"] == pytest.approx(20e-3)


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p)[:-8] for p in FIXTURES])
def test_clock_check_on_the_card(path):
    """On the card's trace, the program's spans mapped onto the trace's
    clock hold 99% or more of the CUDA API calls, and
    every kernel launch call lies in ``submit``."""
    fixture = load(path)
    spans = program.trace_spans(fixture["program"], fixture["offset_us"])
    share, outside = program.clock_check(fixture["events"], spans)
    assert share >= 99.0
    assert outside == 0
    read = fixture["readings"]
    assert read["runtime_in_spans_pct"] == pytest.approx(share, rel=1e-12)
    idle = program.idle_by_span_ms(fixture["events"], spans,
                                   fixture["spans"],
                                   fixture["trace"]["batches"])
    assert idle == pytest.approx(read["idle_by_span_ms"], rel=1e-9)
    # The loop holds under 5% of the idle time once the program's spans
    # name the gaps.
    assert idle.get("loop", 0.0) < 0.05 * sum(idle.values())
