"""The port's span recorder (``thrifty_tpu_torch.spans``), the detect
loop's spans and counts, and the native ring's wait counter, on the CPU
(and, marked ``cuda``, the loop on the card).

Small geometry (block 2048, history 256, a 5-bit Gold template, batches
of 8): a stream of 44 blocks, a burst every third block, read by
``StreamPump`` on its ring path (a stream without a file) and its mmap
path (a regular file), host unfold and ``batches_contiguous``.
"""

import io
import threading
import time
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import native, sim, spans  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import iq  # noqa: E402
from thrifty_tpu_torch.dsp import template as template_mod  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.io.stream import StreamPump  # noqa: E402
from thrifty_tpu_torch.pipeline.detect import detect_batches, \
    spans_line  # noqa: E402

BLOCK, HISTORY, BATCH = 2048, 256, 8
NEW = BLOCK - HISTORY
BLOCKS = 44  # five full batches and a short one
TPL = template_mod.generate(5, 0, 2.0)
WINDOW = (7, 110)
LOOP_ORDER = spans.SPANS


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    yield
    spans.disable()


def stream_bytes(seed=4):
    bursts = [{"position": b * NEW + 700.5, "carrier_bin": 40.25,
               "amplitude": 0.8, "phase": 0.3}
              for b in range(1, BLOCKS - 1, 3)]
    stream = sim.synth_stream(BLOCKS * NEW, bursts, TPL, block_len=BLOCK,
                              seed=seed)
    return iq.iq_to_raw(stream).tobytes()


def detector(gate=0, device="cpu"):
    return BatchDetector(TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=WINDOW,
        gate_capacity=gate), device=device)


def run(tmp_path, path="ring", device_unfold=False, gate=0, record=True,
        max_batches=4096, device="cpu"):
    """(batches as read [(idx0, n, raw copy)], records yielded, the
    recorder's batches, the pump's final ring wait)."""
    data = stream_bytes()
    if path == "mmap":
        (tmp_path / "s.u8").write_bytes(data)
        stream = open(tmp_path / "s.u8", "rb")
    else:
        stream = io.BytesIO(data)
    pump = StreamPump(stream, BLOCK, HISTORY, BATCH, sample_rate=2.4e6,
                      t0=1.5e9)
    assert (pump._ring is None) == (path == "mmap")
    read = []

    def tap(batches):
        for ts, idx, raw in batches:
            read.append((int(idx[0]), len(idx), np.array(raw, copy=True)))
            yield ts, idx, raw

    if record:
        spans.enable(max_batches)
    try:
        batches = pump.batches_contiguous() if device_unfold \
            else pump.batches()
        records = list(detect_batches(
            detector(gate, device), tap(batches), BATCH, rxid=0,
            device_unfold=device_unfold))
        return read, records, spans.batches(), pump.read_wait_ns
    finally:
        pump.close()
        stream.close()


def test_off_is_one_shared_no_op(monkeypatch):
    """With the recorder off, ``span()`` hands back one shared object,
    reads no clock and allocates nothing."""
    assert spans.span("upload", 0) is spans.span("submit", 1)

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    for i in range(10):  # warm
        with spans.span("upload", i):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(2000):
            with spans.span("upload", i) as s:
                s.drop()
            spans.count(i, rows=i)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, spans.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "filename") if d.size_diff > 0]
    assert grown == []
    assert spans.batches() == []


def test_off_records_nothing_in_a_run(tmp_path):
    read, records, kept, _ = run(tmp_path, record=False)
    assert len(read) == 6 and kept == []
    assert not spans.enabled()


@pytest.mark.parametrize("path,device_unfold", [
    ("ring", False), ("ring", True), ("mmap", False), ("mmap", True)])
def test_every_batch_has_every_span_in_loop_order(tmp_path, path,
                                                  device_unfold):
    read, records, kept, wait_ns = run(tmp_path, path, device_unfold)
    assert [r["batch"] for r in kept] == [b for b, _, _ in read]
    assert [b for b, _, _ in read] == list(range(0, BLOCKS, BATCH))
    for rec in kept:
        assert sorted(rec["spans"]) == sorted(LOOP_ORDER)
        stamps = [t for name in LOOP_ORDER for t in rec["spans"][name]]
        assert stamps == sorted(stamps), rec
    # One batch in flight: batch k drains after batch k+1's submit.
    for a, b in zip(kept, kept[1:]):
        assert b["spans"]["submit"][1] <= a["spans"]["drain.wait"][0]
    ring = [r["counts"]["ring_wait_ns"] for r in kept]
    assert all(w >= 0 for w in ring)
    if path == "mmap":
        assert ring == [0] * len(kept) and wait_ns == 0
    else:
        assert sum(ring) <= wait_ns


def test_counts_are_the_outputs_own(tmp_path):
    read, records, kept, _ = run(tmp_path)
    ref = detector()
    for (b, n, raw), rec in zip(read, kept):
        padded = np.full((BATCH, 2 * BLOCK), 128, np.uint8)
        padded[:n] = raw
        out = ref.detect_raw(padded)
        assert rec["counts"]["rows"] == n
        assert rec["counts"]["carrier_rows"] == \
            int(out["carrier_detect"][:n].sum())
        assert rec["counts"]["corr_rows"] == BATCH
    assert sum(r["counts"]["carrier_rows"] for r in kept) > 0
    assert sum(r["counts"]["rows"] for r in kept) == BLOCKS


@pytest.mark.parametrize("gate", [1, 7])
def test_corr_rows_under_the_gate(tmp_path, gate):
    """Capacity C a batch; C plus the batch after an overflow (more
    carrier-positive rows than C)."""
    _, _, kept, _ = run(tmp_path, gate=gate)
    over = [r["counts"]["carrier_rows"] > gate for r in kept]
    assert [r["counts"]["corr_rows"] for r in kept] == \
        [gate + BATCH if o else gate for o in over]
    assert any(over) == (gate == 1)


def test_max_batches_bounds_what_is_kept(tmp_path):
    read, _, kept, _ = run(tmp_path, max_batches=3)
    assert [r["batch"] for r in kept] == [b for b, _, _ in read[-3:]]
    with pytest.raises(ValueError):
        spans.enable(0)


@pytest.mark.parametrize("device_unfold", [False, True])
def test_records_identical_on_and_off(tmp_path, device_unfold):
    off = run(tmp_path, device_unfold=device_unfold, record=False)[1]
    on = run(tmp_path, device_unfold=device_unfold)[1]
    assert np.concatenate(on).tobytes() == np.concatenate(off).tobytes()
    assert sum(len(r) for r in on) > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("device_unfold,gate", [(False, 0), (True, 0),
                                                (False, 1)])
def test_on_the_card(tmp_path, cuda_device, device_unfold, gate):
    """On the card (where ``drain.wait`` waits on a CUDA event): every
    span of every batch, and the records of a run without the
    recorder."""
    off = run(tmp_path, device_unfold=device_unfold, gate=gate,
              record=False, device=cuda_device)[1]
    read, on, kept, _ = run(tmp_path, device_unfold=device_unfold,
                            gate=gate, device=cuda_device)
    assert np.concatenate(on).tobytes() == np.concatenate(off).tobytes()
    assert [r["batch"] for r in kept] == [b for b, _, _ in read]
    for rec in kept:
        stamps = [t for name in LOOP_ORDER for t in rec["spans"][name]]
        assert stamps == sorted(stamps), rec
        if rec["counts"].get("overflowed"):
            wait, inner = rec["spans"]["drain.wait"], rec["spans"][spans.REDO]
            assert wait[0] <= inner[0] <= inner[1] <= wait[1]
        else:
            assert spans.REDO not in rec["spans"]
    assert any(r["counts"].get("overflowed") for r in kept) == bool(gate)


@pytest.mark.parametrize("how", ["read", "read_unfold"])
def test_ring_counts_the_consumers_wait(how):
    """A read whose producer writes only 50 ms after the consumer is
    about to block adds at least 40 ms to ``read_wait_ns``."""
    ring = native.RingBuffer(1 << 16)
    out = np.empty((2, 64), np.uint8)
    want = 2 * (64 - 16)
    data = np.arange(want, dtype=np.uint8)
    ring.write(data[:4])  # something buffered, not enough for a batch
    if how == "read":
        ring.read(4)
    else:
        want -= 4
    before = ring.read_wait_ns
    reading = threading.Event()

    def late():
        assert reading.wait(timeout=10)
        time.sleep(0.05)
        ring.write(data[:want] if how == "read" else data[4:])

    producer = threading.Thread(target=late)
    producer.start()
    try:
        reading.set()
        if how == "read":
            got = ring.read(want)
            assert len(got) == want
        else:
            assert ring.read_unfold(out, 16) == (2, 96)
    finally:
        producer.join(timeout=10)
    assert not producer.is_alive()
    waited = ring.read_wait_ns - before
    assert 40e6 <= waited < 5e9
    ring.read(0)
    assert ring.read_wait_ns - before == waited  # no wait, no count
    ring.close()


def test_spans_line(tmp_path):
    _, _, kept, _ = run(tmp_path)
    line = spans_line(kept)
    assert line.startswith("spans over 6 batches")
    for name in LOOP_ORDER:
        assert name + " " in line
    assert "ring_wait_ns" in line and "carrier rows" in line
    assert spans_line([]) == "spans: no batch recorded"


@pytest.mark.parametrize("quiet", [False, True])
def test_detect_reports_spans_unless_quiet(tmp_path, capsys, quiet):
    np.save(tmp_path / "t.npy", TPL)
    (tmp_path / "s.bin").write_bytes(stream_bytes())
    argv = ["detect", str(tmp_path / "s.bin"), "--raw",
            "--template", str(tmp_path / "t.npy"), "--block-size", "2048",
            "--history", "256", "--carrier-window", "7-110",
            "--batch-size", "8", "--t0", "1.5e9", "--device", "cpu",
            "-o", str(tmp_path / "o.toad")] + (["--quiet"] if quiet else [])
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert ("spans over 6 batches, mean ms a batch: ingest.read" in text) \
        != quiet
    assert not spans.enabled()


@pytest.mark.parametrize("gate", [0, 1, 7])
def test_gate_counts_and_redo_span(tmp_path, gate):
    """Every gated batch counts ``gate_rows`` (its carrier-positive rows,
    padding included) and ``overflowed``; exactly the overflowed ones
    hold one ``drain.redo``, inside ``drain.wait``; an ungated batch
    holds none of the three."""
    read, _, kept, _ = run(tmp_path, gate=gate)
    ref = detector()
    redo = 0
    for (b, n, raw), rec in zip(read, kept):
        counts, took = rec["counts"], rec["spans"]
        if not gate:
            assert "gate_rows" not in counts and "overflowed" not in counts
            assert spans.REDO not in took
            continue
        padded = np.full((BATCH, 2 * BLOCK), 128, np.uint8)
        padded[:n] = raw
        rows = int(ref.detect_raw(padded)["carrier_detect"].sum())
        assert counts["gate_rows"] == rows
        assert counts["overflowed"] == int(rows > gate)
        assert (spans.REDO in took) == (rows > gate)
        if spans.REDO in took:
            redo += 1
            wait, inner = took["drain.wait"], took[spans.REDO]
            assert wait[0] <= inner[0] <= inner[1] <= wait[1]
        assert counts["corr_rows"] == gate + (BATCH if rows > gate else 0)
    assert (redo > 0) == (gate == 1)
    assert redo == sum(r["counts"].get("overflowed", 0) for r in kept)


def host_reads(monkeypatch):
    """Counts the calls that copy a tensor's value to the host."""
    calls = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        inner = getattr(torch.Tensor, name)

        def spy(self, *a, _inner=inner, _name=name, **kw):
            calls.append(_name)
            return _inner(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return calls


def overflowing_batches(count=2):
    """``count`` batches of ``stream_bytes()`` as the device-unfold loop
    takes them (contiguous new bytes), each with more than one carrier."""
    data = np.frombuffer(stream_bytes(), np.uint8)
    step = BATCH * 2 * NEW
    return [(np.arange(b * BATCH, (b + 1) * BATCH, dtype=np.float64),
             np.arange(b * BATCH, (b + 1) * BATCH),
             data[b * step:(b + 1) * step].copy()) for b in range(count)]


@pytest.mark.parametrize("record", [False, True])
def test_resolving_an_overflow_reads_the_flag_once(monkeypatch, record):
    """The drain of an overflowing gated batch makes the host reads it
    makes without the recorder: the overflow flag and the outputs'
    copies.  Off, it reads no clock and files nothing."""
    def loop():
        det = detector(gate=1)
        calls = host_reads(monkeypatch)
        list(detect_batches(det, iter(overflowing_batches()), BATCH,
                            device_unfold=True))
        monkeypatch.undo()
        assert det.gate_overflows == 2
        return calls

    baseline = loop()
    assert baseline.count("__bool__") == 2
    if record:
        spans.enable()
    else:
        def no_clock():
            raise AssertionError("the clock was read")

        monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert loop() == baseline
    kept = spans.batches()
    if record:
        assert [r["counts"]["overflowed"] for r in kept] == [1, 1]
        assert all(r["counts"]["gate_rows"] > 1 for r in kept)
        assert all(spans.REDO in r["spans"] for r in kept)
    else:
        assert kept == []


class OnlyResult:
    """A wrapper that shows the loop nothing of the batch but
    ``result()``, as a caller's timing wrapper may."""

    def __init__(self, pending):
        self._pending = pending

    def result(self):
        return self._pending.result()


class Wrapped:
    """The detector behind a wrapper that passes attribute reads on and
    wraps each queued batch in :class:`OnlyResult`."""

    def __init__(self, det):
        self._det = det

    def __getattr__(self, name):
        return getattr(self._det, name)

    def submit_raw_stream(self, new_raw):
        return OnlyResult(self._det.submit_raw_stream(new_raw))


def test_gate_is_recorded_through_wrappers():
    """The loop learns what it files of the gate from the detector and
    the batch's outputs, so a detector and batches behind wrappers are
    recorded alike."""
    def kept(det):
        spans.enable()
        list(detect_batches(det, iter(overflowing_batches()), BATCH,
                            device_unfold=True))
        return [(r["counts"], sorted(r["spans"])) for r in spans.batches()]

    direct = kept(detector(gate=1))
    assert kept(Wrapped(detector(gate=1))) == direct
    assert [c["overflowed"] for c, _ in direct] == [1, 1]
    assert all(spans.REDO in names for _, names in direct)


def test_gated_spans_line(tmp_path):
    _, _, kept, _ = run(tmp_path, gate=1)
    line = spans_line(kept)
    over = sum(r["counts"]["overflowed"] for r in kept)
    assert spans.REDO + " " in line
    assert "overflowed {} of 6 gated batches".format(over) in line
    assert "overflowed" not in spans_line(run(tmp_path)[2])


def test_detect_reports_the_gate_on_its_spans_line(tmp_path, capsys):
    np.save(tmp_path / "t.npy", TPL)
    (tmp_path / "s.bin").write_bytes(stream_bytes())
    argv = ["detect", str(tmp_path / "s.bin"), "--raw",
            "--template", str(tmp_path / "t.npy"), "--block-size", "2048",
            "--history", "256", "--carrier-window", "7-110",
            "--batch-size", "8", "--t0", "1.5e9", "--device", "cpu",
            "--gate-capacity", "1", "-o", str(tmp_path / "o.toad")]
    assert main(argv) == 0
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("spans over 6 batches")][0]
    assert "drain.redo " in line and " of 6 gated batches" in line
