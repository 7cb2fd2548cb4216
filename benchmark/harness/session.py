"""One run of one cell: set-up, warm-up, the measured window through the
port's ``detect_batches``, the reference check and the result line.

The window drives ``thrifty_tpu_torch.pipeline.detect.detect_batches``
as ``detect`` does, fed by the port's own readers, and writes every
batch's records to a ``.toad`` file through ``io.toad``.  The harness's
spans sit around the calls into each layer: the reader's ``next()``
(ingest), the detector's ``submit_raw*`` (the detector program's launch)
and the returned batch's ``result()`` up to its records (drain).
"""

from __future__ import annotations

import collections
import dataclasses
import tempfile
import time

import numpy as np

from benchmark.harness import cells, traffic as traffic_mod
from benchmark.harness.trace import Tracer

clock = time.perf_counter
FORBIDDEN = ("jax", "jaxlib", "flax", "thrifty_tpu")
# The slice of the window a --trace 1 run profiles, in seconds.
TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Batch:
    """One batch through the pipeline, host clock seconds."""

    t_start: float      # the reader starts producing it
    t_ask: float        # the harness asks the reader for it
    t_got: float        # the reader hands it over
    idx: np.ndarray     # its block indices
    t_submit: float = 0.0
    submit_s: float = 0.0
    t_result: float = 0.0
    t_records: float = 0.0
    t_written: float = 0.0
    first: int = 0      # its first record's line in the .toad file
    records: int = 0

    def spans(self):
        """[(layer, start, end)] of the harness's spans of this batch."""
        return [("ingest", self.t_ask, self.t_got),
                ("submit", self.t_submit, self.t_submit + self.submit_s),
                ("drain", self.t_result, self.t_records),
                ("write", self.t_records, self.t_written)]


class TimedReader:
    """Wraps the reader's iterator; keeps each batch's :class:`Batch`
    in order (``fifo``) and the batch being submitted (``current``)."""

    def __init__(self, it, starts):
        self._it = iter(it)
        self._starts = starts
        self.fifo = collections.deque()
        self.current = None

    def __iter__(self):
        while True:
            t_ask = clock()
            try:
                ts, idx, raw = next(self._it)
            except StopIteration:
                return
            t_got = clock()
            t_start = self._starts.popleft() if self._starts is not None \
                else t_ask
            self.current = Batch(t_start, t_ask, t_got,
                                 np.array(idx, dtype=np.int64, copy=True))
            self.fifo.append(self.current)
            yield ts, idx, raw


class PendingProxy:
    """The returned batch, with its ``result()`` timed."""

    def __init__(self, pending, batch):
        self._pending = pending
        self._batch = batch

    def result(self):
        self._batch.t_result = clock()
        return self._pending.result()


class DetectorProxy:
    """The detector ``detect_batches`` is given: the port's
    ``BatchDetector`` with its ``submit_raw*`` timed."""

    def __init__(self, detector, reader):
        self._det = detector
        self._reader = reader
        self.submits = 0

    def __getattr__(self, name):
        return getattr(self._det, name)

    def _timed(self, fn, arg):
        batch = self._reader.current
        batch.t_submit = clock()
        pending = fn(arg)
        batch.submit_s = clock() - batch.t_submit
        self.submits += 1
        return PendingProxy(pending, batch)

    def submit_raw(self, raw):
        return self._timed(self._det.submit_raw, raw)

    def submit_raw_stream(self, new_raw):
        return self._timed(self._det.submit_raw_stream, new_raw)


def detector_config(settings, overrides=None):
    from thrifty_tpu_torch.dsp.detector import DetectorConfig

    s = dict(settings, **(overrides or {}))
    return DetectorConfig(
        block_len=s["block_size"], history_len=s["block_history"],
        carrier_thresh=tuple(s["carrier_threshold"]),
        carrier_window=tuple(s["carrier_window"]),
        corr_thresh=tuple(s["corr_threshold"]),
        sync_mode=s["sync_mode"], carrier_interp=s["carrier_interp"],
        corr_interp=s["corr_interp"], fft_impl=s["fft_impl"],
        fft_precision=s["fft_precision"],
        gate_capacity=s["gate_capacity"])


def forbidden_modules():
    import sys

    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(entry, seed, seconds, trace, device="cuda",
             overrides=None, sizes=None, t_process=None):
    """Run one cell, ``entry`` a ``workloads`` entry of the manifest (its
    ``name``, ``config`` and ``traffic``); returns the result dict (see
    ``run.py``).

    ``overrides``: detector settings replacing the configuration's
    (the control runs the program's TF32 path this way); ``sizes``:
    traffic and configuration keys replaced for a test run.
    """
    t_process = clock() if t_process is None else t_process
    stamps = {}
    spec = cells.manifest()
    workload = entry["name"]
    settings = cells.config(entry["config"])
    traffic = traffic_mod.load(entry["traffic"])
    for key, value in (sizes or {}).items():
        if key in settings:
            settings[key] = value
        else:
            traffic[key] = value
    template = cells.template(settings)

    import torch

    from thrifty_tpu_torch.device import resolve_device
    from thrifty_tpu_torch.dsp.detector import BatchDetector
    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.pipeline.detect import detect_batches

    from benchmark.harness import inputs

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    stamps["imports"] = clock()
    with tempfile.TemporaryDirectory(prefix="thrifty_bench_") as tmpdir:
        base_u8, placed = traffic_mod.base_stream(traffic, settings,
                                                  template, seed)
        stamps["traffic"] = clock()
        detector = BatchDetector(template,
                                 detector_config(settings, overrides),
                                 device=dev)
        tracer = Tracer(tmpdir, cuda)
        if trace:
            tracer.prewarm()
        stamps["detector"] = clock()
        kind = traffic["input"]
        if kind == "pipe":
            source = inputs.PipeSource(base_u8, settings, traffic, tmpdir,
                                       traffic["device_unfold"])
            raw_batches = source.batches()
        elif kind == "card":
            archived = traffic_mod.touched_blocks(
                placed, settings, traffic["base_blocks"], len(template))
            source = inputs.CardSource(base_u8, settings, traffic, tmpdir,
                                       archived)
            raw_batches = source.batches(clock)
        else:
            raise ValueError("unknown input {!r}".format(kind))

        readers = [cells.reader(m["name"])
                   for m in cells.metrics_for(spec, workload, 1)] \
            if trace else []
        ctx = {"settings": settings, "traffic": traffic,
               "device_name": torch.cuda.get_device_name(dev) if cuda
               else dev.type}

        stamps["input"] = clock()
        reader = TimedReader(raw_batches, source.starts)
        proxy = DetectorProxy(detector, reader)
        toad_path = tmpdir + "/window.toad"
        out = open(toad_path, "w")
        gen = detect_batches(proxy, iter(reader), settings["batch_size"],
                             rxid=settings.get("rxid", 0),
                             device_unfold=traffic.get("device_unfold",
                                                       False))
        warmup = traffic["warmup_batches"]
        done = written = 0
        window = []            # batches whose records were written in it
        t_win0 = t_end = None
        trace_info = {}
        overflows0 = 0
        try:
            for records in gen:
                batch = reader.fifo.popleft()
                batch.t_records = clock()
                toad.save(out, records)
                out.flush()
                batch.t_written = clock()
                batch.first, batch.records = written, len(records)
                written += len(records)
                done += 1
                if t_win0 is None:
                    stamps.setdefault("first_batch", batch.t_written)
                    if done < warmup:
                        continue
                    if trace:
                        trace_info = {"t0": tracer.start(),
                                      "submits0": proxy.submits}
                    elif cuda:
                        torch.cuda.synchronize()
                    t_win0 = clock()
                    t_end = t_win0 + seconds
                    overflows0 = detector.gate_overflows
                    continue
                if batch.t_written > t_end:
                    break
                window.append(batch)
                if tracer.active and batch.t_written \
                        >= trace_info["t0"] + min(TRACE_SECONDS, seconds):
                    trace_info["window_s"] = tracer.stop() \
                        - trace_info["t0"]
                    trace_info["batches"] = proxy.submits \
                        - trace_info["submits0"]
        finally:
            gen.close()
            source.close()
            out.close()
        if tracer.active:
            trace_info["window_s"] = tracer.stop() - trace_info["t0"]
            trace_info["batches"] = proxy.submits - trace_info["submits0"]
        if t_win0 is None:
            raise RuntimeError("the input ended before the window opened")
        overflows = detector.gate_overflows - overflows0
        if cuda:
            torch.cuda.synchronize()
            memory_peak = int(torch.cuda.max_memory_allocated(dev))
        else:
            memory_peak = 0
        setup_s = t_win0 - t_process
        events = tracer.read() if trace else None
        spans = [(name, tracer.to_trace_us(a), tracer.to_trace_us(b))
                 for batch in window for name, a, b in batch.spans()] \
            if trace else None
        del detector, proxy, gen, reader
        if cuda:
            torch.cuda.empty_cache()

        # -- the reference check, once the window has closed ----------------
        t_ref = clock()
        from benchmark.reference.compare import Judge, read_toad, verdict

        if kind == "card":
            key_of, bytes_of, ts_of = inputs.card_reference_blocks(
                source.path)
        else:
            key_of, bytes_of, ts_of = inputs.stream_reference_blocks(
                base_u8, settings, traffic)
        judge = Judge(settings, template, key_of, bytes_of, ts_of)
        records = read_toad(toad_path)
        numbers, info = judge.judge(
            [(b.idx, b.first, b.records) for b in window], records)
        correct, rows = verdict(numbers, settings["limits"])
        info["reference_s"] = clock() - t_ref
        info["setup"] = {k: v - t_process for k, v in stamps.items()}
        if window:
            # Mean host ms a batch in each harness span, and the mean
            # period between batches: where a slow run spent its time.
            info["spans_ms"] = {
                name: 1e3 * sum(b - a for n, a, b in
                                (s for w in window for s in w.spans())
                                if n == name) / len(window)
                for name in ("ingest", "submit", "drain", "write")}
            info["spans_ms"]["period"] = 1e3 * (
                window[-1].t_written - window[0].t_written) \
                / max(len(window) - 1, 1)

    new_len = settings["block_size"] - settings["block_history"]
    blocks = sum(len(b.idx) for b in window)
    result = {
        "window": window, "seconds": seconds, "setup_s": setup_s,
        "samples": blocks * new_len, "memory_peak": memory_peak,
        "overflows": overflows, "events": events, "trace": trace_info,
        "spans": spans,
        "correct": correct, "checks": rows, "info": info,
    }
    if trace:
        ctx.update({"window": window, "events": events,
                    "trace": trace_info, "overflows": overflows})
        result["per_layer"] = {}
        for m, r in zip(cells.metrics_for(spec, workload, 1), readers):
            value = r.read(ctx)
            if value is not None:
                result["per_layer"][m["name"]] = value
        result["ctx"] = ctx
    return result


def end_to_end(result):
    """The end-to-end metrics of a window."""
    lat = [(b.t_written - b.t_start) * 1e3 for b in result["window"]]
    return {
        "iq_samples_per_s": result["samples"] / result["seconds"],
        "detect_latency_p95_ms": float(np.percentile(lat, 95)) if lat
        else None,
        "setup_s": result["setup_s"],
    }
