"""The profiler trace of a ``--trace 1`` run and what is read off it.

``torch.profiler`` records the device's kernels, copies and sets (CUPTI
activity, no host operations, so that the trace costs the host little)
over a slice at the start of the measured window, between two
synchronisations.  The trace is exported as Chrome trace JSON and reduced
here to plain event dicts, so that the metric readers can be tested on a
recorded fixture without a card.  The harness's own host spans, taken
with the host clock, are placed on the trace's clock to say what the
host was doing in each idle gap.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def events_from_chrome(path):
    """([{cat, name, ts, dur}] in microseconds, the trace's base time in
    microseconds since the epoch) of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3 \
        if isinstance(data, dict) else 0.0
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        out.append({"cat": e.get("cat", ""), "name": e.get("name", ""),
                    "ts": float(e["ts"]), "dur": float(e["dur"])})
    return out, base_us


def device_events(events):
    return [e for e in events if e["cat"] in DEVICE_CATS]


def kernels(events):
    return [e for e in events if e["cat"] == "kernel"]


def union(intervals):
    """[(start, end)] merged, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(events):
    """Microseconds in which some device operation ran."""
    return sum(e - s for s, e in union(
        (d["ts"], d["ts"] + d["dur"]) for d in device_events(events)))


def top_device_ops(events, n=10):
    """[[name, seconds]] of the device operations with the most time."""
    total = {}
    for e in device_events(events):
        total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]


def idle_gaps(events, spans, n=10):
    """[[label, seconds]] of the longest gaps between device operations,
    each labelled by the harness span (``spans``: [(label, start_us,
    end_us)] on the trace's clock) that holds its middle."""
    busy = union((d["ts"], d["ts"] + d["dur"])
                 for d in device_events(events))
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
            for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, mid in gaps[:n]:
        label = "loop"
        for name, lo, hi in spans:
            if lo <= mid <= hi:
                label = name
                break
        out.append([label, length * 1e-6])
    return out


class Tracer:
    """Profiles a slice of the window: :meth:`start` and :meth:`stop`
    each synchronise the device first."""

    def __init__(self, tmpdir, cuda=True):
        self.cuda = cuda
        self.active = False
        self.tmpdir = tmpdir
        self._prof = None
        self.base_us = 0.0
        self._epoch_us = 0.0  # epoch microseconds minus host clock

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA] if self.cuda
                       else [ProfilerActivity.CPU])

    def prewarm(self):
        """One throwaway profile in set-up: the profiler's first start
        loads and initialises CUPTI, which takes seconds."""
        import torch

        with self._profile():
            if self.cuda:
                (torch.ones(8, device="cuda") + 1).sum().item()

    def start(self):
        """Returns the host clock at which the traced slice opens."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.start()
        self.active = True
        t = time.perf_counter()
        self._epoch_us = time.time_ns() / 1e3 - t * 1e6
        return t

    def stop(self):
        """Returns the host clock at which the traced slice closes,
        once the device has finished the slice's work."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self._prof.stop()
        self.active = False
        return t

    def to_trace_us(self, t):
        """A host clock reading on the trace's clock."""
        return t * 1e6 + self._epoch_us - self.base_us

    def read(self):
        """Export and reduce the trace; the file is removed."""
        path = os.path.join(self.tmpdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            events, self.base_us = events_from_chrome(path)
        finally:
            os.remove(path)
        return events
