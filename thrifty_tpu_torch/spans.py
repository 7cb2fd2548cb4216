"""Per-batch spans and counts of the detect loop, on the host clock.

The recorder is off (``None``) until :func:`enable` turns it on.  While
it is off, :func:`span` returns one shared no-op context manager: it
reads no clock and allocates nothing, so the loop runs as without it.
While it is on, each span stamps ``time.perf_counter_ns()`` at entry and
exit and files the pair under its batch, and :func:`count` files counts
the same way.  A batch is named by the stream index of its first block,
``int(idx[0])``, which the reader, the detect loop and a caller holding
the batch's indices all know, so one batch's spans share one id.

Only the main thread writes to the recorder (the reader thread's side
is the native ring's own counters).  Only the last ``max_batches``
batches are kept, so a long run cannot grow it without bound.

Spans: ``ingest.read`` (``io.stream.StreamPump``), ``upload``
(``pipeline.host.PinnedUpload``), ``submit``, ``drain.wait``,
``drain.copy`` and ``drain.records`` (``pipeline.detect.detect_batches``);
on a gated batch that overflowed, ``drain.redo`` inside ``drain.wait``:
the full-batch re-run of its correlation.
Counts: ``ring_wait_ns`` at ``ingest.read``; ``rows``, ``carrier_rows``
and ``corr_rows`` in drain, and on a gated batch ``gate_rows`` (the
carrier-positive rows the gate compared with its capacity) and
``overflowed`` (0 or 1).
"""

from __future__ import annotations

import collections
import time

# The spans in the order the detect loop runs them for one batch.
SPANS = ("ingest.read", "upload", "submit", "drain.wait", "drain.copy",
         "drain.records")
# The span that only an overflowed gated batch has, inside drain.wait.
REDO = "drain.redo"

_recorder = None


class _Recorder:
    def __init__(self, max_batches):
        self.max_batches = max_batches
        self.records = collections.OrderedDict()

    def entry(self, batch):
        rec = self.records.get(batch)
        if rec is None:
            rec = self.records[batch] = {"batch": batch, "spans": {},
                                         "counts": {}}
            if len(self.records) > self.max_batches:
                self.records.popitem(last=False)
        return rec


class _Span:
    __slots__ = ("_rec", "_name", "_batch", "_t0")

    def __init__(self, rec, name, batch):
        self._rec = rec
        self._name = name
        self._batch = batch

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rec is not None:
            self._rec.entry(self._batch)["spans"][self._name] = (self._t0,
                                                                 t1)
        return False

    def drop(self):
        """File nothing: the span ended without a batch (a read that
        found the stream's end)."""
        self._rec = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self):
        pass


_OFF = _Off()


def enable(max_batches=4096):
    """Turn a fresh recorder on, keeping the last ``max_batches``
    batches."""
    global _recorder
    if max_batches < 1:
        raise ValueError("max_batches must be >= 1")
    _recorder = _Recorder(int(max_batches))


def disable():
    """Turn the recorder off and drop what it kept."""
    global _recorder
    _recorder = None


def enabled():
    return _recorder is not None


def span(name, batch):
    """Context manager timing ``name`` of batch ``batch``; the shared
    no-op when the recorder is off."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, batch)


def count(batch, **values):
    """File counts of batch ``batch``; nothing when the recorder is off
    (callers that must compute a count test :func:`enabled` first)."""
    rec = _recorder
    if rec is not None:
        rec.entry(batch)["counts"].update(values)


def batches():
    """The kept batches' records, oldest first: ``{"batch": id, "spans":
    {name: (t0_ns, t1_ns)}, "counts": {name: value}}``."""
    rec = _recorder
    return [] if rec is None else list(rec.records.values())
