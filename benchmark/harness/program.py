"""The port's own spans and counts (``thrifty_tpu_torch.spans``) as the
per-layer readers see them, and what the profiler trace says of them.

Nothing in the harness turns the program's recorder on yet: the
readers below are listed on no cell of ``BENCHMARK.json``.  Whoever
turns it on before a traced window (``benchmark/tools/
record_program_fixture.py`` does, with :func:`enable`) lets a reader
take the records of the window's batches, matched by the stream index
of each batch's first block (``Batch.idx[0]``), or ``ctx["program"]``
where a fixture or a test gives them.  Without records (the recorder
off, or a program without one) the readers return None.

The program stamps its spans with ``time.perf_counter_ns()``, the clock
of the harness's own spans; :func:`trace_offset_us` recovers the
harness's mapping of that clock onto the profiler trace's clock from a
run's result, and :func:`clock_check` says how much of the trace's CUDA
API calls the mapped spans hold.
"""

from __future__ import annotations

import bisect

from benchmark.harness import trace

# Batches the recorder keeps: more than a 51-s window holds at 1e9 IQ
# samples/s in batches of 256 blocks (~17,400), and the warm-up.
MAX_BATCHES = 1 << 15
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# The per-layer readers of the program's records.
READERS = ("upload_ms", "ring_wait_ms", "ingest_copy_ms", "device_wait_ms",
           "d2h_ms", "records_ms", "corr_useful_pct")


def _spans():
    try:
        from thrifty_tpu_torch import spans
    except ImportError:
        return None
    return spans


def enable():
    """Turn the program's recorder on afresh, if the program has one."""
    spans = _spans()
    if spans is not None:
        spans.enable(MAX_BATCHES)


def records(ctx):
    """The program's records of the window's batches, in window order."""
    if "program" in ctx:
        return ctx["program"] or []
    spans = _spans()
    if spans is None:
        return []
    kept = {r["batch"]: r for r in spans.batches()}
    found = []
    for b in ctx.get("window") or []:
        idx = getattr(b, "idx", None)
        if idx is not None and len(idx) and int(idx[0]) in kept:
            found.append(kept[int(idx[0])])
    return found


def span_ms(ctx, name):
    """Mean host ms a batch in the program span ``name``, or None."""
    took = [r["spans"][name] for r in records(ctx) if name in r["spans"]]
    if not took:
        return None
    return sum(t1 - t0 for t0, t1 in took) * 1e-6 / len(took)


def ingest_ms(ctx, wait):
    """Mean ms a batch of the ring's wait (``wait``) or of the rest of
    ``ingest.read`` (the copy out of the ring and the stamps), or None."""
    both = [(r["spans"]["ingest.read"], r["counts"]["ring_wait_ns"])
            for r in records(ctx)
            if "ingest.read" in r["spans"] and "ring_wait_ns" in r["counts"]]
    if not both:
        return None
    ns = [w if wait else (t1 - t0) - w for (t0, t1), w in both]
    return sum(ns) * 1e-6 / len(ns)


def corr_useful_pct(ctx):
    """100 x carrier-positive rows over the rows the correlation ran on,
    summed over the window's batches, or None."""
    counted = [r["counts"] for r in records(ctx)
               if "carrier_rows" in r["counts"]
               and "corr_rows" in r["counts"]]
    attempted = sum(c["corr_rows"] for c in counted)
    if not attempted:
        return None
    return 100.0 * sum(c["carrier_rows"] for c in counted) / attempted


# -- the program's spans on the trace's clock ---------------------------------

def trace_offset_us(window, harness_spans):
    """The trace's clock minus the host clock in microseconds, as the
    harness mapped its spans (``harness_spans``, a result's ``spans``:
    the mapped ``Batch.spans()`` of ``window``, in order)."""
    return harness_spans[0][1] - window[0].t_ask * 1e6


def trace_spans(recs, offset_us):
    """[(name, start_us, end_us)] of the records' spans on the trace's
    clock, sorted by start."""
    return sorted((name, t0 * 1e-3 + offset_us, t1 * 1e-3 + offset_us)
                  for r in recs for name, (t0, t1) in r["spans"].items())


def _holder(spans_sorted, starts, t):
    """The span of ``spans_sorted`` (sorted, disjoint) that holds t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans_sorted[i][2] >= t:
        return spans_sorted[i]
    return None


def clock_check(events, prog_spans):
    """(percent of the trace's CUDA API calls (``RUNTIME_CATS``) whose
    middle lies in a program span, the kernel launch calls outside
    ``submit``); (None, 0) without such calls."""
    ordered = sorted(prog_spans, key=lambda s: s[1])
    starts = [s[1] for s in ordered]
    inside = total = outside_submit = 0
    for e in events:
        if e["cat"] not in RUNTIME_CATS:
            continue
        total += 1
        held = _holder(ordered, starts, e["ts"] + e["dur"] / 2)
        inside += held is not None
        if e["name"] in LAUNCHES and (held is None or held[0] != "submit"):
            outside_submit += 1
    if not total:
        return None, 0
    return 100.0 * inside / total, outside_submit


def idle_by_span_ms(events, prog_spans, harness_spans, batches):
    """{label: ms a batch} of every idle gap of the device in the traced
    slice, each put down to the program span that holds its middle, else
    to the harness span that does, else to ``loop`` (the rule of
    ``trace.idle_gaps`` with the program's spans listed first);
    ``batches``: the batches submitted in the slice."""
    held_by = []
    for group in (prog_spans, harness_spans):
        ordered = sorted(group, key=lambda s: s[1])
        held_by.append((ordered, [s[1] for s in ordered]))
    busy = trace.union((d["ts"], d["ts"] + d["dur"])
                       for d in trace.device_events(events))
    total = {}
    for a, b in zip(busy, busy[1:]):
        if b[0] <= a[1]:
            continue
        mid = (a[1] + b[0]) / 2
        label = "loop"
        for ordered, starts in held_by:
            held = _holder(ordered, starts, mid)
            if held is not None:
                label = held[0]
                break
        total[label] = total.get(label, 0.0) \
            + (b[0] - a[1]) * 1e-3 / batches
    return total
