"""A short traced run on the card, read through the program's own spans
and counts (``thrifty_tpu_torch.spans``): the readers' values, the clock
check and the device's idle time put down to the span that holds it;
optionally kept as a fixture for the readers' CPU tests.

    python3 benchmark/tools/record_program_fixture.py --workload <cell> \
        [--out FILE.json.gz] [--seconds 2] [--trace-seconds 0.25]

A cell not in ``BENCHMARK.json`` is named by its files:
``--workload <name> --config <config> --traffic <traffic>``.

The tool turns the program's recorder on itself, on any cell, and reads
every reader of the program's records (``program.READERS``) whether the
cell lists it or not.  Prints one JSON line: ``correct``, the per-layer
values, the clock check
(``runtime_in_spans_pct``: the share of the trace's CUDA API calls
that lie inside a program span once mapped onto the trace's clock;
``launches_outside_submit``), ``idle_by_span_ms`` (every
idle gap of the traced slice, ms a batch, by the program span, else the
harness span, that holds its middle, else ``loop``) and the ten longest
gaps labelled so.  The fixture holds what ``record_fixture.py``'s does,
plus the window batches' program records (``program``), the offset of
the trace's clock (``offset_us``) and the readings above.
"""

import argparse
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import cells, program, session, trace  # noqa: E402

SPAN_FIELDS = ("t_start", "t_ask", "t_got", "t_submit", "submit_s",
               "t_result", "t_records", "t_written")


def readings(events, recs, offset_us, harness_spans, batches):
    """The clock check and the idle time by span of one traced run."""
    prog_spans = program.trace_spans(recs, offset_us)
    share, outside = program.clock_check(events, prog_spans)
    return {
        "runtime_in_spans_pct": share,
        "launches_outside_submit": outside,
        "idle_by_span_ms": program.idle_by_span_ms(
            events, prog_spans, harness_spans, batches),
        "idle_gaps": trace.idle_gaps(events, prog_spans + harness_spans),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--trace-seconds", type=float, default=0.25)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", default=None)
    parser.add_argument("--traffic", default=None)
    args = parser.parse_args(argv)
    session.TRACE_SECONDS = args.trace_seconds
    if args.config:
        entry = {"name": args.workload, "config": args.config,
                 "traffic": args.traffic, "chips": 1}
    else:
        entry = cells.cell(cells.manifest(), args.workload)
    program.enable()
    r = session.run_cell(entry, args.seed, args.seconds, True,
                         device=args.device)
    ctx = r["ctx"]
    recs = program.records(ctx)
    per_layer = dict(r["per_layer"])
    for name in program.READERS:
        value = cells.reader(name).read(ctx)
        if value is not None:
            per_layer[name] = value
    offset_us = program.trace_offset_us(ctx["window"], r["spans"])
    read = readings(ctx["events"], recs, offset_us, r["spans"],
                    ctx["trace"]["batches"])
    if args.out:
        fixture = {
            "workload": args.workload,
            "device_name": ctx["device_name"],
            "settings": {"gate_capacity": ctx["settings"]["gate_capacity"]},
            "overflows": ctx["overflows"],
            "trace": ctx["trace"],
            "window": [[getattr(b, f) for f in SPAN_FIELDS]
                       for b in ctx["window"]],
            "events": ctx["events"],
            "spans": r["spans"],
            "program": recs,
            "offset_us": offset_us,
            "readings": read,
            "expected": per_layer,
        }
        with gzip.open(args.out, "wt") as f:
            json.dump(fixture, f)
    print(json.dumps(dict(
        read, workload=args.workload, seed=args.seed, out=args.out,
        correct=r["correct"], batches=len(ctx["window"]),
        traced_batches=ctx["trace"]["batches"], records=len(recs),
        per_layer=per_layer, harness_idle_gaps=trace.idle_gaps(
            ctx["events"], r["spans"]),
        spans_ms=r["info"].get("spans_ms"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
