"""Record what the per-layer metric readers read, from a short traced run
on the card, as a fixture for their CPU tests.

    python3 benchmark/tools/record_fixture.py --workload <cell> \
        --out FILE.json.gz [--seconds 2] [--trace-seconds 0.25]

The fixture holds the traced slice's events (Chrome trace events reduced
to cat, name, ts, dur), the slice's length and batch count, each window
batch's span times and the values every reader returned on the card.
"""

import argparse
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import cells, session  # noqa: E402

SPAN_FIELDS = ("t_start", "t_ask", "t_got", "t_submit", "submit_s",
               "t_result", "t_records", "t_written")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--trace-seconds", type=float, default=0.25)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    session.TRACE_SECONDS = args.trace_seconds
    entry = cells.cell(cells.manifest(), args.workload)
    r = session.run_cell(entry, args.seed, args.seconds, True,
                         device=args.device)
    ctx = r["ctx"]
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
        "expected": r["per_layer"],
    }
    with gzip.open(args.out, "wt") as f:
        json.dump(fixture, f)
    print(json.dumps({"out": args.out, "events": len(ctx["events"]),
                      "per_layer": r["per_layer"], "correct": r["correct"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
