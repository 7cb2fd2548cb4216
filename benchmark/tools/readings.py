"""The readings that a cell's limits are set from, on the card: the
compared numbers of the program on many seeds, and of the control (the
program's own lower-precision path, the configuration's ``control``
settings: TF32 matmul transforms) on the same seeds, at the cell's own
sizes and load, all in one process.

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 11,12,13 [--seconds 6] [--control] [--out FILE]

A cell that ``BENCHMARK.json`` does not hold yet is named by its files:
``--workload <name> --config <config> --traffic <traffic>``.

Prints one JSON line per run: the seed, ``correct`` under the current
limits, each compared number and the reference's counts.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import cells, session  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--config", default=None)
    parser.add_argument("--traffic", default=None)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.config:
        entry = {"name": args.workload, "config": args.config,
                 "traffic": args.traffic, "chips": 1}
    else:
        entry = cells.cell(cells.manifest(), args.workload)
    settings = cells.config(entry["config"])
    overrides = settings["control"] if args.control else None
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        try:
            r = session.run_cell(entry, seed, args.seconds, False,
                                 device=args.device, overrides=overrides)
            line = {"workload": args.workload, "seed": seed,
                    "control": args.control, "correct": r["correct"],
                    "checks": {n: v for n, v, _ in r["checks"]},
                    "info": r["info"],
                    "metrics": session.end_to_end(r)}
        except Exception as e:  # noqa: BLE001 -- a control may crash
            line = {"workload": args.workload, "seed": seed,
                    "control": args.control, "error": repr(e)}
        text = json.dumps(line, default=float)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
