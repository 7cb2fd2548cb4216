"""CLI: TDOA precision measurement (bias / std dev / RMS in meters).

The source of the framework's accuracy acceptance metric (reference
thrifty/tdoa_analysis.py:17-71): statistics of TDOA slices converted to
meters via the speed of light.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu_torch.pipeline import tdoa as tdoa_mod


def tdoa_stats(groups, rx0, rx1, tx=None, timestamp_range=None):
    """Collect matching TDOAs (meters) and their stats."""
    values, times = [], []
    for g in groups:
        if tx is not None and g.tx != tx:
            continue
        if timestamp_range is not None and not (
                timestamp_range[0] <= g.timestamp <= timestamp_range[1]):
            continue
        for t in g.tdoas:
            if int(t["rx0"]) == rx0 and int(t["rx1"]) == rx1:
                values.append(float(t["tdoa"]) * tdoa_mod.SPEED_OF_LIGHT)
                times.append(g.timestamp)
    values = np.asarray(values)
    if len(values) == 0:
        return None
    return {
        "n": len(values),
        "bias_m": float(np.mean(values)),
        "std_m": float(np.std(values)),
        "rms_m": float(np.sqrt(np.mean(values**2))),
        "values_m": values,
        "timestamps": np.asarray(times),
    }


def _parse_range(string):
    if string is None:
        return None
    a, b = string.split("-")
    return float(a), float(b)


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("tdoa", nargs="?", type=str, default="data.tdoa")
    parser.add_argument("--rx0", type=int, default=0)
    parser.add_argument("--rx1", type=int, default=1)
    parser.add_argument("--tx", type=int, default=None)
    parser.add_argument("--timestamp", type=_parse_range, default=None,
                        help="restrict to a start-stop timestamp range")
    parser.add_argument("--export", type=str, default=None,
                        help="save TDOA-vs-time plot (pdf/png)")
    args = parser.parse_args(argv)

    rx0, rx1 = sorted([args.rx0, args.rx1])
    groups = tdoa_mod.load_tdoa_groups(
        sys.stdin if args.tdoa == "-" else args.tdoa)
    stats = tdoa_stats(groups, rx0, rx1, args.tx, args.timestamp)
    if stats is None:
        print("no matching TDOAs")
        return 1
    print("Number of TDOAs: {}".format(stats["n"]))
    print("TDOA bias: {:.3f} m".format(stats["bias_m"]))
    print("TDOA std dev: {:.3f} m".format(stats["std_m"]))
    print("TDOA RMS: {:.3f} m".format(stats["rms_m"]))

    if args.export:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(stats["timestamps"], stats["values_m"], marker=".")
        ax.set_xlabel("timestamp")
        ax.set_ylabel("TDOA (m)")
        ax.grid(True)
        fig.savefig(args.export)
        print("saved plot to", args.export)


if __name__ == "__main__":
    sys.exit(_main())
