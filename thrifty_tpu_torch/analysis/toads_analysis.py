"""CLI: statistics (and optional plots) of .toads detection data.

Stats mirror the reference's analyzer (thrifty/toads_analysis.py:35-77):
mean/std/min/max of carrier and correlation peak, noise, SNR, bin and
offsets, overall and per (RX, TX) pair.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu_torch.dsp import util
from thrifty_tpu_torch.io import toad


def _stat_line(name, values, fmt="{:.3f}"):
    template = ("{name}: mean=" + fmt + ", std=" + fmt + ", min=" + fmt
                + ", max=" + fmt)
    return template.format(name=name, *(
        [float(np.mean(values)), float(np.std(values)),
         float(np.min(values)), float(np.max(values))]))


def print_stats(data, file=None):
    """Print summary statistics for a detection array."""
    out = lambda s: print(s, file=file if file is not None else sys.stdout)
    out("Number of detections: {}".format(len(data)))
    if len(data) == 0:
        return
    out(_stat_line("Carrier peak", data["carrier_energy"], "{:.1f}"))
    out(_stat_line("Carrier noise", data["carrier_noise"], "{:.2f}"))
    out(_stat_line("Carrier SNR (dB)",
                   util.snr_db(data["carrier_energy"],
                               data["carrier_noise"]), "{:.1f}"))
    out(_stat_line("Carrier bin", data["carrier_bin"], "{:.1f}"))
    out(_stat_line("Carrier offset", data["carrier_offset"]))
    out(_stat_line("Corr peak", data["energy"], "{:.1f}"))
    out(_stat_line("Corr noise", data["noise"], "{:.2f}"))
    out(_stat_line("Corr SNR (dB)",
                   util.snr_db(data["energy"], data["noise"]), "{:.1f}"))
    out(_stat_line("Corr offset", data["offset"]))


def split_rxtx(detections):
    """{(rxid, txid): sub-array} split of a detection array."""
    out = {}
    for rxid in np.unique(detections["rxid"]):
        rx = detections[detections["rxid"] == rxid]
        for txid in np.unique(rx["txid"]):
            out[(int(rxid), int(txid))] = rx[rx["txid"] == txid]
    return out


def plot_columns(detections, columns, output=None):
    """Plot selected derived columns vs timestamp (requires matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    derived = {
        "freqs": lambda d: d["carrier_bin"] + d["carrier_offset"],
        "snr": lambda d: util.snr_db(d["energy"], d["noise"]),
        "carrier_snr": lambda d: util.snr_db(
            d["carrier_energy"], d["carrier_noise"]),
    }
    fig, axes = plt.subplots(
        len(columns), 1, figsize=(10, 3 * len(columns)), squeeze=False)
    for ax, col in zip(axes[:, 0], columns):
        # 'hist:<col>' draws per-(RX, TX) histograms instead of a
        # time series (the reference's histogram matrix views).
        as_hist = col.startswith("hist:")
        base = col[5:] if as_hist else col
        for (rxid, txid), sub in split_rxtx(detections).items():
            y = derived[base](sub) if base in derived else sub[base]
            label = "rx{} tx{}".format(rxid, txid)
            if as_hist:
                ax.hist(y, 30, alpha=0.5, label=label)
            else:
                ax.plot(sub["timestamp"], y, marker=".",
                        linestyle="none", label=label)
        ax.set_xlabel(base if as_hist else "timestamp")
        ax.set_ylabel("count" if as_hist else base)
        ax.legend(fontsize=6)
        ax.grid(True)
    fig.tight_layout()
    if output:
        fig.savefig(output)
    return fig


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", nargs="?", type=str, default="data.toads",
                        help=".toads data ('-' streams from stdin)")
    parser.add_argument("--per-rxtx", action="store_true",
                        help="also print stats per (RX, TX) pair")
    parser.add_argument("--plot", type=str, default=None, metavar="COLS",
                        help="comma-separated columns to plot (e.g. "
                             "freqs,snr,energy)")
    parser.add_argument("--export", type=str, default=None,
                        help="save plots to this file (pdf/png)")
    args = parser.parse_args(argv)

    data = toad.load_toads(sys.stdin if args.input == "-" else args.input)
    print_stats(data)
    if args.per_rxtx:
        for (rxid, txid), sub in split_rxtx(data).items():
            print("\n# Stats for RX #{} / TX #{}:".format(rxid, txid))
            print_stats(sub)
    if args.plot:
        plot_columns(data, args.plot.split(","),
                     output=args.export or "toads_analysis.pdf")
        print("saved plot to", args.export or "toads_analysis.pdf")


if __name__ == "__main__":
    sys.exit(_main())
