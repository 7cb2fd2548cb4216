"""CLI: generate Gold codes and print sequence statistics."""

from __future__ import annotations

import argparse
import sys

from thrifty_tpu_torch.dsp import gold


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("length", type=int,
                        help="register length -- code length will be 2^n-1")
    parser.add_argument("index", nargs="?", type=int, default=0,
                        help="which Gold code of the family to generate")
    parser.add_argument("--stats", action="store_true",
                        help="print autocorrelation stats instead of bits")
    parser.add_argument("-p", "--plot", nargs="?", const="gold_autocorr.png",
                        default=None, metavar="FILE",
                        help="save an autocorrelation plot (reference "
                             "gold.py:85-96; written to FILE instead of "
                             "shown -- TPU hosts are headless)")
    args = parser.parse_args(argv)

    seq = gold.gold(args.length, args.index)
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        bipolar = gold.bipolar(seq)
        autocorr = np.correlate(bipolar, bipolar, "same")
        fig, ax = plt.subplots()
        ax.set_title("Length {} Gold code autocorrelation".format(len(seq)))
        ax.plot(np.arange(len(seq)) - len(seq) // 2, autocorr, ".-")
        fig.savefig(args.plot)
        plt.close(fig)
        # Notice goes to stderr: plotting is independent of the bit
        # output in the reference CLI (gold.py _main), so `gold 6 -p`
        # must still emit the sequence on stdout for piping.
        print("autocorrelation plot written to", args.plot, file=sys.stderr)
    if args.stats:
        stats = gold.autocorr_stats(seq)
        print("Peak amplitude: {:.0f}".format(stats["peak"]))
        print("Largest non-peak amplitude: {:.0f}".format(
            stats["max_sidelobe"]))
        print("Peak-to-max: {:.2f}".format(stats["peak_to_max"]))
        print("Peak-to-noise: {:.2f}".format(stats["peak_to_noise"]))
    else:
        print(" ".join(str(int(b)) for b in seq))


if __name__ == "__main__":
    sys.exit(_main())
