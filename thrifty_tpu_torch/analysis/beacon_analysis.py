"""CLI: beacon clock-sync quality between two receivers.

Fits the per-pair clock model through matched beacon detections and
reports the residuals in meters -- the direct measure of achievable
TDOA precision (reference thrifty/beacon_analysis.py:62-136).
Detects clock discontinuities as SDOA jumps > 10x the mean drift step.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu_torch.io import toad
from thrifty_tpu_torch.pipeline import matchmaker
from thrifty_tpu_torch.pipeline.tdoa import SPEED_OF_LIGHT


def beacon_match_pairs(detections, rx0, rx1, beacon_txid, window=0.2):
    """Indices [N, 2] of matched beacon detections for the two receivers."""
    sel = detections[
        np.isin(detections["rxid"], [rx0, rx1])
        & (detections["txid"] == beacon_txid)]
    order = np.argsort(sel["timestamp"], kind="stable")
    sel = sel[order]
    matches, _, _ = matchmaker.match_detections(sel, window=window,
                                                min_match=2)
    pairs = []
    for m in matches:
        rxids = [int(sel[i]["rxid"]) for i in m]
        if sorted(rxids) != sorted([rx0, rx1]):
            continue
        i0 = m[rxids.index(rx0)]
        i1 = m[rxids.index(rx1)]
        pairs.append((i0, i1))
    return sel, np.asarray(pairs, dtype=np.int64)


def find_discontinuities(sdoa, factor=10.0):
    """Indices where the SDOA step jumps > factor x its mean."""
    dsdoa = np.diff(sdoa)
    if len(dsdoa) == 0:
        return np.array([], dtype=np.int64)
    return np.where(np.abs(dsdoa) > np.abs(np.mean(dsdoa)) * factor)[0]


def analyze(detections, pairs, deg=2, sample_rate=2.4e6):
    """Fit clock models per continuous segment; return residual report.

    Returns a dict with residuals (samples), coefficients per segment,
    discontinuity indices, and summary stats in meters.
    """
    soa0 = detections["soa"][pairs[:, 0]]
    soa1 = detections["soa"][pairs[:, 1]]
    sdoa = soa1 - soa0
    discontinuities = find_discontinuities(sdoa)

    s2m = SPEED_OF_LIGHT / sample_rate
    edges = np.concatenate([[0], discontinuities + 1, [len(pairs)]])
    residuals, coefs, used = [], [], []
    for i in range(len(edges) - 1):
        left, right = int(edges[i]), int(edges[i + 1])
        if right - left < deg + 2:
            continue
        coef = np.polyfit(soa0[left:right], soa1[left:right], deg)
        fit = np.poly1d(coef)
        residuals.append(soa1[left:right] - fit(soa0[left:right]))
        coefs.append(coef)
        used.append((left, right))

    if residuals:
        all_res = np.concatenate(residuals)
        snr = np.mean(
            (detections["energy"][pairs[:, 0]]
             / detections["noise"][pairs[:, 0]]) ** 2)
        summary = {
            "residual_std_m": float(np.std(all_res) * s2m),
            "residual_max_m": float(np.max(np.abs(all_res)) * s2m),
            "avg_corr_snr_db": float(10 * np.log10(snr)),
        }
    else:
        all_res, summary = np.array([]), {}
    return {
        "residuals": all_res,
        "coefs": coefs,
        "segments": used,
        "discontinuities": discontinuities,
        "summary": summary,
    }


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", nargs="?", type=str, default="data.toads")
    parser.add_argument("rx0", type=int, help="first receiver ID")
    parser.add_argument("rx1", type=int, help="second receiver ID")
    parser.add_argument("beacon", type=int, help="beacon transmitter ID")
    parser.add_argument("-w", "--window", type=float, default=0.2)
    parser.add_argument("-d", "--degree", type=int, default=2)
    parser.add_argument("-s", "--sample-rate", type=float, default=2.4e6)
    parser.add_argument("--export", type=str, default=None,
                        help="save residual plot (pdf/png)")
    args = parser.parse_args(argv)

    detections = toad.load_toads(
        sys.stdin if args.input == "-" else args.input)
    sel, pairs = beacon_match_pairs(
        detections, args.rx0, args.rx1, args.beacon, args.window)
    print("Number of detection groups:", len(pairs))
    if len(pairs) < args.degree + 2:
        print("not enough matched beacon detections")
        return 1

    report = analyze(sel, pairs, args.degree, args.sample_rate)
    print("Number of discontinuities:", len(report["discontinuities"]))
    if report["summary"]:
        print("residuals: std dev = {residual_std_m:.1f} m; "
              "max = {residual_max_m:.1f} m; avg corr snr = "
              "{avg_corr_snr_db:.1f} dB".format(**report["summary"]))

    if args.export:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        s2m = SPEED_OF_LIGHT / args.sample_rate
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
        ax1.plot(report["residuals"] * s2m, ".-")
        ax1.set_title("Clock-sync residuals (m)")
        ax1.grid(True)
        ax2.hist(report["residuals"] * s2m, 20)
        ax2.set_title("Residual histogram (m)")
        fig.savefig(args.export)
        print("saved plot to", args.export)


if __name__ == "__main__":
    sys.exit(_main())
