"""Merge receiver detections, identify transmitter IDs, remove duplicates.

Vectorized re-design of the reference's integrate stage
(thrifty/identify.py): transmitter classification and duplicate removal
operate on the whole structured detection array at once.

TX identification is by carrier frequency: either a frequency-map config
(``txid: start - stop`` bin ranges plus per-RX ``@rxid: offset`` lines,
reference thrifty/identify.py:189-214) or automatic window discovery
from the carrier-bin histogram (reference thrifty/identify.py:26-76).
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import sys

import numpy as np

from thrifty_tpu_torch.config.settings import parse_kv_config
from thrifty_tpu_torch.io import toad

UNIDENTIFIED = -1


def detect_transmitter_windows(freq_bins, verbose=False):
    """Discover TX frequency windows from a carrier-bin histogram.

    Runs of histogram counts above ``1.25*std`` (ended when counts drop
    below ``0.4*std``) are peaks; window edges are midpoints between
    adjacent peaks.  Returns the array of window edges (len = #tx + 1).
    """
    freq_bins = np.asarray(freq_bins)
    first = int(np.min(freq_bins))
    counts = np.bincount(freq_bins - first)
    low = np.std(counts) * 0.4
    high = np.std(counts) * 1.25

    peaks = []
    in_peak = False
    start = 0
    for i, cnt in enumerate(counts):
        if in_peak and cnt < low:
            peaks.append((start, i))
            in_peak = False
        elif not in_peak and cnt > high:
            start = i
            in_peak = True
    if in_peak:
        peaks.append((start, len(counts) - 1))

    edges = [(peaks[i][1] + peaks[i + 1][0]) // 2
             for i in range(len(peaks) - 1)]
    edges = np.concatenate(
        [[first], np.asarray(edges, dtype=np.int64) + first,
         [first + len(counts)]])
    if verbose:
        print("window thresholds: low={:.2f} high={:.2f}; {} transmitter(s)"
              .format(low, high, len(edges) - 1))
    return edges


def auto_classify(detections):
    """Assign txids from per-receiver carrier-bin histograms."""
    txids = np.full(len(detections), UNIDENTIFIED, dtype=np.int32)
    for rxid in np.unique(detections["rxid"]):
        sel = detections["rxid"] == rxid
        edges = detect_transmitter_windows(detections["carrier_bin"][sel])
        txids[sel] = np.digitize(
            detections["carrier_bin"][sel], edges[:-1]) - 1
    return txids


def classify_by_freqmap(detections, freqmap, warned=None):
    """Assign txids from a frequency-map {rxid: {txid: (start, stop)}}.

    ``warned`` is an optional caller-owned set of rxids already warned
    about; repeated callers (the live server) pass a persistent set so
    each unmapped receiver is reported once.  Without it every call
    warns (stateless library behavior).
    """
    freq = detections["carrier_bin"] + detections["carrier_offset"]
    txids = np.full(len(detections), UNIDENTIFIED, dtype=np.int32)
    unmapped = set(int(r) for r in np.unique(detections["rxid"])) \
        - set(freqmap)
    if warned is not None:
        unmapped -= warned
    if unmapped:
        # A receiver without an '@rxid: offset' line would silently lose
        # every detection to the unidentified filter.
        if warned is not None:
            warned.update(unmapped)
        print("warning: no freq-map entry for receiver(s) {}; their "
              "detections will be dropped as unidentified".format(
                  sorted(unmapped)), file=sys.stderr)
    for rxid, ranges in freqmap.items():
        rx_sel = detections["rxid"] == rxid
        for txid, (start, stop) in ranges.items():
            hit = rx_sel & (freq >= start) & (freq <= stop)
            txids[hit] = txid
    return txids


def identify_transmitters(detections, freqmap=None, warned=None):
    """Set the txid field in-place; returns the array for chaining."""
    if freqmap is None:
        detections["txid"] = auto_classify(detections)
    else:
        detections["txid"] = classify_by_freqmap(detections, freqmap,
                                                 warned=warned)
    return detections


def duplicate_mask(detections, ignore_txid=False, soa_tol=None):
    """Boolean keep-mask removing adjacent-block duplicate detections.

    A burst straddling a block boundary fires in both blocks (the shared
    history); the weaker detection of any (rxid, txid, block+-1) neighbor
    pair is dropped, as are unidentified detections
    (reference thrifty/identify.py:134-164).

    With ``ignore_txid`` the neighbor comparison spans transmitter IDs:
    needed when txids come from a template bank, where the weak partial
    signal in the adjacent block can win on the wrong code.  CAUTION:
    without ``soa_tol`` this can also drop a legitimate weaker burst of
    a DIFFERENT transmitter that merely landed in the adjacent block
    (~one block duration apart) -- block adjacency alone cannot
    distinguish the two.

    ``soa_tol`` (samples) additionally requires the pair's SoAs to
    coincide within the tolerance before the weaker is dropped.  A
    straddling ghost is the SAME signal, so its SoA matches the true
    detection within about a code length even when it won on the wrong
    code; pass roughly the template length to restrict removal to such
    pairs.  Default None preserves the reference semantics (its own
    code carries the matching TODO, thrifty/identify.py:141).
    """
    if ignore_txid:
        keys = ["rxid", "block", "timestamp"]
    else:
        keys = ["rxid", "txid", "block", "timestamp"]
    # lexsort on the columns sorts by the same key tuple as the
    # previous structured-array argsort, without materializing a
    # packed copy (~5x faster at serve window sizes; keys reversed:
    # lexsort's primary key is LAST).  Rows tying on ALL keys (exact
    # duplicate records) may order differently than the reference's
    # unstable quicksort (thrifty/identify.py:148) -- both are
    # unspecified there; lexsort is at least stable/deterministic.
    order = np.lexsort(tuple(detections[k] for k in reversed(keys)))
    cur = detections[order]
    prev = np.roll(cur, 1)
    nxt = np.roll(cur, -1)

    same_prev = cur["rxid"] == prev["rxid"]
    same_next = cur["rxid"] == nxt["rxid"]
    if not ignore_txid:
        same_prev &= cur["txid"] == prev["txid"]
        same_next &= cur["txid"] == nxt["txid"]
    dup_prev = same_prev & (cur["block"] == prev["block"] + 1) \
        & (cur["energy"] < prev["energy"])
    dup_next = same_next & (cur["block"] == nxt["block"] - 1) \
        & (cur["energy"] < nxt["energy"])
    if soa_tol is not None:
        dup_prev &= np.abs(cur["soa"] - prev["soa"]) <= soa_tol
        dup_next &= np.abs(cur["soa"] - nxt["soa"]) <= soa_tol
    unidentified = cur["txid"] == UNIDENTIFIED
    keep_sorted = ~(dup_prev | dup_next | unidentified)

    keep = np.empty(len(detections), dtype=bool)
    keep[order] = keep_sorted
    return keep


def integrate(detections, freqmap=None, keep_txid=False,
              dedup_any_tx=False, warned=None, dedup_soa_tol=None):
    """Identify transmitters, drop duplicates, sort by timestamp.

    ``keep_txid`` skips classification (txids already assigned, e.g. by
    a template bank); ``dedup_any_tx`` widens duplicate removal across
    transmitter IDs and ``dedup_soa_tol`` restricts it to
    SoA-coincident pairs (see :func:`duplicate_mask`); ``warned``
    threads a caller-owned warn-once set to :func:`classify_by_freqmap`.
    """
    if not keep_txid:
        identify_transmitters(detections, freqmap, warned=warned)
    filtered = detections[duplicate_mask(detections,
                                         ignore_txid=dedup_any_tx,
                                         soa_tol=dedup_soa_tol)]
    return filtered[np.argsort(filtered["timestamp"], kind="stable")]


def load_freqmap(stream):
    """Parse a freq-map config: ``txid: start - stop`` + ``@rxid: offset``."""
    if stream is None:
        return None
    strings = parse_kv_config(stream)
    tx_ranges, rx_offsets = {}, {}
    for key, value in strings.items():
        if key.startswith("@"):
            rx_offsets[int(key[1:])] = float(value)
        else:
            start, stop = (float(x.strip()) for x in value.split("-"))
            tx_ranges[int(key)] = (start, stop)
    return {
        rxid: {
            txid: (start + off, stop + off)
            for txid, (start, stop) in tx_ranges.items()
        }
        for rxid, off in rx_offsets.items()
    }


def load_toad_globs(patterns, loader=None):
    """Expand glob patterns and load every match with ``loader``
    (default toad.load_toad); one filesystem scan, so the returned
    filenames always match the detections actually loaded."""
    if loader is None:
        loader = toad.load_toad
    filenames = []
    for pattern in patterns:
        filenames.extend(sorted(glob_mod.glob(pattern)))
    parts = [loader(f) for f in filenames]
    if not parts:
        return toad.empty(0), filenames
    return np.concatenate(parts), filenames


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("toad_file", type=str, nargs="*", default=["*.toad"],
                        help="toad file(s) from receivers [default: *.toad]")
    parser.add_argument("-o", "--output", type=str, default="data.toads",
                        help="output .toads file ('-' for stdout)")
    parser.add_argument("-m", "--map", type=argparse.FileType("r"),
                        help="frequency map config for txid assignment "
                             "[default: auto-detect]")
    parser.add_argument("--from-bank", action="store_true",
                        help="inputs are .toads files whose txids came "
                             "from a template bank (detect --emit-txid): "
                             "keep them and dedup across txids")
    parser.add_argument("--dedup-soa-tol", type=float, default=None,
                        metavar="SAMPLES",
                        help="with --from-bank: only drop a weaker "
                             "adjacent-block detection when its SoA "
                             "matches the stronger one within SAMPLES "
                             "(a straddling ghost does; a legitimate "
                             "different-tx burst usually does not) -- "
                             "use roughly the template length")
    args = parser.parse_args(argv)

    if args.from_bank:
        detections, filenames = load_toad_globs(
            args.toad_file, loader=toad.load_toads)
        filtered = integrate(detections, keep_txid=True, dedup_any_tx=True,
                             dedup_soa_tol=args.dedup_soa_tol)
    else:
        detections, filenames = load_toad_globs(args.toad_file)
        freqmap = load_freqmap(args.map)
        filtered = integrate(detections, freqmap)
    print("Removed {} duplicates / unidentified transmissions from {} "
          "detections.".format(len(detections) - len(filtered),
                               len(detections)))

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        out.write("# source_files: [{}]\n".format(" ".join(filenames)))
        toad.save(out, filtered, with_rxid=True, with_txid=True)
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    sys.exit(_main())
