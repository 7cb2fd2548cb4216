"""Match detections of the same transmission across receivers.

Greedy timestamp-window grouping (reference thrifty/matchmaker.py:17-79):
walk detections sorted by timestamp; all same-tx detections within
``window`` seconds of a seed detection form a group; per receiver the
strongest detection wins collisions; groups seen by at least
``min_match`` receivers are matches.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu_torch.io import toad


def match_detections(detections, window=0.2, min_match=2):
    """Group detections into matches.

    ``detections`` must be sorted by timestamp (integrate() output is).

    Returns
    -------
    matches : list of list of int -- detection indices per group
    misses : list of int -- seed indices that matched < min_match RXs
    collisions : list of (int, int) -- same-RX collision pairs
    """
    ts = detections["timestamp"]
    tx = detections["txid"]
    rx = detections["rxid"]
    # Non-finite energies sanitize to -inf so corrupt rows never win
    # collisions -- and so this sequential path and the batched one
    # stay output-identical on corrupt input too (NaN comparisons
    # would otherwise make the dict-overwrite incumbent arbitrary).
    energy = np.where(np.isfinite(detections["energy"]),
                      detections["energy"], -np.inf)
    n = len(detections)

    # For each i, the first index beyond its window (vectorized bound).
    window_end = np.searchsorted(ts, ts + window, side="right")

    killed = np.zeros(n, dtype=bool)
    matches, misses, collisions = [], [], []

    for i in range(n):
        if killed[i]:
            continue
        rx_best = {int(rx[i]): i}
        for j in range(i + 1, int(window_end[i])):
            if tx[j] != tx[i]:
                continue
            killed[j] = True
            rxj = int(rx[j])
            prev = rx_best.get(rxj)
            if prev is not None:
                collisions.append((prev, j))
                if energy[prev] > energy[j]:
                    continue
            rx_best[rxj] = j
        group = list(rx_best.values())
        if len(group) >= min_match:
            matches.append(group)
        else:
            misses.append(i)

    return matches, misses, collisions


def _group_seeds(ts, window):
    """Seed (group start) index for every element of one tx's sorted ts.

    The greedy scan partitions a tx's detections into intervals
    [s_k, s_{k+1}) with s_{k+1} = upper_bound(ts, ts[s_k] + window):
    every same-tx detection inside a seed's window is claimed by it, so
    the next seed is always the first index past the window.  Element
    i's seed is therefore the largest chain value <= i, computed here
    for all i at once by pointer doubling over the (vectorized)
    ``upper_bound`` jump table -- O(n log n) numpy work instead of the
    reference's O(n^2) nested scan (thrifty/matchmaker.py:30-54).
    """
    m = len(ts)
    nxt = np.searchsorted(ts, ts + window, side="right")
    # Walk the seed chain directly: O(groups) trivial steps, each a
    # Python list index -- measured ~10x cheaper on host numpy than the
    # equivalent pointer-doubling jump tables (the doubling form is what
    # this becomes if ever mapped onto an accelerator).  A window >= 0
    # always jumps past s (upper_bound includes s itself); clamping to
    # s + 1 keeps the walk terminating for window < 0 too, where the
    # sequential scan's inner range is empty and every detection seeds
    # its own group.
    nxt_l = nxt.tolist()
    seeds = []
    s = 0
    while s < m:
        seeds.append(s)
        s = max(nxt_l[s], s + 1)
    seeds = np.asarray(seeds, dtype=np.int64)
    return seeds[np.searchsorted(seeds, np.arange(m), side="right") - 1]


def _seg_running_winner(values, start_pos):
    """Per-position running winner of each segment, ties replaced.

    ``start_pos[i]`` is the first position of position i's segment
    (segments are contiguous).  Returns ``inc`` with ``inc[i]`` = the
    last position ``p <= i`` in i's segment whose value is >= every
    earlier segment value -- exactly the reference matchmaker's
    dict-overwrite incumbent after processing position i
    (thrifty/matchmaker.py:44-57: strict '>' keeps the incumbent, so a
    tie replaces it).  Exact (no key packing): a position updates the
    incumbent iff it attains the segment's running max at its own
    time, and the incumbent is the last such position, both computed
    with log-doubling segmented cumulative maxima.
    """
    n = len(values)
    pos = np.arange(n, dtype=np.int64)
    # Doubling stops once the window covers the longest segment.
    kmax = int(np.max(pos - start_pos)) + 1 if n else 1
    run_max = np.asarray(values, dtype=np.float64).copy()
    k = 1
    while k < kmax:
        valid = (pos - start_pos >= k)[k:]
        np.maximum(run_max[k:], np.where(valid, run_max[:-k],
                                         -np.inf), out=run_max[k:])
        k *= 2
    # Positions that attained their own running max (== update events).
    inc = np.where(values == run_max, pos, np.int64(-1))
    k = 1
    while k < kmax:
        valid = (pos - start_pos >= k)[k:]
        np.maximum(inc[k:], np.where(valid, inc[:-k],
                                     np.int64(-1)), out=inc[k:])
        k *= 2
    return inc


def match_detections_arrays(detections, window=0.2):
    """Array-native core of the batched matchmaker.

    Groups every tx's detections in O(n log n) vectorized numpy (seed
    chain from one ``searchsorted`` jump table, per-(group, rx) winners
    from a composite-key stable argsort plus two segmented reduceats)
    rather than the reference's per-seed inner scan.  Collision pairs
    -- several detections of one tx on one rx inside one window -- are
    also emitted fully vectorized: the reference's running-best
    incumbent chain (thrifty/matchmaker.py:44-52) is a segmented
    running-argmax with ties replacing (:func:`_seg_running_winner`),
    so even pathological self-colliding traffic costs no per-pair
    Python work.

    Returns a dict of numpy arrays; groups ordered by seed index (the
    reference's scan order), members by first appearance of their rx:

    - ``winners``: (sum counts,) detection index of each group member
    - ``offsets``: (G + 1,) group g's members are
      ``winners[offsets[g]:offsets[g + 1]]``
    - ``seeds``: (G,) seed detection index per group
    - ``collisions``: (C, 2) (incumbent, challenger) pairs in scan order

    This is the serving-scale formulation: no per-detection or per-group
    Python work, so fleets can feed millions of detections per second
    without the list-of-lists materialization cost (which is what
    actually bounds :func:`match_detections` -- see
    docs/performance.md).
    """
    ts = np.asarray(detections["timestamp"], dtype=np.float64)
    tx = np.asarray(detections["txid"])
    rx = np.asarray(detections["rxid"])
    energy = np.asarray(detections["energy"], dtype=np.float64)
    # Corrupt .toads rows can carry non-finite energies; NaN poisons
    # reduceat's running max (every == comparison False -> the winner
    # index degenerates to the last element of the whole tx array, a
    # detection from an unrelated group).  Both paths sanitize to
    # -inf: a non-finite energy never wins a collision (see
    # match_detections, which applies the same rule).
    energy = np.where(np.isfinite(energy), energy, -np.inf)
    n = len(ts)
    if n == 0:
        return dict(winners=np.empty(0, np.int64),
                    offsets=np.zeros(1, np.int64),
                    seeds=np.empty(0, np.int64),
                    collisions=np.empty((0, 2), np.int64))

    collisions = []  # per-tx (seed, incumbent, challenger) array triples
    tx_seed, tx_off, tx_cnt, tx_flat = [], [], [], []
    base = 0         # offset of this tx's winners in the flat array

    for txid in np.unique(tx):
        idx = np.flatnonzero(tx == txid)
        t = ts[idx]
        seed = _group_seeds(t, window)          # local seed per element
        rxl = rx[idx]
        e_l = energy[idx]
        local = np.arange(len(idx), dtype=np.int64)

        # (group, rx) runs in scan order: one composite-key stable sort
        # (seed * R + rx; stability supplies the local-index tiebreak)
        # is ~2x cheaper than the equivalent 3-key lexsort.
        nrx_span = int(rxl.max()) + 1 if len(rxl) else 1
        if nrx_span < (1 << 62) // max(len(idx), 1):
            order = np.argsort(seed * nrx_span + rxl, kind="stable")
        else:  # absurd rxids: avoid int64 overflow in the composite key
            order = np.lexsort((local, rxl, seed))
        g_s, rx_s, loc_s = seed[order], rxl[order], local[order]
        change = (np.diff(g_s, prepend=-1) != 0) \
            | (np.diff(rx_s, prepend=-1) != 0)
        run_start = np.flatnonzero(change)
        run_end = np.append(run_start[1:], len(order))
        first = loc_s[run_start]                # first member per run
        # Winner per run = the reference's dict-overwrite survivor:
        # strict '>' keeps the incumbent, so an energy tie replaces =>
        # max by (energy, index).  Runs are index-ordered, so that is
        # the LAST position attaining the run's max energy -- two
        # reduceats, no second sort.
        e_s = e_l[loc_s]
        counts = run_end - run_start
        run_max = np.maximum.reduceat(e_s, run_start)
        at_max = np.where(e_s == np.repeat(run_max, counts),
                          np.arange(len(e_s), dtype=np.int64), -1)
        winner = loc_s[np.maximum.reduceat(at_max, run_start)]

        # Collision pairs only exist in multi-member runs (same tx,
        # same rx, one window).  Every position past its run's start
        # pairs the run's running incumbent with itself; the reference
        # emits pairs while scanning the whole group in j order (rx
        # runs interleaved), groups in seed order -- keyed here by
        # (group seed, j) and ordered once at the end.
        multi = ~change
        if multi.any():
            start_pos = np.repeat(run_start, counts)
            inc = _seg_running_winner(e_s, start_pos)
            p = np.flatnonzero(multi)
            collisions.append((idx[g_s[p]],
                               idx[loc_s[inc[p - 1]]],
                               idx[loc_s[p]]))

        # Per group: runs ordered by first appearance of the rx, which
        # is the reference's dict insertion order; the seed's run is
        # always first (its first member IS the seed).
        g_starts = g_s[run_start]
        # first-member indices are unique, so the composite key is too.
        order_g = np.argsort(g_starts * np.int64(len(idx) + 1) + first)
        g_runs = g_starts[order_g]
        grp_start = np.flatnonzero(np.diff(g_runs, prepend=-1) != 0)
        tx_flat.append(idx[winner[order_g]])
        tx_seed.append(idx[g_runs[grp_start]])
        tx_off.append(grp_start + base)
        tx_cnt.append(np.diff(np.append(grp_start, len(g_runs))))
        base += len(g_runs)

    # Merge txs: reorder groups into global seed order (the reference's
    # outer scan order) with a segmented gather -- all numpy.
    flat = np.concatenate(tx_flat)
    seed_all = np.concatenate(tx_seed)
    off_all = np.concatenate(tx_off)
    cnt_all = np.concatenate(tx_cnt)
    order = np.argsort(seed_all, kind="stable")
    cnt_o = cnt_all[order]
    offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(cnt_o, out=offsets[1:])
    # gather index = source offset of each group + position within it
    gather = np.repeat(off_all[order] - offsets[:-1], cnt_o) \
        + np.arange(offsets[-1], dtype=np.int64)
    if collisions:
        seed_c = np.concatenate([c[0] for c in collisions])
        inc_c = np.concatenate([c[1] for c in collisions])
        j_c = np.concatenate([c[2] for c in collisions])
        order_c = np.lexsort((j_c, seed_c))
        coll = np.stack([inc_c[order_c], j_c[order_c]], axis=1)
    else:
        coll = np.empty((0, 2), np.int64)
    return dict(winners=flat[gather], offsets=offsets,
                seeds=seed_all[order], collisions=coll)


def match_detections_batched(detections, window=0.2, min_match=2):
    """Vectorized :func:`match_detections`; identical output.

    Thin list-of-lists adapter over :func:`match_detections_arrays`
    (which see): the list materialization here is O(groups) Python and
    is the dominant cost at serving scale -- consume the array form
    directly when feeding a batched downstream.
    """
    arr = match_detections_arrays(detections, window)
    flat = arr["winners"].tolist()
    off = arr["offsets"].tolist()
    seeds = arr["seeds"].tolist()
    matches, misses = [], []
    for g, s in enumerate(seeds):
        a, b = off[g], off[g + 1]
        if b - a >= min_match:
            matches.append(flat[a:b])
        else:
            misses.append(s)
    # zip over the .tolist() columns: tuple(ndarray_row) per pair is
    # ~50x slower when collision traffic is heavy.
    coll = arr["collisions"]
    return matches, misses, list(zip(coll[:, 0].tolist(),
                                     coll[:, 1].tolist()))


def save_matches(stream_or_path, matches):
    """Write a .match file: one line of detection indices per group."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save_matches(f, matches)
    for match in matches:
        stream_or_path.write(" ".join(str(int(m)) for m in match) + "\n")


def load_matches(stream_or_path):
    """Read a .match file."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return load_matches(f)
    matches = []
    for line in stream_or_path:
        if not line.strip() or line[0] == "#":
            continue
        matches.append([int(x) for x in line.split()])
    return matches


def match_matrix(detections, matches, rxids, txids=None):
    """Rows of per-RX detection indices for matches covering all rxids."""
    matrix = []
    for match in matches:
        match_rx = [int(detections[m]["rxid"]) for m in match]
        if txids is not None and \
                int(detections[match[0]]["txid"]) not in txids:
            continue
        if any(r not in match_rx for r in rxids):
            continue
        matrix.append([match[match_rx.index(r)] for r in rxids])
    return matrix


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", nargs="?", type=str, default="data.toads",
                        help=".toads data ('-' streams from stdin)")
    parser.add_argument("-o", "--output", type=str, default="data.match",
                        help="output .match file ('-' for stdout)")
    parser.add_argument("-w", "--window", type=float, default=0.2,
                        help="timestamp window in seconds [default: 0.2]")
    parser.add_argument("-n", "--num-matches", type=int, default=2,
                        help="min receivers for a valid match [default: 2]")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="print a line per collision (reference "
                             "matchmaker.py:146-150)")
    args = parser.parse_args(argv)

    stream = sys.stdin if args.input == "-" else args.input
    detections = toad.load_toads(stream)
    order = np.argsort(detections["timestamp"], kind="stable")
    detections = detections[order]
    matches, misses, collisions = match_detections_batched(
        detections, args.window, args.num_matches)
    if args.verbose:
        for i1, i2 in collisions:
            print("Multiple detections for RX %d and TX %d: "
                  "detection #%d and #%d collides." %
                  (int(detections[i1]["rxid"]), int(detections[i1]["txid"]),
                   int(order[i1]), int(order[i2])))
    # Indices must refer to the file's line order, not the sorted order.
    matches = [[int(order[m]) for m in match] for match in matches]

    print("Number of matches:", len(matches))
    print("Number of misses:", len(misses))
    print("Number of collisions:", len(collisions))

    if args.output == "-":
        save_matches(sys.stdout, matches)
    else:
        save_matches(args.output, matches)


if __name__ == "__main__":
    sys.exit(_main())
