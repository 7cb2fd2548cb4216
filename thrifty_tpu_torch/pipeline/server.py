"""Incremental positioning server: live detections -> live position fixes.

The reference pipeline is batch-only (files in, files out).  For
production serving, this module processes detections *incrementally*:
feed it detection records as receivers produce them (tailing .toad
files, a socket, or in-process), and it periodically re-runs
identify -> match -> tdoa -> pos over a sliding time window, emitting
only fixes for newly completed match groups.

The CLI tails per-receiver .toad files (the natural transport -- the
reference ships the same files by scp/NFS) and appends fixes to a .pos
file as they resolve.

The port's counterpart of ``thrifty_tpu.pipeline.server``: the same
server on the port's numpy stages, with the batched solver
(``pos.solve_batched``) on ``device`` -- the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import argparse
import functools
import io
import sys
import time as time_mod

import numpy as np

from thrifty_tpu_torch.device import DEVICES, as_device
from thrifty_tpu_torch.io import toad
from thrifty_tpu_torch.pipeline import identify as identify_mod
from thrifty_tpu_torch.pipeline import matchmaker as matchmaker_mod
from thrifty_tpu_torch.pipeline import pos as pos_mod
from thrifty_tpu_torch.pipeline import tdoa as tdoa_mod


class PositioningServer:
    """Sliding-window incremental positioning.

    Parameters mirror kitchen_sink.PostdetectSettings; additionally:

    window_s : float
        Sliding history length.  Must comfortably exceed the TDOA
        beacon window so clock models stay well-conditioned.
    settle_s : float
        A match group is only solved once it is at least this old
        (receivers may still deliver detections for it).

    step() must be called at intervals shorter than
    ``window_s - settle_s``: a settle-deferred group needs at least one
    later step before it scrolls out of the sliding window.

    future_tol_s : float
        feed() rejects detections stamped more than this far ahead of
        the server's own clock.  Receivers are NTP-disciplined to the
        same timebase (the reference's matching precondition,
        rpi/detect.sh:17-18), so a far-future timestamp is a clock
        glitch or a corrupt line -- and because step() derives "now"
        from the max timestamp, one such record would otherwise trim
        every legitimate detection out of the sliding window forever.
        Historical replays (timestamps in the past) are unaffected.
    clock : callable
        Time source for the future check (default time.time);
        injectable for tests.
    incremental : bool
        Maintain identify/match results incrementally (default; auto-
        disabled when txids come from the auto histogram, whose global
        statistics are not decomposable).  The greedy matcher is a
        per-transmitter forward scan in which every detection within
        ``match_window`` of a seed is consumed, so groups whose seed
        lies more than ``freeze_lag_s`` behind the newest data are
        FINAL: they are frozen (integrated rows + membership cached)
        and each step re-runs identify/match only over the active
        tail, with a context margin below the per-tx consumption
        horizon so duplicate-removal decisions at the boundary stay
        identical to a full rescan.  A late detection older than any
        horizon (+slack) triggers a full exact recompute.

        Output equality with the non-incremental path is exact for
        every group whose detections lie fully inside the sliding
        window -- in steady operation, all reported fixes.  The one
        intentional divergence is at the window's TRIM edge (age
        ``window_s``): the rescan path re-matches a partially trimmed
        group from its surviving rows, while the incremental path
        keeps the frozen group whole until its span leaves the window
        -- strictly more data for a clock model that old.  This can
        only influence a fix when a still-unsolved mobile group is
        being retried within ``tdoa_est_window`` of the trim edge.
    freeze_lag_s : float
        How far behind the newest data a group's seed must lie before
        it freezes.  Must exceed ``ctx_slack_s``; larger values
        tolerate more receiver lag without unfreezing.
    ctx_slack_s : float
        Safety margin covering duplicate-removal reach (one block
        duration, ~5 ms at reference rates) and timestamp jitter.
    device : str or torch.device
        Where the batched solver runs (``"cuda"`` by default; raises in
        the constructor when no card is available).  Unused by
        ``solver="scipy"``, the host solver.
    """

    def __init__(self, rx_pos, beacon_pos, freqmap=None,
                 sample_rate=2.4e6, match_window=0.2,
                 tdoa_est_window=8.0, window_s=30.0, settle_s=1.0,
                 keep_txid=False, solver="auto", future_tol_s=300.0,
                 clock=None, incremental=True, freeze_lag_s=None,
                 ctx_slack_s=0.5, device="cuda"):
        self.rx_pos = rx_pos
        self.beacon_pos = beacon_pos
        self.freqmap = freqmap
        self.sample_rate = sample_rate
        self.match_window = match_window
        self.tdoa_est_window = tdoa_est_window
        self.window_s = window_s
        self.settle_s = settle_s
        self.keep_txid = keep_txid
        # 'scipy' solves each group with the trust-region solver;
        # 'batched' (and 'auto', its alias since the multi-start
        # upgrade) uses the batched multi-start Gauss-Newton program:
        # one dispatch per step regardless of load, and robust to the
        # mirror basins of near-collinear arrays that trap any
        # single-start solver (docs/design.md).
        if solver not in ("auto", "scipy", "batched"):
            raise ValueError("unknown solver: " + solver)
        self.solver = solver
        self.device = None if solver == "scipy" else as_device(device)
        self.future_tol_s = future_tol_s
        self._clock = clock if clock is not None else time_mod.time
        self._rx_ids = np.array(sorted(rx_pos), dtype=np.int64)
        self._beacon_ids = np.array(sorted(beacon_pos), dtype=np.int64)
        # Warn-once set for unmapped receivers (step() runs every poll).
        self._warned_rx = set()
        # Warn-once sets for feed()-time rejections.
        self._warned_unknown_rx = set()
        self._warned_future_rx = set()
        self._detections = toad.empty(0)
        # Solved transmissions per txid as sorted timestamp lists: a
        # group is a duplicate iff a solved fix for its transmitter lies
        # within match_window (exact, no quantization-boundary artifacts
        # and no suppression of distinct transmissions).
        self._solved = {}  # txid -> sorted [timestamps]

        # Incremental identify/match state (see class docstring).
        # Auto-classification derives txids from GLOBAL per-rx carrier
        # histograms over the window -- not decomposable -- so the
        # incremental path requires explicit txids (freqmap or
        # keep_txid).
        self.incremental = bool(incremental) and (
            freqmap is not None or keep_txid)
        if freeze_lag_s is None:
            freeze_lag_s = max(2.0, 4.0 * match_window + 2.0 * ctx_slack_s)
        if freeze_lag_s <= ctx_slack_s + match_window:
            raise ValueError("freeze_lag_s must exceed "
                             "ctx_slack_s + match_window")
        self.freeze_lag_s = float(freeze_lag_s)
        self.ctx_slack_s = float(ctx_slack_s)
        self._pending_min = np.inf  # min ts fed since the last step
        self._reset_frozen()

    def _reset_frozen(self):
        self._frz_rows = toad.empty(0)    # integrated rows, group-major
        self._frz_off = np.zeros(1, np.int64)   # group g = rows[off[g]:off[g+1]]
        self._frz_seed_ts = np.empty(0, np.float64)
        self._frz_seed_tx = np.empty(0, np.int64)
        self._frz_horizon = {}  # txid -> consumption horizon (seed+window)
        self._frz_guard = -np.inf  # max horizon; older arrivals unfreeze

    def feed(self, detections):
        """Add new detection records (any order, any receiver).

        Records from receivers absent from the coordinate config are
        dropped (they can never contribute to a clock model or a TDOA
        pair, and would crash the geometry lookups downstream), as are
        far-future timestamps (see ``future_tol_s``); both warn once
        per receiver.
        """
        if not len(detections):
            return

        def drop(keep, warned, message):
            for r in set(int(r) for r in detections["rxid"][~keep]):
                if r not in warned:
                    warned.add(r)
                    print("warning: dropping detection(s) from rx {} "
                          "{}".format(r, message), file=sys.stderr)
            return detections[keep]

        known = np.isin(detections["rxid"], self._rx_ids)
        if not known.all():
            detections = drop(known, self._warned_unknown_rx,
                              "(not in receiver coordinate config)")
        sane = detections["timestamp"] \
            <= self._clock() + self.future_tol_s
        if not sane.all():
            detections = drop(sane, self._warned_future_rx,
                              "stamped >{:.0f}s in the future (clock "
                              "glitch or corrupt line?)".format(
                                  self.future_tol_s))
        if len(detections):
            self._pending_min = min(
                self._pending_min, float(np.min(detections["timestamp"])))
            if self.incremental and not self.keep_txid:
                # Classification is pointwise (freqmap lookup), so do
                # it ONCE per record at feed time instead of over the
                # whole window every step; on a private copy so the
                # caller's records are untouched.
                detections = detections.copy()
                identify_mod.identify_transmitters(
                    detections, self.freqmap, warned=self._warned_rx)
            self._detections = np.concatenate(
                [self._detections, detections])

    def _is_solved(self, timestamp, tx):
        times = self._solved.get(int(tx))
        if not times:
            return False
        import bisect
        i = bisect.bisect_left(times, timestamp - self.match_window)
        return i < len(times) and \
            times[i] <= timestamp + self.match_window

    def _mark_solved(self, timestamp, tx):
        import bisect
        times = self._solved.setdefault(int(tx), [])
        bisect.insort(times, float(timestamp))

    def _select_work(self, seed_ts, seed_tx, cnt, now):
        """Vectorized group selection: beacon groups always flow to the
        clock models; mobile groups only when settled and not yet
        reported.  A late detection can move a group's seed timestamp
        by up to match_window, so the duplicate check is a
        +-match_window interval, not a key.  Filtering BEFORE
        estimation keeps the per-step cost proportional to new
        traffic, not window size (the earlier per-group Python loop
        was a measured hot spot at 50x density)."""
        enough = cnt >= 2  # the matcher's min_match
        is_beacon = np.isin(seed_tx, self._beacon_ids)
        unsolved = np.ones(len(seed_ts), dtype=bool)
        mobile = enough & ~is_beacon
        for t in np.unique(seed_tx[mobile]):
            times = self._solved.get(int(t))
            if not times:
                continue
            sel = mobile & (seed_tx == t)
            tsv = seed_ts[sel]
            tarr = np.asarray(times)
            i = np.searchsorted(tarr, tsv - self.match_window)
            hit = (i < len(tarr)) & (
                tarr[np.minimum(i, len(tarr) - 1)]
                <= tsv + self.match_window)
            unsolved[sel] = ~hit
        settled = seed_ts <= now - self.settle_s
        return (enough & is_beacon) | (mobile & settled & unsolved)

    def _compact_frozen(self, alive):
        sizes = np.diff(self._frz_off)
        row_mask = np.repeat(alive, sizes)
        self._frz_rows = self._frz_rows[row_mask]
        self._frz_off = np.concatenate(
            [[0], np.cumsum(sizes[alive])]).astype(np.int64)
        self._frz_seed_ts = self._frz_seed_ts[alive]
        self._frz_seed_tx = self._frz_seed_tx[alive]
        # Consumption horizons only ever grow; trimming a group does
        # not re-open its region (its raw rows age out of the window).

    def _integrate_active(self, now):
        """Identify + dedup + match over the ACTIVE tail only.

        Returns (detections_all, work lists) exactly equal to what a
        full-window rescan would select, by the matcher's per-tx
        prefix property: every detection within match_window of a seed
        is consumed, so groups seeded before the frozen horizons can
        never change, and the active tail (ts strictly above each tx's
        horizon) re-runs through the same code with a dedup context
        margin below the cut.
        """
        # txids were assigned at feed time (pointwise, so once per
        # record); everything below is read-only on the window buffer.
        dets = self._detections
        tsd = dets["timestamp"]
        h = np.full(len(dets), -np.inf)
        for t, ht in self._frz_horizon.items():
            h[dets["txid"] == t] = ht
        active = tsd > h
        if self.keep_txid and self._frz_horizon:
            # Cross-tx dedup (dedup_any_tx): an active row's duplicate
            # partner can be a consumed row of ANOTHER tx, so the
            # context margin must sit below the GLOBAL minimum horizon,
            # not the row's own tx's.
            min_h = min(self._frz_horizon.values())
            keep_sub = active | (tsd > min_h - self.ctx_slack_s)
        else:
            keep_sub = active | (tsd > h - self.ctx_slack_s)
        sub = dets[keep_sub]
        sub_active = active[keep_sub]
        # Same dedup decision as a full rescan: every possible
        # adjacent-block partner of an active row is present (active
        # rows, or consumed rows within the context margin); context
        # rows' own verdicts are discarded (they are frozen).
        dedup = identify_mod.duplicate_mask(
            sub, ignore_txid=self.keep_txid)
        act = sub[dedup & sub_active]
        act = act[np.argsort(act["timestamp"], kind="stable")]

        arr = matchmaker_mod.match_detections_arrays(
            act, self.match_window)
        a_seeds, a_off = arr["seeds"], arr["offsets"]
        a_flat = arr["winners"]
        a_cnt = np.diff(a_off)
        a_seed_ts = act["timestamp"][a_seeds].astype(np.float64)
        a_seed_tx = act["txid"][a_seeds].astype(np.int64)

        nf = len(self._frz_seed_ts)
        base = len(self._frz_rows)
        seed_ts = np.concatenate([self._frz_seed_ts, a_seed_ts])
        seed_tx = np.concatenate([self._frz_seed_tx, a_seed_tx])
        cnt = np.concatenate([np.diff(self._frz_off), a_cnt])
        detections_all = np.concatenate([self._frz_rows, act])

        work = []
        for g in np.nonzero(self._select_work(seed_ts, seed_tx, cnt,
                                              self._now))[0]:
            if g < nf:
                work.append(np.arange(self._frz_off[g],
                                      self._frz_off[g + 1]))
            else:
                ga = g - nf
                work.append(a_flat[a_off[ga]:a_off[ga + 1]] + base)

        # Advance the freeze: groups seeded more than freeze_lag_s ago
        # are final (per-tx prefix; misses advance the horizon but
        # store no rows -- they can never be reported).
        frz = a_seed_ts < self._now - self.freeze_lag_s
        if frz.any():
            new_rows, new_sizes = [], []
            for g in np.nonzero(frz)[0]:
                # The horizon is the matcher's own upper bound
                # (ts[seed] + window, float64) so "consumed" stays
                # bitwise consistent with searchsorted side='right'.
                t = int(a_seed_tx[g])
                self._frz_horizon[t] = max(
                    self._frz_horizon.get(t, -np.inf),
                    a_seed_ts[g] + self.match_window)
                if a_cnt[g] >= 2:
                    new_rows.append(act[a_flat[a_off[g]:a_off[g + 1]]])
                    new_sizes.append(a_cnt[g])
            self._frz_guard = max(self._frz_horizon.values())
            self._frz_seed_ts = np.concatenate(
                [self._frz_seed_ts, a_seed_ts[frz & (a_cnt >= 2)]])
            self._frz_seed_tx = np.concatenate(
                [self._frz_seed_tx, a_seed_tx[frz & (a_cnt >= 2)]])
            if new_rows:
                self._frz_rows = np.concatenate(
                    [self._frz_rows] + new_rows)
                self._frz_off = np.concatenate(
                    [self._frz_off,
                     self._frz_off[-1] + np.cumsum(new_sizes)])
        return detections_all, work

    def step(self, now=None):
        """Process the current window; return newly solved fixes."""
        if len(self._detections) == 0:
            return pos_mod.solve([], self.rx_pos)
        if now is None:
            now = float(np.max(self._detections["timestamp"]))
        self._now = now

        # Trim the sliding window.
        keep = self._detections["timestamp"] >= now - self.window_s
        self._detections = self._detections[keep]

        if self.incremental:
            if self._pending_min - self.ctx_slack_s <= self._frz_guard:
                # A late detection arrived at or below a consumption
                # horizon: frozen results could be stale.  Recompute
                # the whole window exactly (rare; receivers lagging
                # more than freeze_lag_s behind the newest data).
                self._reset_frozen()
            self._pending_min = np.inf
            cut = now - self.window_s
            alive = self._frz_seed_ts + self.match_window >= cut
            if not alive.all():
                self._compact_frozen(alive)
            detections_all, work = self._integrate_active(now)
        else:
            self._pending_min = np.inf
            dets = self._detections.copy()
            integrated = identify_mod.integrate(
                dets, self.freqmap, keep_txid=self.keep_txid,
                dedup_any_tx=self.keep_txid, warned=self._warned_rx)
            arr = matchmaker_mod.match_detections_arrays(
                integrated, self.match_window)
            seeds, off, flat = (arr["seeds"], arr["offsets"],
                                arr["winners"])
            cnt = np.diff(off)
            work_mask = self._select_work(
                integrated["timestamp"][seeds].astype(np.float64),
                integrated["txid"][seeds].astype(np.int64), cnt, now)
            work = [flat[off[g]:off[g + 1]]
                    for g in np.nonzero(work_mask)[0]]
            detections_all = integrated
        fresh, _ = tdoa_mod.estimate_tdoas(
            detections_all, work, self.tdoa_est_window,
            self.beacon_pos, self.rx_pos, self.sample_rate)

        # verbose=False: an underdetermined group here is a normal
        # transient (a lagging receiver may still complete it); it is
        # retried every step and would re-print the same line ~30
        # times per group at production poll rates.
        use_batched = self.solver != "scipy"
        if use_batched:
            results = pos_mod.solve_batched(fresh, self.rx_pos,
                                            verbose=False,
                                            device=self.device)
        else:
            results = pos_mod.solve(fresh, self.rx_pos, verbose=False)
        # Mark solved only what actually produced a fix: a group that
        # failed (e.g. underdetermined until a lagging receiver's
        # detections arrive) is retried on later steps.
        solved_ids = set(int(i) for i in results["group_id"]) \
            if len(results) else set()
        for g in fresh:
            if g.group_id in solved_ids:
                self._mark_solved(g.timestamp, g.tx)
        # Prune entries that scrolled out of the sliding window (a
        # long-running server would otherwise leak them forever).
        horizon = now - self.window_s - 10 * self.match_window
        self._solved = {
            tx: [t for t in times if t >= horizon]
            for tx, times in self._solved.items()
        }
        return results


class ToadTailer:
    """Incrementally read appended lines from per-receiver .toad files.

    Only complete lines are consumed: a partially written trailing line
    (writers are not line-atomic) stays for the next poll.
    """

    def __init__(self, paths):
        self._paths = list(paths)
        self._offsets = {p: 0 for p in self._paths}
        self._inodes = {}

    def poll(self):
        import os

        parts = []
        for path in self._paths:
            try:
                with open(path, "rb") as f:
                    st = os.fstat(f.fileno())
                    if (st.st_ino != self._inodes.get(path, st.st_ino)
                            or st.st_size < self._offsets[path]):
                        # Truncated or rotated (new inode, or shrunk):
                        # start over from the top of the new file.
                        self._offsets[path] = 0
                    self._inodes[path] = st.st_ino
                    f.seek(self._offsets[path])
                    data = f.read()
            except FileNotFoundError:
                continue
            # Consume up to (and including) the last newline only.
            cut = data.rfind(b"\n") + 1
            if cut == 0:
                continue
            self._offsets[path] += cut
            text = data[:cut].decode("ascii", errors="replace")
            parts.append(toad.load_toad(io.StringIO(text)))
        if not parts:
            return toad.empty(0)
        return np.concatenate(parts)


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("toad_files", nargs="+",
                        help="per-receiver .toad files to tail")
    parser.add_argument("-o", "--output", type=str, default="live.pos")
    parser.add_argument("-r", "--rx-coordinates", dest="rx_pos",
                        type=str, default="pos-rx.cfg")
    parser.add_argument("-b", "--beacon-coordinates", dest="beacon_pos",
                        type=str, default="pos-beacon.cfg")
    parser.add_argument("-m", "--map", type=argparse.FileType("r"),
                        default=None, help="frequency map for txids")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="poll interval in seconds")
    parser.add_argument("--match-window", type=float, default=0.2)
    parser.add_argument("--tdoa-window", type=float, default=8.0)
    parser.add_argument("--history", type=float, default=30.0,
                        help="sliding window length (s)")
    parser.add_argument("--once", action="store_true",
                        help="process what is on disk and exit "
                             "(for testing/batch use)")
    parser.add_argument("--track", type=str, default=None, metavar="FILE",
                        help="also Kalman-track fixes into FILE")
    parser.add_argument("--solver", type=str, default="auto",
                        choices=["auto", "scipy", "batched"],
                        help="position solver: the batched multi-start "
                             "Gauss-Newton program by default ('auto' "
                             "== 'batched'); 'scipy' forces the "
                             "per-group trust-region solver "
                             "[default: auto]")
    parser.add_argument("--no-incremental", action="store_true",
                        help="disable the frozen-prefix incremental "
                             "window (full identify/match rescan per "
                             "step; outputs are identical except for "
                             "groups straddling the window trim edge "
                             "-- see PositioningServer docs)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES),
                        help="where the batched solver runs; 'cuda' fails "
                             "when no card is available [default: cuda]")
    args = parser.parse_args(argv)

    if args.interval >= args.history - 1.0:
        parser.error(
            "--interval must be well below --history (a settle-deferred "
            "group needs a later poll before it leaves the window)")

    server = PositioningServer(
        rx_pos=tdoa_mod.load_pos_config(args.rx_pos),
        beacon_pos=tdoa_mod.load_pos_config(args.beacon_pos),
        freqmap=identify_mod.load_freqmap(args.map),
        match_window=args.match_window,
        tdoa_est_window=args.tdoa_window,
        window_s=args.history,
        settle_s=0.0 if args.once else 1.0,
        solver=args.solver,
        incremental=not args.no_incremental,
        device=args.device)
    tailer = ToadTailer(args.toad_files)

    trackers = {}
    track_out = open(args.track, "a") if args.track else None
    out = open(args.output, "a")
    try:
        while True:
            server.feed(tailer.poll())
            fixes = server.step()
            if len(fixes):
                pos_mod.save_positions(out, fixes)
                out.flush()
                for row in fixes:
                    print("fix: t={:.3f} tx={} pos=({:.1f}, {:.1f}) "
                          "dop={:.2f}".format(
                              row["timestamp"], row["tx"], row["x"],
                              row["y"], row["dop"]), file=sys.stderr)
                if track_out is not None:
                    from thrifty_tpu_torch.pipeline import track as track_mod
                    for line in track_mod.live_update(trackers, fixes):
                        track_out.write(line + "\n")
                    track_out.flush()
            if args.once:
                break
            time_mod.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        out.close()
        if track_out is not None:
            track_out.close()


if __name__ == "__main__":
    sys.exit(_main())
