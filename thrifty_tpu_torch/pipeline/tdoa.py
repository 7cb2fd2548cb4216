"""TDOA estimation with beacon-based clock synchronisation.

Receivers have free-running sample clocks; beacon transmitters at known
positions provide the synchronisation reference.  For each receiver pair
a polynomial model mapping one receiver's sample counter onto the
other's is fitted through the beacon detections (their expected SDOA is
known from geometry), and mobile-unit TDOAs are read off the model
(reference thrifty/tdoa_est.py:43-105,234-303).

The numerically critical per-pair model fit stays in float64 numpy on
host: groups are small and irregular (SURVEY.md section 7 "hard parts"),
while polyfits across many (group, pair) combinations are batched where
possible.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import itertools
import sys

import numpy as np

from thrifty_tpu_torch import stats
from thrifty_tpu_torch.config.settings import parse_kv_config
from thrifty_tpu_torch.io import toad
from thrifty_tpu_torch.pipeline import matchmaker

SPEED_OF_LIGHT = 2.997e8
MAX_TDOA = 30e3 / SPEED_OF_LIGHT  # reject TDOAs implying > 30 km

TDOA_DTYPE = np.dtype([
    ("rx0", "i4"), ("rx1", "i4"), ("tdoa", "f8"), ("snr", "f8"),
    ("model_quality", "f8"), ("det0_idx", "i4"), ("det1_idx", "i4"),
])

TdoaGroup = collections.namedtuple(
    "TdoaGroup", ["group_id", "timestamp", "tx", "tdoas"])


def _dist(a, b):
    return float(np.sqrt(np.sum((np.asarray(a, dtype=np.float64)
                                 - np.asarray(b, dtype=np.float64)) ** 2)))


class BeaconPairs:
    """Per receiver-pair sorted beacon detection pairs with windowed lookup."""

    def __init__(self, detections, beacon_matches):
        pairs = collections.defaultdict(list)
        for group in beacon_matches:
            for i0, i1 in itertools.combinations(group, 2):
                d0, d1 = detections[i0], detections[i1]
                if d0["rxid"] > d1["rxid"]:
                    d0, d1 = d1, d0
                if not np.isfinite(float(d0["soa"]) - float(d1["soa"])):
                    # Corrupt record (NaN/inf SoA): drop the pair so
                    # one bad row cannot poison every window it falls
                    # in -- the same up-front filter as the batched
                    # path's finite mask (MAD cannot reject NaNs, and
                    # a NaN reaching polyfit NaNs the whole fit).
                    continue
                pairs[(int(d0["rxid"]), int(d1["rxid"]))].append((d0, d1))
        self._pairs = {}
        self._times = {}
        self._window_cache = {}
        for key, plist in pairs.items():
            plist.sort(key=lambda p: p[0]["timestamp"])
            self._pairs[key] = plist
            self._times[key] = [float(p[0]["timestamp"]) for p in plist]

    def extract(self, rx0, rx1, t_start, t_stop):
        """Beacon pairs in [t_start, t_stop], MAD outliers removed.

        Returns ``(pairs, window_key)``; the key identifies the exact
        beacon slice, so clock models fitted on it can be reused across
        mobile groups that see the same window.
        """
        key = (rx0, rx1)
        if key not in self._pairs:
            return [], None
        times = self._times[key]
        left = bisect.bisect_left(times, t_start)
        right = bisect.bisect_right(times, t_stop)
        window_key = (rx0, rx1, left, right)
        cached = self._window_cache.get(window_key)
        if cached is not None:
            return cached, window_key
        selected = self._pairs[key][left:right]
        if len(selected) > 1:
            sdoa = np.array([p[0]["soa"] - p[1]["soa"] for p in selected])
            keep = ~stats.is_outlier(sdoa)
            selected = [p for p, k in zip(selected, keep) if k]
        self._window_cache[window_key] = selected
        return selected, window_key


def build_model_poly(pairs, beacon_sdoa, sample_rate, deg=2):
    """Default clock model: deg-2 polyfit soa1+sdoa -> soa0.

    Returns evaluate(det0, det1) -> tdoa seconds, or None when there are
    not enough beacon transmissions to constrain the fit.
    """
    if len(pairs) < deg + 1:
        return None
    soa0 = np.array([p[0]["soa"] for p in pairs])
    soa1 = np.array([p[1]["soa"] for p in pairs])
    coef = np.polyfit(soa1 + np.asarray(beacon_sdoa), soa0, deg)
    fit = np.poly1d(coef)

    def evaluate(det0, det1):
        return (det0["soa"] - fit(det1["soa"])) / sample_rate

    return evaluate


def build_model_weighted_poly(pairs, beacon_sdoa, sample_rate, deg=2):
    """Polyfit weighted by proximity to the mobile detection."""
    if len(pairs) < deg + 1:
        return None
    soa0 = np.array([p[0]["soa"] for p in pairs])
    soa1 = np.array([p[1]["soa"] for p in pairs])
    soa1at0 = soa1 + np.asarray(beacon_sdoa)

    def evaluate(det0, det1):
        with np.errstate(divide="ignore"):
            weights = np.sqrt(1.0 / np.abs(soa0 - det0["soa"]))
        weights = np.where(np.isfinite(weights), weights, 1.0)
        weights = np.sqrt(weights / np.max(weights))
        weights = (weights + 2) / 3
        coef = np.polyfit(soa1at0, soa0, deg, w=weights)
        return (det0["soa"] - np.poly1d(coef)(det1["soa"])) / sample_rate

    return evaluate


def build_model_nearest(pairs, beacon_sdoa, sample_rate):
    """Difference against the single nearest beacon transmission."""
    if len(pairs) < 1:
        return None
    order = np.argsort([p[0]["timestamp"] for p in pairs])
    pairs = [pairs[i] for i in order]
    sdoa = np.asarray(beacon_sdoa)[order]
    times = [float(p[0]["timestamp"]) for p in pairs]

    def evaluate(det0, det1):
        idx = bisect.bisect_left(times, float(det0["timestamp"]))
        if idx > 0 and (idx == len(times)
                        or abs(det0["timestamp"] - times[idx - 1])
                        < abs(det0["timestamp"] - times[idx])):
            idx -= 1
        dsoa0 = det0["soa"] - pairs[idx][0]["soa"]
        dsoa1 = det1["soa"] - pairs[idx][1]["soa"]
        return (dsoa0 - dsoa1 + sdoa[idx]) / sample_rate

    return evaluate


def build_model_linear(pairs, beacon_sdoa, sample_rate):
    """Piecewise-linear interpolation between adjacent beacon pairs.

    Faithful port of the reference's experimental fourth clock model
    (thrifty/tdoa_est.py:186-222): bracket the mobile detection's
    timestamp between the two nearest beacon transmissions of the SAME
    beacon, linearly interpolate rx1's beacon SoA at the mobile's rx0
    SoA, and difference against the mobile's rx1 SoA.  Reference quirks
    preserved: only the bracketing HIGH pair's expected SDOA is added
    (not interpolated -- the reference marks this with a FIXME), and
    the reference's ``sort(cmp=<bool>)`` was a Python 2 NO-OP (see
    scripts/make_reference_goldens.sh), so pairs are used in the order
    given -- our extractor already yields them timestamp-sorted, which
    is what the bisect assumes.
    """
    if len(pairs) < 2:
        return None
    sdoa = np.asarray(beacon_sdoa)
    times = [float(p[0]["timestamp"]) for p in pairs]

    def evaluate(det0, det1):
        high = bisect.bisect_left(times, float(det0["timestamp"]))
        if high == len(times):
            high -= 1
        low = high - 1
        # walk to the nearest earlier transmission of the same beacon
        while low >= 0 and pairs[low][0]["txid"] != pairs[high][0]["txid"]:
            low -= 1
        if low < 0:
            return None
        b0, b1 = pairs[low], pairs[high]
        denom = b1[0]["soa"] - b0[0]["soa"]
        if denom == 0:
            return None
        weight = (det0["soa"] - b0[0]["soa"]) / denom
        # Predicted rx1 SoA for a beacon-like event at det0's rx0 SoA,
        # minus the actual mobile rx1 SoA: tau ~= rate*tdoa_mobile -
        # sdoa_beacon, so adding the bracketing pair's expected SDOA
        # recovers the mobile TDOA (the reference's formula is correct
        # despite its own FIXME comments; verified against the poly
        # model and the simulated geometry in tests/test_tdoa.py).
        tau = (b0[1]["soa"] * (1 - weight) + b1[1]["soa"] * weight) \
            - det1["soa"]
        return (tau + sdoa[high]) / sample_rate

    return evaluate


def model_quality(pairs):
    """Beacon-pair SNR as a model confidence figure."""
    snr0 = np.array([(p[0]["energy"] / p[0]["noise"]) ** 2 for p in pairs])
    snr1 = np.array([(p[1]["energy"] / p[1]["noise"]) ** 2 for p in pairs])
    return (np.mean(snr0) + np.mean(snr1)) / 2


def estimate_tdoas(detections, matches, window_size, beacon_pos, rx_pos,
                   sample_rate, model_builder=build_model_poly,
                   model_params=None, batched=None):
    """Estimate TDOAs for every mobile match group and receiver pair.

    Returns (tdoa_groups, failures).

    With the standard clock models (poly / nearest / weighted-poly /
    linear, no custom parameters) this dispatches to the vectorized
    implementation (:func:`estimate_tdoas_batched`): same math, all
    windows/rows fitted as batched least-squares solves instead of one
    np.polyfit per (group, pair).  ``batched=False`` forces the
    sequential reference path (custom model builders always use it).
    """
    batched_models = {
        build_model_poly: "poly",
        build_model_nearest: "nearest",
        build_model_weighted_poly: "weighted_poly",
        build_model_linear: "linear",
    }
    batchable = model_builder in batched_models and not model_params
    if batched is None:
        batched = batchable
    if batched:
        if not batchable:
            raise ValueError(
                "batched=True requires one of the standard model "
                "builders (poly/nearest/weighted_poly/linear) without "
                "custom model_params; use batched=False for custom "
                "models")
        return estimate_tdoas_batched(
            detections, matches, window_size, beacon_pos, rx_pos,
            sample_rate, model=batched_models[model_builder])
    model_params = model_params or {}
    beacon_matches = [m for m in matches
                      if int(detections[m[0]]["txid"]) in beacon_pos]
    mobile_matches = [(i, m) for i, m in enumerate(matches)
                      if int(detections[m[0]]["txid"]) not in beacon_pos]

    beacons = BeaconPairs(detections, beacon_matches)

    def expected_sdoa(rx0, rx1, beacon_id):
        return (_dist(rx_pos[rx0], beacon_pos[beacon_id])
                - _dist(rx_pos[rx1], beacon_pos[beacon_id])) \
            / SPEED_OF_LIGHT * sample_rate

    # Clock models depend only on the beacon window; consecutive mobile
    # groups usually share it, so fitted models are memoized per window
    # (a ~10x speedup at production detection rates).
    model_cache = {}

    groups, failures = [], []
    for group_idx, group in mobile_matches:
        tdoas = []
        group_ts = float(detections[group[0]]["timestamp"])
        tx = int(detections[group[0]]["txid"])
        for i0, i1 in itertools.combinations(group, 2):
            if detections[i0]["rxid"] > detections[i1]["rxid"]:
                i0, i1 = i1, i0
            det0, det1 = detections[i0], detections[i1]
            rx0, rx1 = int(det0["rxid"]), int(det1["rxid"])

            pairs, window_key = beacons.extract(
                rx0, rx1,
                float(det0["timestamp"]) - window_size,
                float(det0["timestamp"]) + window_size)
            if window_key in model_cache:
                model, quality = model_cache[window_key]
            else:
                sdoa = [expected_sdoa(rx0, rx1, int(p[0]["txid"]))
                        for p in pairs]
                try:
                    model = model_builder(pairs, sdoa, sample_rate,
                                          **model_params)
                except np.linalg.LinAlgError:
                    # Corrupt SoAs (NaN) can reach polyfit's SVD; one
                    # bad window is a failure, not an aborted run.
                    model = None
                quality = model_quality(pairs) if model is not None \
                    else 0.0
                if window_key is not None:
                    model_cache[window_key] = (model, quality)
            if model is None:
                failures.append((i0, i1))
                continue
            try:
                tdoa = model(det0, det1)
            except np.linalg.LinAlgError:
                # weighted_poly fits per evaluation; a degenerate
                # weighted system is this pair's failure, not the
                # run's.
                tdoa = None
            # `not (< MAX)` instead of `>= MAX`: a NaN tdoa (corrupt
            # mobile SoA through the model) must be a failure, not a
            # NaN row in the .tdoa file -- matching the batched path's
            # rejection of non-finite values.
            if tdoa is None or not abs(tdoa) < MAX_TDOA:
                failures.append((i0, i1))
                continue
            snr = ((det0["energy"] / det0["noise"]) ** 2
                   + (det1["energy"] / det1["noise"]) ** 2) / 2
            tdoas.append((rx0, rx1, tdoa, snr, quality, i0, i1))
        if tdoas:
            groups.append(TdoaGroup(
                group_id=group_idx, timestamp=group_ts, tx=tx,
                tdoas=np.array(tdoas, dtype=TDOA_DTYPE)))
    return groups, failures


def _fit_quadratic_batched(x, y, m, w, ok):
    """Weighted centered/scaled quadratic least squares per batch row.

    ``x``/``y``/``w`` are [B, K] with ``w`` zero on masked entries and
    ``m`` the 0/1 validity mask used for centering; ``ok`` [B] marks
    rows with enough points.  Identical fitted polynomial to
    np.polyfit(x, y, 2, w=w) -- centering/scaling only conditions the
    normal equations for soa ~ 1e9.  Returns (xm, xs, ym, coef[B, 3]);
    predict with ym + polyval(coef, (x_eval - xm) / xs).
    """
    # Masked entries can hold padding garbage or NaNs (dropped corrupt
    # records); zero them so 0 * NaN cannot reach the normal equations.
    x = np.where(m > 0, x, 0.0)
    y = np.where(m > 0, y, 0.0)
    cnt = np.maximum(m.sum(1), 1.0)[:, None]
    xm = (x * m).sum(1, keepdims=True) / cnt
    ym = (y * m).sum(1, keepdims=True) / cnt
    xs = np.sqrt(((x - xm) ** 2 * m).sum(1, keepdims=True) / cnt)
    xs = np.where(xs > 0, xs, 1.0)
    xn = (x - xm) / xs
    v = np.stack([xn * xn, xn, np.ones_like(xn)], axis=-1) \
        * w[..., None]
    yn = (y - ym) * w
    a = np.einsum("bki,bkj->bij", v, v)
    b = np.einsum("bki,bk->bi", v, yn)
    # Tiny Tikhonov floor only to keep the batched solve finite for
    # unusable rows (excluded by ``ok`` anyway).
    a = a + np.eye(3) * 1e-9 * np.where(ok, 0.0, 1.0)[:, None, None]
    try:
        coef = np.linalg.solve(a, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        # Some usable row is exactly singular (e.g. duplicated records
        # collapsing a window's support).  Fall back PER ROW so one
        # degenerate window cannot perturb any healthy window's fit --
        # regularizing the whole batch would make results depend on
        # batch composition and diverge from the sequential path.
        coef = np.empty_like(b)
        for i in range(len(a)):
            try:
                coef[i] = np.linalg.solve(a[i], b[i])
            except np.linalg.LinAlgError:
                coef[i] = np.linalg.solve(a[i] + np.eye(3) * 1e-9, b[i])
    return xm[:, 0], xs[:, 0], ym[:, 0], coef


def estimate_tdoas_batched(detections, matches, window_size, beacon_pos,
                           rx_pos, sample_rate, model="poly"):
    """Vectorized TDOA estimation with the standard clock models.

    Numerically equivalent to :func:`estimate_tdoas` with the
    corresponding model builder (cross-checked in tests), restructured
    for production rates: all distinct beacon windows are gathered into
    padded [W, Kmax] arrays, MAD outlier rejection runs batched, and

    * ``model='poly'``: one centered/scaled quadratic fit per distinct
      window as a batched 3x3 normal-equation solve
      (:func:`build_model_poly`);
    * ``model='nearest'``: per-row nearest-beacon difference
      (:func:`build_model_nearest`);
    * ``model='weighted_poly'``: per-row proximity-weighted quadratic
      fits (:func:`build_model_weighted_poly` -- weights depend on the
      mobile detection, so the solve is per row, still batched);
    * ``model='linear'``: per-row bracketing between the two nearest
      same-beacon transmissions (:func:`build_model_linear`), the
      bisect expressed as a rank over kept window columns.
    """
    if model not in ("poly", "nearest", "weighted_poly", "linear"):
        raise ValueError("unknown model: " + model)
    min_pairs = {"nearest": 1, "linear": 2}.get(model, 3)
    beacon_matches = [m for m in matches
                      if int(detections[m[0]]["txid"]) in beacon_pos]
    mobile_matches = [(i, m) for i, m in enumerate(matches)
                      if int(detections[m[0]]["txid"]) not in beacon_pos]

    sdoa_memo = {}  # pure geometry: constant per (rx0, rx1, beacon)

    def expected_sdoa(rx0, rx1, beacon_id):
        k = (rx0, rx1, beacon_id)
        v = sdoa_memo.get(k)
        if v is None:
            v = (_dist(rx_pos[rx0], beacon_pos[beacon_id])
                 - _dist(rx_pos[rx1], beacon_pos[beacon_id])) \
                / SPEED_OF_LIGHT * sample_rate
            sdoa_memo[k] = v
        return v

    # -- per receiver-pair sorted beacon arrays ------------------------------
    by_key = collections.defaultdict(list)
    for group in beacon_matches:
        for i0, i1 in itertools.combinations(group, 2):
            if detections[i0]["rxid"] > detections[i1]["rxid"]:
                i0, i1 = i1, i0
            by_key[(int(detections[i0]["rxid"]),
                    int(detections[i1]["rxid"]))].append((i0, i1))
    beacon_arrays = {}
    for key, plist in by_key.items():
        b0 = detections[[p[0] for p in plist]]
        b1 = detections[[p[1] for p in plist]]
        order = np.argsort(b0["timestamp"], kind="stable")
        b0, b1 = b0[order], b1[order]
        txs = b0["txid"].astype(np.int64)
        uniq_tx = np.unique(txs)
        tx_sdoa = {int(t): expected_sdoa(key[0], key[1], int(t))
                   for t in uniq_tx}
        sdoa_exp = np.array([tx_sdoa[int(t)] for t in txs])
        beacon_arrays[key] = {
            "t": b0["timestamp"].astype(np.float64),
            "tx": txs,
            "soa0": b0["soa"].astype(np.float64),
            "soa1": b1["soa"].astype(np.float64),
            "x": b1["soa"].astype(np.float64) + sdoa_exp,
            "snr": ((b0["energy"] / b0["noise"]) ** 2
                    + (b1["energy"] / b1["noise"]) ** 2) / 2.0,
        }

    # -- gather all (mobile group, pair) rows --------------------------------
    rows_gid, rows_key = [], []
    rows_i0, rows_i1 = [], []
    failures = []
    group_meta = {}  # group_idx -> (timestamp, tx)
    for group_idx, group in mobile_matches:
        group_meta[group_idx] = (
            float(detections[group[0]]["timestamp"]),
            int(detections[group[0]]["txid"]))
        for i0, i1 in itertools.combinations(group, 2):
            if detections[i0]["rxid"] > detections[i1]["rxid"]:
                i0, i1 = i1, i0
            key = (int(detections[i0]["rxid"]),
                   int(detections[i1]["rxid"]))
            if key not in beacon_arrays:
                failures.append((i0, i1))
                continue
            rows_gid.append(group_idx)
            rows_key.append(key)
            rows_i0.append(i0)
            rows_i1.append(i1)
    if not rows_gid:
        return [], failures

    det0 = detections[rows_i0]
    det1 = detections[rows_i1]
    n_rows = len(rows_gid)
    row_tdoa = np.full(n_rows, np.nan)
    row_quality = np.zeros(n_rows)
    row_ok = np.zeros(n_rows, dtype=bool)

    # -- per pair key: window extraction + batched fits + evaluation ---------
    keys = sorted(set(rows_key))
    key_id = {k: i for i, k in enumerate(keys)}  # O(rows), not O(rows*keys)
    rows_key = np.array(
        [key_id[k] for k in rows_key], dtype=np.int64)
    for key_id, key in enumerate(keys):
        sel = np.nonzero(rows_key == key_id)[0]
        arr = beacon_arrays[key]
        t = arr["t"]
        ts0 = det0["timestamp"][sel]
        left = np.searchsorted(t, ts0 - window_size, side="left")
        right = np.searchsorted(t, ts0 + window_size, side="right")
        # Distinct windows (the model memoization, vectorized).
        win, inv = np.unique(
            np.stack([left, right], axis=1), axis=0, return_inverse=True)
        wl, wr = win[:, 0], win[:, 1]
        counts = wr - wl
        kmax = int(counts.max()) if len(counts) else 0
        if kmax < min_pairs:
            # No window can constrain the model.
            failures.extend(
                (int(rows_i0[i]), int(rows_i1[i])) for i in sel)
            continue
        idx = wl[:, None] + np.arange(kmax)[None, :]
        valid = idx < wr[:, None]
        idx = np.minimum(idx, len(t) - 1)
        x = arr["x"][idx]
        y = arr["soa0"][idx]
        snr_b = arr["snr"][idx]
        # MAD outlier rejection on the raw SDOA within each window
        # (reference tdoa_est.py:43-73), batched.  Masked medians via
        # inf-padded sorts: np.nanmedian routes through numpy.ma and
        # costs ~25% of the whole serve step at production rates.
        # Pairs with non-finite SoAs (corrupt .toads rows) are dropped
        # up front so one bad record cannot poison a whole window.
        sdoa_raw = arr["soa0"][idx] - arr["soa1"][idx]
        valid &= np.isfinite(sdoa_raw)
        kcnt = valid.sum(axis=1)
        rows_w = np.arange(len(wl))

        def masked_median(values, cnt):
            srt = np.sort(np.where(valid, values, np.inf), axis=1)
            lo = np.maximum((cnt - 1) // 2, 0)
            hi = np.minimum(np.maximum(cnt // 2, 0), srt.shape[1] - 1)
            return 0.5 * (srt[rows_w, lo] + srt[rows_w, hi])

        med = masked_median(sdoa_raw, kcnt)[:, None]
        diff = np.abs(sdoa_raw - med)
        mad = masked_median(diff, kcnt)[:, None]
        with np.errstate(invalid="ignore", divide="ignore"):
            outlier = (0.6745 * diff / mad) > 3.5
        # mad == 0 (identical/quantized SDOAs): reference inf/nan
        # arithmetic flags any DEVIATING point as an outlier and keeps
        # points at the median -- mirror stats.is_outlier exactly.
        outlier = np.where(mad > 0, outlier, diff > 0)
        keep = valid & ~outlier
        kcount = keep.sum(axis=1)
        fit_ok = kcount >= min_pairs
        m = keep.astype(np.float64)
        quality = (snr_b * m).sum(1) / np.maximum(kcount, 1)
        r_ok = fit_ok[inv]

        if model == "poly":
            # One fit per distinct window, evaluated per row via inv.
            xm, xs, ym, coef = _fit_quadratic_batched(x, y, m, m, fit_ok)
            xe = (det1["soa"][sel] - xm[inv]) / xs[inv]
            pred = ym[inv] + (coef[inv, 0] * xe + coef[inv, 1]) * xe \
                + coef[inv, 2]
            tdoa_v = (det0["soa"][sel] - pred) / sample_rate
        elif model == "nearest":
            # Difference against the nearest kept beacon transmission:
            # build_model_nearest's bisect emulated EXACTLY.  r = first
            # kept column with t >= ts0 (bisect_left lands on the FIRST
            # of duplicated timestamps), l = last kept column with
            # t < ts0; l wins only on a strictly smaller distance (an
            # equidistant pair goes right), which also reproduces the
            # sequential path when several beacon pairs share one
            # timestamp -- a plain masked argmin breaks both tie cases.
            keep_r = keep[inv]
            t_w = arr["t"][idx][inv]
            ts0c = ts0[:, None]
            ge = keep_r & (t_w >= ts0c)
            lt = keep_r & (t_w < ts0c)
            has_r, has_l = ge.any(axis=1), lt.any(axis=1)
            rcol = np.argmax(ge, axis=1)
            lcol = keep_r.shape[1] - 1 - np.argmax(lt[:, ::-1], axis=1)
            take = lambda a, c: np.take_along_axis(a, c[:, None], 1)[:, 0]
            d_l = np.abs(ts0 - take(t_w, lcol))
            d_r = np.abs(take(t_w, rcol) - ts0)
            use_l = has_l & (~has_r | (d_l < d_r))
            j = np.where(use_l, lcol, rcol)  # garbage rows masked by r_ok
            soa1_w = arr["soa1"][idx]
            dsoa0 = det0["soa"][sel] - y[inv, j]
            dsoa1 = det1["soa"][sel] - soa1_w[inv, j]
            sdoa_b = (x - soa1_w)[inv, j]  # expected beacon SDOA
            tdoa_v = (dsoa0 - dsoa1 + sdoa_b) / sample_rate
        elif model == "linear":
            # Per-row bracket between kept beacon pairs
            # (build_model_linear): the sequential bisect over the
            # outlier-compacted pair list becomes a rank over kept
            # window columns.
            keep_r = keep[inv]                      # [R, kmax]
            t_w = arr["t"][idx][inv]
            tx_w = arr["tx"][idx][inv]
            soa0_w = y[inv]
            soa1_w = arr["soa1"][idx][inv]
            sdoa_w = (x - arr["soa1"][idx])[inv]    # expected beacon SDOA
            ts0c = ts0[:, None]
            kcnt_r = keep_r.sum(axis=1)
            # bisect_left over kept times = count of kept t < ts0,
            # clamped to the last kept element (reference :197-198)
            h_rank = np.minimum(((t_w < ts0c) & keep_r).sum(axis=1),
                                np.maximum(kcnt_r - 1, 0))
            rank = np.cumsum(keep_r, axis=1) - 1    # rank of each kept col
            hcol = np.argmax(keep_r & (rank == h_rank[:, None]), axis=1)
            take = lambda a, c: np.take_along_axis(a, c[:, None], 1)[:, 0]
            tx_h = take(tx_w, hcol)
            # nearest earlier kept pair of the SAME beacon (:203-205)
            cols = np.arange(keep_r.shape[1])[None, :]
            cand = keep_r & (cols < hcol[:, None]) \
                & (tx_w == tx_h[:, None])
            has_low = cand.any(axis=1)
            lcol = np.where(
                has_low,
                keep_r.shape[1] - 1 - np.argmax(cand[:, ::-1], axis=1),
                0)
            y_l, y_h = take(soa0_w, lcol), take(soa0_w, hcol)
            s1_l, s1_h = take(soa1_w, lcol), take(soa1_w, hcol)
            denom = y_h - y_l
            r_ok = r_ok & has_low & (denom != 0)
            with np.errstate(invalid="ignore", divide="ignore"):
                wgt = (det0["soa"][sel] - y_l) / denom
                tau = s1_l * (1.0 - wgt) + s1_h * wgt \
                    - det1["soa"][sel]
                tdoa_v = (tau + take(sdoa_w, hcol)) / sample_rate
        else:  # weighted_poly
            # Per-row proximity-weighted fit (build_model_weighted_poly:
            # weights depend on det0.soa, so every row is its own
            # weighted least squares -- still one batched 3x3 solve).
            keep_r = keep[inv]
            m_r = keep_r.astype(np.float64)
            x_r, y_r = x[inv], y[inv]
            with np.errstate(divide="ignore"):
                w = np.sqrt(1.0 / np.abs(y_r - det0["soa"][sel][:, None]))
            w = np.where(np.isfinite(w), w, 1.0)
            wmax = np.maximum(
                np.where(keep_r, w, 0.0).max(axis=1, keepdims=True),
                1e-300)
            w = np.sqrt(w / wmax)
            w = ((w + 2.0) / 3.0) * m_r
            xm, xs, ym, coef = _fit_quadratic_batched(
                x_r, y_r, m_r, w, r_ok)
            xe = (det1["soa"][sel] - xm) / xs
            pred = ym + (coef[:, 0] * xe + coef[:, 1]) * xe + coef[:, 2]
            tdoa_v = (det0["soa"][sel] - pred) / sample_rate

        row_tdoa[sel] = tdoa_v
        row_quality[sel] = quality[inv]
        row_ok[sel] = r_ok
        for i in sel[~r_ok]:
            failures.append((int(rows_i0[i]), int(rows_i1[i])))

    # -- reject non-physical TDOAs and assemble groups -----------------------
    too_far = row_ok & ~(np.abs(row_tdoa) < MAX_TDOA)
    for i in np.nonzero(too_far)[0]:
        failures.append((int(rows_i0[i]), int(rows_i1[i])))
    row_ok &= ~too_far

    snr = ((det0["energy"] / det0["noise"]) ** 2
           + (det1["energy"] / det1["noise"]) ** 2) / 2.0
    groups = []
    rows_gid = np.asarray(rows_gid)
    rows_i0 = np.asarray(rows_i0)
    rows_i1 = np.asarray(rows_i1)
    rx0s = det0["rxid"]
    rx1s = det1["rxid"]
    # One stable sort by group id replaces a full-array rescan per
    # group (O(groups x rows) at production rates); the stable order
    # keeps each group's rows in original (ascending) row order, so
    # outputs are identical to the per-group nonzero scan.
    sel_by_gid = {}
    ok_idx = np.nonzero(row_ok)[0]
    if len(ok_idx):
        order = ok_idx[np.argsort(rows_gid[ok_idx], kind="stable")]
        gids = rows_gid[order]
        bounds = np.nonzero(np.diff(gids))[0] + 1
        for run in np.split(order, bounds):
            sel_by_gid[int(rows_gid[run[0]])] = run
    for group_idx, _ in mobile_matches:
        sel = sel_by_gid.get(int(group_idx))
        if sel is None:
            continue
        tdoas = np.zeros(len(sel), dtype=TDOA_DTYPE)
        tdoas["rx0"] = rx0s[sel]
        tdoas["rx1"] = rx1s[sel]
        tdoas["tdoa"] = row_tdoa[sel]
        tdoas["snr"] = snr[sel]
        tdoas["model_quality"] = row_quality[sel]
        tdoas["det0_idx"] = rows_i0[sel]
        tdoas["det1_idx"] = rows_i1[sel]
        ts, tx = group_meta[group_idx]
        groups.append(TdoaGroup(
            group_id=group_idx, timestamp=ts, tx=tx, tdoas=tdoas))
    return groups, failures


# -- file formats ------------------------------------------------------------

def save_tdoa_groups(stream_or_path, groups):
    """Write .tdoa lines: group_id ts tx rx0 rx1 tdoa_ns snr quality i0 i1."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save_tdoa_groups(f, groups)
    f = stream_or_path
    for g in groups:
        for t in g.tdoas:
            f.write("{} {:.6f} {} {} {} {!r} {!r} {!r} {} {}\n".format(
                g.group_id, g.timestamp, g.tx, int(t["rx0"]), int(t["rx1"]),
                float(t["tdoa"]) * 1e9, float(t["snr"]),
                float(t["model_quality"]),
                int(t["det0_idx"]), int(t["det1_idx"])))


def load_tdoa_groups(stream_or_path):
    """Read a .tdoa file back into TdoaGroup objects (tdoa in seconds)."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return load_tdoa_groups(f)
    rows = []
    for line in stream_or_path:
        if not line.strip() or line[0] == "#":
            continue
        p = line.split()
        rows.append((int(p[0]), float(p[1]), int(p[2]), int(p[3]),
                     int(p[4]), float(p[5]) / 1e9, float(p[6]),
                     float(p[7]), int(p[8]), int(p[9])))
    groups = collections.OrderedDict()
    for row in rows:
        gid = row[0]
        if gid not in groups:
            groups[gid] = TdoaGroup(group_id=gid, timestamp=row[1],
                                    tx=row[2], tdoas=[])
        groups[gid].tdoas.append(row[3:])
    return [
        g._replace(tdoas=np.array(
            [tuple(t) for t in g.tdoas], dtype=TDOA_DTYPE))
        for g in groups.values()
    ]


def load_pos_config(stream_or_path):
    """Parse an ``id: x y [z]`` coordinate config."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return load_pos_config(f)
    strings = parse_kv_config(stream_or_path)
    return {int(k): np.array([float(x) for x in v.split()])
            for k, v in strings.items()}


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("toads", nargs="?", type=str, default="data.toads")
    parser.add_argument("matches", nargs="?", type=str,
                        default="data.match")
    parser.add_argument("-o", "--output", type=str, default="data.tdoa")
    parser.add_argument("-r", "--rx-coordinates", dest="rx_pos",
                        type=str, default="pos-rx.cfg")
    parser.add_argument("-b", "--beacon-coordinates", dest="beacon_pos",
                        type=str, default="pos-beacon.cfg")
    parser.add_argument("-w", "--window-size", type=float, default=8,
                        help="beacon eligibility window (s) [default: 8]")
    parser.add_argument("-s", "--sample-rate", type=float, default=2.4e6)
    parser.add_argument("--model", type=str, default="poly",
                        choices=["poly", "nearest", "weighted-poly",
                                 "linear"],
                        help="beacon clock model [default: poly]")
    args = parser.parse_args(argv)

    detections = toad.load_toads(
        sys.stdin if args.toads == "-" else args.toads)
    matches = matchmaker.load_matches(args.matches)
    rx_pos = load_pos_config(args.rx_pos)
    beacon_pos = load_pos_config(args.beacon_pos)
    builder = {
        "poly": build_model_poly,
        "nearest": build_model_nearest,
        "weighted-poly": build_model_weighted_poly,
        "linear": build_model_linear,
    }[args.model]
    groups, failures = estimate_tdoas(
        detections, matches, args.window_size, beacon_pos, rx_pos,
        args.sample_rate, model_builder=builder)
    print("Number of TDOA estimations:", len(groups))
    print("Number of TDOA estimation failures:", len(failures))
    if args.output == "-":
        save_tdoa_groups(sys.stdout, groups)
    else:
        save_tdoa_groups(args.output, groups)


if __name__ == "__main__":
    sys.exit(_main())
