""".toad / .toads detection records.

Text format compatible with the reference (thrifty/toads_data.py:47-61):

  [rxid] [txid] timestamp block soa corr_sample corr_offset corr_energy
  corr_noise carrier_bin carrier_offset carrier_energy carrier_noise

.toad files (per receiver) carry rxid; .toads files (merged) carry
rxid + txid.  Unlike the reference's list-of-objects model, detections
here live in a numpy structured array from the start -- every downstream
stage (identify/match/tdoa) is vectorized over it.
"""

from __future__ import annotations

import numpy as np

DETECTION_DTYPE = np.dtype([
    ("rxid", "i4"), ("txid", "i4"),
    ("timestamp", "f8"), ("block", "i8"), ("soa", "f8"),
    ("sample", "i4"), ("offset", "f8"),
    ("energy", "f8"), ("noise", "f8"),
    ("carrier_bin", "i4"), ("carrier_offset", "f8"),
    ("carrier_energy", "f8"), ("carrier_noise", "f8"),
])


def empty(n: int = 0) -> np.ndarray:
    out = np.zeros(n, dtype=DETECTION_DTYPE)
    out["rxid"] = -1
    out["txid"] = -1
    return out


def from_detector_output(timestamps, indices, soa, out, rxid=-1,
                         txid_from_template=False):
    """Build detection records from BatchDetector output arrays.

    Only rows where ``out['detected']`` is True are kept.  With
    ``txid_from_template`` the winning template-bank index becomes the
    txid (multi-template per-transmitter matched filtering).
    """
    mask = np.asarray(out["detected"])
    idx = np.nonzero(mask)[0]
    det = empty(len(idx))
    det["rxid"] = rxid
    if txid_from_template:
        det["txid"] = np.asarray(out["template_idx"])[idx]
    det["timestamp"] = np.asarray(timestamps)[idx]
    det["block"] = np.asarray(indices)[idx]
    det["soa"] = np.asarray(soa)[idx]
    det["sample"] = np.asarray(out["corr_sample"])[idx]
    det["offset"] = np.asarray(out["corr_offset"], dtype=np.float64)[idx]
    det["energy"] = np.asarray(out["corr_energy"], dtype=np.float64)[idx]
    det["noise"] = np.asarray(out["corr_noise"], dtype=np.float64)[idx]
    det["carrier_bin"] = np.asarray(out["carrier_bin"])[idx]
    det["carrier_offset"] = np.asarray(
        out["carrier_offset"], dtype=np.float64)[idx]
    det["carrier_energy"] = np.asarray(
        out["carrier_energy"], dtype=np.float64)[idx]
    det["carrier_noise"] = np.asarray(
        out["carrier_noise"], dtype=np.float64)[idx]
    return det


def format_line(d, with_rxid=True, with_txid=False) -> str:
    """Serialize one detection record to a .toad(s) text line."""
    fields = []
    if with_rxid:
        fields.append(str(int(d["rxid"])))
    if with_txid:
        fields.append(str(int(d["txid"])))
    fields += [
        "{:.6f}".format(float(d["timestamp"])),
        str(int(d["block"])),
        "{:.8f}".format(float(d["soa"])),
        str(int(d["sample"])),
        repr(float(d["offset"])),
        repr(float(d["energy"])),
        repr(float(d["noise"])),
        str(int(d["carrier_bin"])),
        repr(float(d["carrier_offset"])),
        repr(float(d["carrier_energy"])),
        repr(float(d["carrier_noise"])),
    ]
    return " ".join(fields)


def save(stream_or_path, detections, with_rxid=True, with_txid=False,
         header=None):
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return save(f, detections, with_rxid, with_txid, header)
    f = stream_or_path
    if header:
        for line in header.splitlines():
            f.write("# " + line + "\n")
    for d in detections:
        f.write(format_line(d, with_rxid, with_txid) + "\n")


def _parse(stream, with_rxid, with_txid):
    import sys

    rows = []
    for lineno, line in enumerate(stream, 1):
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        stripped = line.strip()
        if not stripped or stripped[0] == "#":
            continue
        parts = stripped.split()
        want = 11 + int(with_rxid) + int(with_txid)
        # Exactly `want` fields: an EXTRA leading column (e.g. a
        # .toads file loaded as .toad) would otherwise shift every
        # field by one and silently mis-parse the whole record; a
        # short line is truncation.  Skip with a warning, like the
        # reference loader (thrifty/toads_data.py:106-109).
        if len(parts) != want:
            print("WARNING: skipped line #{} ({} fields, expected {})"
                  .format(lineno, len(parts), want), file=sys.stderr)
            continue
        try:
            rxid = int(float(parts.pop(0))) if with_rxid else -1
            txid = int(float(parts.pop(0))) if with_txid else -1
            vals = [float(x) for x in parts]
        except ValueError:
            print("WARNING: skipped line #{} (unparseable field)"
                  .format(lineno), file=sys.stderr)
            continue
        rows.append((rxid, txid, vals[0], int(vals[1]), vals[2],
                     int(vals[3]), vals[4], vals[5], vals[6],
                     int(vals[7]), vals[8], vals[9], vals[10]))
    out = empty(len(rows))
    for i, row in enumerate(rows):
        out[i] = row
    return out


def load_toad(stream_or_path) -> np.ndarray:
    """Load a single receiver's .toad file (rxid, no txid)."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return _parse(f, True, False)
    return _parse(stream_or_path, True, False)


def load_toads(stream_or_path) -> np.ndarray:
    """Load a merged .toads file (rxid + txid)."""
    if isinstance(stream_or_path, str):
        with open(stream_or_path) as f:
            return _parse(f, True, True)
    return _parse(stream_or_path, True, True)
