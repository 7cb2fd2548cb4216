"""The comparison that decides a run's ``correct``.

Every batch that finished in the measured window is judged: the
``.toad`` records the timed path wrote for it against the frozen float64
reference run on the same input bytes, block by block.

Numbers compared, each with its limit (the configuration's ``limits``):

- ``missing``: blocks the reference detects that have no record (limit 0);
- ``extra``: records the reference does not detect in that batch, or
  with a timestamp other than the block's, or whose ``soa`` field is not
  ``new_len * block + sample + offset`` to its printed precision
  (limit 0);
- ``soa_gap``: the widest gap, in samples, between a record's arrival
  within its block (``sample + offset``) and the reference's: the
  ``soa`` field itself is a float64 near 1e10 printed with 8 decimals,
  whose rounding (2e-6 at 1e10) would otherwise swamp the gap;
- ``carrier_gap``: the widest gap, in FFT bins, between a record's
  carrier frequency (bin + sub-bin offset) and the reference's;
- ``energy_gap``: the widest relative gap, ``|record / reference - 1|``,
  of a record's correlation peak (``energy``) and carrier peak
  (``carrier_energy``) magnitudes: the power/peak kernel's peaks and the
  correlation stage's;
- ``noise_gap``: the same of its two noise levels (``noise``,
  ``carrier_noise``): the kernel's power sums and the correlation's.

A block whose reference peak lies within ``BORDER`` (relative) of its
carrier or correlation threshold is not judged for presence: a float32
program cannot match a float64 decision there.  Such blocks are counted
(``borderline``) and printed, not compared.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.oracle import FastdetOracleDetector, OracleDetector

BORDER = 1e-4
# A record's timestamp is printed with 6 decimals.
TS_TOL = 2e-6
COMPARED = ("missing", "extra", "soa_gap", "carrier_gap", "energy_gap",
            "noise_gap")



def make_oracle(config, template):
    """The reference detector for a configuration file's settings."""
    cls = {"fractional": OracleDetector,
           "integer": FastdetOracleDetector}[config["sync_mode"]]
    return cls(template, block_len=config["block_size"],
               history_len=config["block_history"],
               carrier_thresh=tuple(config["carrier_threshold"]),
               carrier_window=tuple(config["carrier_window"]),
               corr_thresh=tuple(config["corr_threshold"]))


def read_toad(path):
    """float64 [R, 12] of a ``.toad`` file's records (rxid, timestamp,
    block, soa, sample, offset, energy, noise, carrier_bin,
    carrier_offset, carrier_energy, carrier_noise)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 12 and not parts[0].startswith("#"):
                rows.append([float(p) for p in parts])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 12)


def _rel(value, ref):
    """Relative gap of a record's value from the reference's."""
    return abs(value / ref - 1.0) if ref else abs(value)


def _margin(value, noise, thresh):
    """Relative distance of a peak from its threshold."""
    const, snr, std = thresh
    if std:
        raise ValueError("stddev threshold terms are not supported here")
    level = np.sqrt(const + snr * noise ** 2)
    return abs(value / level - 1.0) if level > 0 else np.inf


class Judge:
    """Holds the reference's result per distinct block and judges the
    records of each batch against it.

    ``key_of(block_idx)`` names the distinct block a global index holds,
    ``bytes_of(key)`` gives its uint8 bytes, and ``ts_of(block_idx)``
    its expected timestamp.
    """

    def __init__(self, config, template, key_of, bytes_of, ts_of):
        from benchmark.reference.inputs import raw_to_iq

        self.oracle = make_oracle(config, template)
        self.config = config
        self.key_of, self.bytes_of, self.ts_of = key_of, bytes_of, ts_of
        self._iq = raw_to_iq
        self._cache = {}

    def result(self, block_idx):
        key = self.key_of(block_idx)
        if key not in self._cache:
            self._cache[key] = self.oracle.detect_block(
                self._iq(self.bytes_of(key)))
        return self._cache[key]

    def borderline(self, ref):
        cfg = self.config
        if _margin(ref.carrier_energy, ref.carrier_noise,
                   cfg["carrier_threshold"]) < BORDER:
            return True
        return ref.carrier_detect and _margin(
            ref.corr_energy, ref.corr_noise, cfg["corr_threshold"]) < BORDER

    def judge(self, batches, records):
        """``batches``: [(block indices [n], first record, number of
        records)]; ``records``: [R, 12] from :func:`read_toad`.  Returns
        (compared numbers, other counts)."""
        new_len = self.oracle.new_len
        out = dict.fromkeys(COMPARED, 0)
        for name in COMPARED[2:]:
            out[name] = 0.0
        info = {"batches": len(batches), "blocks": 0, "records": 0,
                "borderline": 0, "failed_batches": 0}
        for idx, first, count in batches:
            recs = records[first:first + count]
            wrong = out["missing"] + out["extra"]
            if len(recs) < count:  # records the file lacks
                out["missing"] += count - len(recs)
            info["blocks"] += len(idx)
            info["records"] += len(recs)
            in_batch = set(int(i) for i in idx)
            seen = set()
            for r in recs:
                block = int(r[2])
                if block not in in_batch or block in seen \
                        or abs(r[1] - self.ts_of(block)) > TS_TOL:
                    out["extra"] += 1
                    continue
                soa = new_len * block + r[4] + r[5]
                if abs(r[3] - soa) > 4 * np.spacing(max(abs(soa), 1.0)) \
                        + 1e-8:
                    out["extra"] += 1
                    continue
                seen.add(block)
                ref = self.result(block)
                if not ref.detected:
                    if self.borderline(ref):
                        info["borderline"] += 1
                    else:
                        out["extra"] += 1
                    continue
                arrival = ref.corr_sample + ref.corr_offset
                out["soa_gap"] = max(out["soa_gap"],
                                     abs(r[4] + r[5] - arrival))
                freq = r[8] + r[9]
                ref_freq = ref.carrier_bin + ref.carrier_offset
                out["carrier_gap"] = max(out["carrier_gap"],
                                         abs(freq - ref_freq))
                out["energy_gap"] = max(
                    out["energy_gap"], _rel(r[6], ref.corr_energy),
                    _rel(r[10], ref.carrier_energy))
                out["noise_gap"] = max(
                    out["noise_gap"], _rel(r[7], ref.corr_noise),
                    _rel(r[11], ref.carrier_noise))
            for block in in_batch - seen:
                ref = self.result(block)
                if ref.detected:
                    if self.borderline(ref):
                        info["borderline"] += 1
                    else:
                        out["missing"] += 1
            if out["missing"] + out["extra"] > wrong:
                info["failed_batches"] += 1
        return out, info


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every compared number at or
    under its limit; ``missing`` and ``extra`` are exact (limit 0)."""
    rows = [(name, numbers[name], limits.get(name, 0))
            for name in COMPARED]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
