"""The reference's own reading of a run's input bytes.

The benchmark makes the input bytes itself and hands the same bytes to
the program and to the reference; everything the program derives from
them (rows, complex samples, decoded ``.card`` payloads) the reference
derives again here, in float64, with no code of the program.
"""

from __future__ import annotations

import base64

import numpy as np

# Upstream Thrifty's sample conversion: (byte - 127.4) / 128 per I and Q
# (thrifty/block_data.py), and 0x80 for a byte before the stream start.
DC_OFFSET = 127.4
SCALE = 1.0 / 128.0
ZERO_SIGNAL = 0x80


def raw_to_iq(raw):
    """uint8 interleaved I/Q [..., 2N] -> complex128 [..., N]."""
    f = np.asarray(raw, dtype=np.float64)
    return (f[..., 0::2] - DC_OFFSET) * SCALE \
        + 1j * ((f[..., 1::2] - DC_OFFSET) * SCALE)


class CyclicStream:
    """A base byte stream repeated without end, unfolded into
    overlap-save blocks as an upstream receiver reads a stream.

    Global block ``g`` holds the stream's samples
    ``[g*new_len - history_len, g*new_len - history_len + block_len)``;
    samples before the stream start are zero-signal bytes.  The base
    stream holds ``period`` blocks' worth of new samples, so block ``g``
    has the bytes of block ``g % period`` for every ``g >= 1``; block 0
    alone has pre-stream history.  :meth:`key` names those distinct
    blocks.
    """

    def __init__(self, base_u8, block_len, history_len):
        self.base = np.asarray(base_u8, dtype=np.uint8).reshape(-1)
        self.block_len = block_len
        self.history_len = history_len
        self.new_len = block_len - history_len
        if len(self.base) % (2 * self.new_len):
            raise ValueError("base stream is not a whole number of blocks")
        self.period = len(self.base) // (2 * self.new_len)

    def key(self, g):
        """Distinct-block key of global block ``g``: -1 for block 0."""
        g = int(g)
        return -1 if g == 0 else g % self.period

    def block_bytes(self, key):
        """uint8 [2*block_len] of the block named by ``key``."""
        hist2, n2 = 2 * self.history_len, 2 * self.block_len
        if key == -1:
            out = np.full(n2, ZERO_SIGNAL, dtype=np.uint8)
            out[hist2:] = self.base[:n2 - hist2]
            return out
        start = (key * 2 * self.new_len - hist2) % len(self.base)
        pos = (start + np.arange(n2)) % len(self.base)
        return self.base[pos]


def read_card(path):
    """Parse a ``.card`` file: (timestamps [R], indices [R], payloads,
    a list of R uint8 rows), skipping comment and malformed lines as
    upstream's reader does (thrifty/block_data.py:101-131)."""
    ts, idx, rows = [], [], []
    with open(path, "rb") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or parts[0].startswith(b"#"):
                continue
            try:
                t, i = float(parts[0]), int(parts[1])
                payload = base64.b64decode(parts[2], validate=True)
            except ValueError:
                continue
            ts.append(t)
            idx.append(i)
            rows.append(np.frombuffer(payload, dtype=np.uint8))
    return np.asarray(ts), np.asarray(idx, dtype=np.int64), rows
