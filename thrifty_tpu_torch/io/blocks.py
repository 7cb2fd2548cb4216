"""Overlap-save blocking of raw IQ sample streams (host side).

Splits a raw 8-bit interleaved I/Q stream into fixed-size blocks of
``size`` samples where the last ``history`` samples of each block are
repeated at the start of the next (reference thrifty/block_data.py:70-98,
fastcard/raw_reader.c:22-30).  Batches of blocks are materialized as
[B, 2*size] uint8 arrays ready for device upload.
"""

from __future__ import annotations

import time as time_mod

import numpy as np


def make_t0_stamper(t0, size, history, sample_rate):
    """Deterministic per-block timestamper: block k is stamped
    ``t0 + k * (size - history) / sample_rate``.

    One shared implementation for every ingest fallback path (detect
    and capture) so the timestamp convention can never skew between
    them -- StreamPump's t0 mode follows the same rule.
    """
    block_dt = (size - history) / sample_rate
    counter = {"n": 0}

    def stamper():
        counter["n"] += 1
        return t0 + (counter["n"] - 1) * block_dt

    return stamper


def raw_batches(stream, size, history, batch_size, timestamper=None):
    """Yield (timestamps [b], indices [b], raw [b, 2*size]) batches.

    ``stream`` is a binary file-like object of interleaved uint8 I/Q.
    The first block is zero-padded at the front (history of zeros), like
    the reference reader.
    """
    if timestamper is None:
        timestamper = time_mod.time
    if not 0 <= history < size:
        # size == history makes new_bytes 0: read(0) returns b'' but
        # the EOF test (len < new_bytes) can never fire -> an infinite
        # loop appending history-only blocks; history > size reads a
        # negative count.  Fail loudly like StreamPump does.
        raise ValueError(
            "history must satisfy 0 <= history < size "
            "(got history={}, size={})".format(history, size))
    new_bytes = 2 * (size - history)
    hist_bytes = 2 * history
    tail = np.zeros(hist_bytes, dtype=np.uint8) + 128  # zero-signal bias

    ts_buf, idx_buf, raw_buf = [], [], []
    block_idx = 0
    while True:
        chunk = stream.read(new_bytes)
        # Read-fully: socket-backed sources (rtl_tcp) legitimately
        # return short reads mid-stream; only an EMPTY read means EOF.
        # Treating a short read as EOF would end a live capture after
        # the first network packet.
        while 0 < len(chunk) < new_bytes:
            more = stream.read(new_bytes - len(chunk))
            if not more:
                break
            chunk += more
        if len(chunk) < new_bytes:
            break
        new = np.frombuffer(chunk, dtype=np.uint8)
        block = np.concatenate([tail, new])
        # Explicit start offset: `[-hist_bytes:]` with history 0 would
        # carry the WHOLE block as the next tail (ever-growing blocks).
        tail = block[len(block) - hist_bytes:]
        ts_buf.append(timestamper())
        idx_buf.append(block_idx)
        raw_buf.append(block)
        block_idx += 1
        if len(raw_buf) == batch_size:
            yield (np.asarray(ts_buf), np.asarray(idx_buf, dtype=np.int64),
                   np.stack(raw_buf))
            ts_buf, idx_buf, raw_buf = [], [], []
    if raw_buf:
        yield (np.asarray(ts_buf), np.asarray(idx_buf, dtype=np.int64),
               np.stack(raw_buf))
