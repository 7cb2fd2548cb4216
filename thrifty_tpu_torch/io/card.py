""".card file reading/writing (carrier-detection block captures).

Format (reference fastcard/fastcard_cli.c:183-193, thrifty/block_data.py:
101-131): text lines ``<timestamp> <block_index> <base64(raw block)>``
where the raw block is the full block's 8-bit interleaved I/Q samples;
``#`` lines are comments.

The default implementation parses whole files into batched arrays
(timestamps [B], indices [B], raw [B, 2N]) -- feeding the TPU detector
batch-at-a-time rather than block-at-a-time.  A C++ fast path
(thrifty_tpu_torch.native) accelerates base64 decode when built.
"""

from __future__ import annotations

import base64
import binascii

import numpy as np

from thrifty_tpu_torch.dsp import iq

_SKIP_PREFIXES = ("Using Volk machine:", "linux;")

_native_mod = None  # None = unprobed; False = unavailable (cached)


def _native():
    """The native module, probed ONCE per process.

    Python evicts failed imports from sys.modules, so a bare
    try/import in the per-batch hot path would re-run the native
    build subprocess (make) for every batch on hosts where the build
    fails -- the exact environment the pure-Python fallback serves.
    """
    global _native_mod
    if _native_mod is None:
        try:
            from thrifty_tpu_torch import native as mod
            _native_mod = mod
        except ImportError:
            _native_mod = False
    return _native_mod


def _parse_lines(lines):
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        if not line or line[0] in "#\n":
            continue
        if line.startswith(_SKIP_PREFIXES):
            continue
        parts = line.split()
        if len(parts) < 3:
            continue
        # Real .card files can contain stray tool output (the format
        # explicitly tolerates junk lines); skip anything unparseable.
        # Extra trailing tokens are ignored (fscanf semantics, like the
        # reference's C reader and the native parser here).
        try:
            yield float(parts[0]), int(parts[1]), parts[2]
        except ValueError:
            continue


def read_card(stream_or_path, native=True):
    """Read a .card file into (timestamps [B], indices [B], raw [B, 2N]).

    Uses the native multi-threaded parser (thrifty_tpu_torch.native) when the
    library is available, falling back to pure Python.  Blocks of
    differing length raise ValueError (fixed block size is a format
    invariant).
    """
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "rb") as f:
            return read_card(f, native=native)

    if native and _native():
        data = stream_or_path.read()
        if isinstance(data, str):  # text-mode stream
            data = data.encode("ascii", errors="replace")
        return _native().parse_card_bytes(data)

    timestamps, indices, encoded = [], [], []
    for ts, idx, enc in _parse_lines(stream_or_path):
        timestamps.append(ts)
        indices.append(idx)
        encoded.append(enc)

    if not timestamps:
        n = 0
        return (np.zeros(0), np.zeros(0, np.int64), np.zeros((0, n), np.uint8))

    # Decode through the same tolerant path the streaming reader uses,
    # so a capture parses identically with and without the native lib:
    # junk rows (including wrong-size valid base64) are dropped up to
    # the shared max(2, 10%) cap, above which it fails loudly.
    out = _decode_batch(timestamps, indices, encoded, native=native)
    if len(out[0]) == 0:
        # Rows were found but none decoded -- match the native path's
        # loud failure instead of silently returning an empty capture.
        raise ValueError("invalid base64 payload")
    return out


def read_card_blocks(stream_or_path):
    """Read a .card file into (timestamps, indices, complex64 blocks)."""
    ts, idx, raw = read_card(stream_or_path)
    return ts, idx, iq.raw_to_iq_host(raw)


def iter_card_batches(stream, batch_size):
    """Yield (timestamps, indices, raw [b, 2N]) batches from a stream.

    Streaming variant for unbounded captures: accumulates lines into
    fixed-size batches so device work stays statically shaped.
    """
    ts_buf, idx_buf, enc_buf = [], [], []
    for ts, idx, enc in _parse_lines(stream):
        ts_buf.append(ts)
        idx_buf.append(idx)
        enc_buf.append(enc)
        if len(ts_buf) == batch_size:
            yield _decode_batch(ts_buf, idx_buf, enc_buf)
            ts_buf, idx_buf, enc_buf = [], [], []
    if ts_buf:
        yield _decode_batch(ts_buf, idx_buf, enc_buf)


def _decode_batch(ts_buf, idx_buf, enc_buf, native=True):
    """Decode one batch worth of base64 payloads, skipping junk rows.

    Uses the native multithreaded decoder when available (the streaming
    detect path is host-decode bound), falling back to per-row Python.
    """
    if native and _native():
        raw, keep = _native().b64decode_batch_tolerant(enc_buf)
        return (
            np.asarray(ts_buf, dtype=np.float64)[keep],
            np.asarray(idx_buf, dtype=np.int64)[keep],
            raw,
        )

    n_rows = len(enc_buf)
    decoded, ts_ok, idx_ok = [], [], []
    for ts, ix, e in zip(ts_buf, idx_buf, enc_buf):
        try:
            decoded.append(np.frombuffer(
                base64.b64decode(e, validate=True), dtype=np.uint8))
            ts_ok.append(ts)
            idx_ok.append(ix)
        except (ValueError, binascii.Error):
            continue
    dropped = n_rows - len(decoded)
    if decoded and len({len(d) for d in decoded}) != 1:
        # A junk row that happens to be valid base64 of the wrong size
        # is dropped like any other junk row, keeping the
        # dominant-by-bytes size (real rows are kilobytes, so byte
        # mass out-votes short junk even in tiny batches).
        sizes = np.asarray([len(d) for d in decoded])
        uniq, counts = np.unique(sizes, return_counts=True)
        modal = uniq[np.lexsort((uniq, uniq * counts))[-1]]
        dropped += int(np.sum(sizes != modal))
        keep = [i for i, d in enumerate(decoded) if len(d) == modal]
        decoded = [decoded[i] for i in keep]
        ts_ok = [ts_ok[i] for i in keep]
        idx_ok = [idx_ok[i] for i in keep]
    # ALL dropped rows (undecodable junk + wrong-size) count against
    # one shared cap over the total row count -- the same accounting
    # as the native tolerant decoder, so a capture that is junk beyond
    # the tolerance fails loudly in both paths.
    if decoded and dropped > max(2, 0.1 * n_rows):
        raise ValueError("inconsistent block sizes in .card file")
    raw = np.stack(decoded) if decoded else np.zeros((0, 0), np.uint8)
    return (
        np.asarray(ts_ok, dtype=np.float64),
        np.asarray(idx_ok, dtype=np.int64),
        raw,
    )


def write_card(stream_or_path, timestamps, indices, raw, header=None):
    """Write blocks to a .card file.

    ``raw`` is [B, 2N] uint8; complex blocks should be converted with
    :func:`thrifty_tpu_torch.dsp.iq.iq_to_raw` first.
    """
    if isinstance(stream_or_path, str):
        with open(stream_or_path, "w") as f:
            return write_card(f, timestamps, indices, raw, header)

    f = stream_or_path
    if header:
        for line in header.splitlines():
            f.write("# " + line + "\n")
    mod = _native()
    if mod:
        encode = mod.b64encode
    else:
        encode = lambda row: base64.b64encode(
            np.ascontiguousarray(row).tobytes()).decode()
    for ts, idx, row in zip(timestamps, indices, raw):
        f.write("{:.6f} {} {}\n".format(float(ts), int(idx), encode(row)))
