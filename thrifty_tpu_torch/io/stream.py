"""Threaded streaming ingestion: reader thread -> ring buffer -> batches.

The TPU-era replacement for the reference's capture producer/consumer
(fastcard/rtlsdr_reader.c:101-117 + circbuf.c): a reader thread pumps a
raw IQ byte stream (SDR pipe, FIFO, file) into the native ring buffer
while the main thread drains fixed-size block batches for the detector,
so input IO overlaps with device compute.  Ring occupancy and overflow
stats expose the real-time margin, exactly like the reference's
at-exit report (rtlsdr_reader.c:310-325).

Falls back to synchronous reading when the native library is missing.
"""

from __future__ import annotations

import threading
import time as time_mod

import numpy as np


def prefetch_iter(iterator, depth=2):
    """Run an iterator in a background thread with a bounded queue.

    Decouples host-side batch production (parse/decode) from the
    consumer (device dispatch), so the two overlap.  Exceptions from
    the producer re-raise at the consumer; abandoning the generator
    (close/GC) stops the producer thread instead of leaving it blocked
    on the full queue.

    Do NOT wrap :meth:`StreamPump.batches` (or batches_contiguous) in
    this: the pump yields VIEWS into a small reusable buffer pool
    whose validity window is BUF_POOL-1 subsequent draws, and the
    prefetch queue plus a pipelining consumer together advance the
    generator past that window, silently overwriting a batch the
    consumer still holds.  The pump already overlaps IO via its own
    reader thread; prefetch_iter is for allocation-per-batch sources
    (the .card parser).
    """
    import queue

    q = queue.Queue(maxsize=depth)
    DONE, ERROR = object(), object()
    stop = threading.Event()

    def put_or_stop(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in iterator:
                if not put_or_stop(item):
                    return
            put_or_stop(DONE)
        except BaseException as e:  # noqa: BLE001 -- forwarded
            put_or_stop((ERROR, e))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is ERROR:
                raise item[1]
            yield item
    finally:
        stop.set()


class StreamPump:
    """Reader thread + ring buffer + overlap-save batch iterator."""

    def __init__(self, stream, block_size, history, batch_size,
                 capacity_bytes=1 << 25, chunk_bytes=1 << 18,
                 timestamper=None, sample_rate=2.4e6, t0=None):
        from thrifty_tpu_torch import native  # ImportError -> falls back

        if not 0 <= history < block_size:
            # Nothing downstream enforces the relation: history ==
            # block_size would ZeroDivisionError in the batch loops and
            # history > block_size would silently yield zero batches.
            raise ValueError(
                "history must satisfy 0 <= history < block_size "
                "(got history={}, block_size={})".format(history,
                                                         block_size))
        self._native = native
        self._stream = stream
        self._batch_size = batch_size
        self._block_bytes = 2 * block_size
        self._hist_bytes = 2 * history
        self._new_bytes = self._block_bytes - self._hist_bytes
        self._chunk = chunk_bytes
        self._timestamper = timestamper or time_mod.time
        self._sample_rate = sample_rate
        # With t0 set, timestamps are synthesized deterministically from
        # the stream position (t0 + block_idx * block_dt) instead of the
        # wall clock -- for re-analyzing recorded raw streams whose
        # start time is known.
        self._t0 = t0
        self._reader_error = None
        # Regular files skip the ring entirely: mmap the file and
        # unfold overlap-save rows straight out of the page cache --
        # ONE host copy total (docs/performance.md), vs two through
        # the fused ring path.  Live sources (pipes, sockets, stdin)
        # keep the reader-thread + ring backpressure design.
        self._mm = self._try_mmap(stream)
        if self._mm is not None:
            self._ring = None
            self._reader = None
            return
        self._ring = native.RingBuffer(capacity_bytes)
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    @staticmethod
    def _try_mmap(stream):
        import mmap
        import os
        import stat

        try:
            fileno = stream.fileno()
            st = os.fstat(fileno)
            if not stat.S_ISREG(st.st_mode) or st.st_size == 0:
                return None
            start = stream.tell()
            if st.st_size - start <= 0:
                return None
            mm = mmap.mmap(fileno, 0, access=mmap.ACCESS_READ)
            return (mm, start)
        except (AttributeError, OSError, ValueError):
            return None

    def _pump(self):
        try:
            try:
                # Pipes default to 64 KB, which caps each readinto and
                # makes the chunk loop syscall-bound; ask the kernel
                # for a bigger buffer (silently capped/refused for
                # non-pipes or unprivileged limits).
                import fcntl
                fcntl.fcntl(self._stream.fileno(),
                            fcntl.F_SETPIPE_SZ, self._chunk)
            except (AttributeError, OSError, ValueError, ImportError):
                # BytesIO raises UnsupportedOperation (an OSError) on
                # fileno(); non-pipe fds get EBADF/EINVAL; platforms
                # without fcntl just skip the tweak -- all fine.
                pass
            readinto = getattr(self._stream, "readinto", None)
            if readinto is not None:
                # Zero-scratch path: readinto() fills a span reserved
                # INSIDE ring memory -- one copy from the kernel into
                # the ring instead of kernel -> bytes object -> ring.
                while True:
                    mv = self._ring.write_view(self._chunk)
                    if mv is None:  # ring closed under us
                        return
                    n = readinto(mv)
                    if not n:
                        break
                    self._ring.commit(n)
            else:
                # Sources exposing only read() (e.g. rtl_tcp clients).
                while True:
                    data = self._stream.read(self._chunk)
                    if not data:
                        break
                    self._ring.write(np.frombuffer(data, dtype=np.uint8))
        except Exception as e:  # noqa: BLE001 -- surfaced to consumer
            self._reader_error = e
        finally:
            self._ring.close()

    def batches(self):
        """Yield (timestamps [b], indices [b], raw [b, block_bytes]).

        The yielded ``raw`` arrays rotate through a small pool of warm
        buffers (fresh per-batch allocations are fault-bound to
        ~200 MB/s on small hosts; warm reuse runs at memory bandwidth).
        A yielded batch therefore stays valid while up to
        ``BUF_POOL - 1`` further batches are drawn -- ample for the
        detect/capture pipelines, which hold at most one batch in
        flight behind the current one.  Do NOT wrap this generator in
        :func:`prefetch_iter`: its queue depth plus a pipelining
        consumer exceed that validity window (see prefetch_iter's
        docstring) -- the pump's own reader thread already overlaps IO.
        """
        if self._mm is not None:
            yield from self._mmap_batches()
            return
        from numpy.lib.stride_tricks import as_strided

        BUF_POOL = 4
        block_idx = 0
        want = self._new_bytes * self._batch_size
        # Fused ring->blocks unfold (one full stream copy fewer) when
        # the geometry and capacity allow; read + strided copy
        # otherwise.  The ingest path is memcpy-bound, so every removed
        # copy is ~a third of the ceiling (docs/performance.md).
        fused = (self._hist_bytes <= self._new_bytes
                 and want <= getattr(self._ring, "capacity", 0)
                 and hasattr(self._ring, "read_unfold"))
        if fused:
            tail = np.full(self._hist_bytes, 128, dtype=np.uint8)
            scratch = None
        else:
            # Carried history + this batch's new bytes, contiguous:
            # every overlap-save row is then a strided window of real
            # stream bytes, for ANY history < block_size (the fused
            # kernel requires history <= advance; this path does not).
            scratch = np.empty(self._hist_bytes + want, dtype=np.uint8)
            scratch[: self._hist_bytes] = 128
        pool = [np.empty((self._batch_size, self._block_bytes), np.uint8)
                for _ in range(BUF_POOL)]
        batch_no = 0
        while True:
            if fused:
                buf = pool[batch_no % BUF_POOL]
                n_blocks, got = self._ring.read_unfold(
                    buf, self._hist_bytes)
                short = got < want
                raw = buf[:n_blocks]
            else:
                data = self._ring.read(
                    want, out=scratch[self._hist_bytes:])
                n_blocks = len(data) // self._new_bytes
                short = len(data) < want
            # Flush-then-raise: a reader failure closes the ring, but
            # whatever it already buffered is good data -- drain and
            # yield it before surfacing the error, so a dying live
            # stream loses nothing that reached the host.
            if n_blocks == 0:
                if self._reader_error is not None:
                    raise self._reader_error
                break
            stamp = self._timestamper()
            if fused:
                raw[0, : self._hist_bytes] = tail
                # Explicit start offset: `[-self._hist_bytes:]` with
                # history 0 would select the WHOLE row and break the
                # next batch's splice.
                tail = raw[-1, self._block_bytes - self._hist_bytes:] \
                    .copy()
            else:
                raw = pool[batch_no % BUF_POOL][:n_blocks]
                np.copyto(raw, as_strided(
                    scratch, shape=(n_blocks, self._block_bytes),
                    strides=(self._new_bytes, 1)))
                # Carry the stream tail for the next batch's history.
                valid = self._hist_bytes + n_blocks * self._new_bytes
                scratch[: self._hist_bytes] = \
                    scratch[valid - self._hist_bytes: valid].copy()
            batch_no += 1
            ts, idx = self._stamps(block_idx, n_blocks, stamp)
            block_idx += n_blocks
            yield ts, idx, raw
            if short:
                if self._reader_error is not None:
                    raise self._reader_error
                break

    def _stamps(self, b0, n, stamp):
        """(timestamps [n], indices [n]) for blocks b0..b0+n.

        Deterministic ``t0 + idx*block_dt`` when t0 is set; otherwise
        per-block wall clocks backdated from the drain time by the
        block duration -- a whole batch can span >1 s of stream, and
        the matchmaker needs each block's wall clock within its 0.2 s
        window (the reference stamps every block at capture).  ONE
        implementation for all three ingest paths, so --device-unfold
        timestamps can never skew against the host path.
        """
        block_dt = self._new_bytes / 2 / self._sample_rate
        idx = np.arange(b0, b0 + n, dtype=np.int64)
        if self._t0 is not None:
            ts = self._t0 + idx * block_dt
        else:
            ts = stamp - (n - 1 - np.arange(n)) * block_dt
        return ts.astype(np.float64), idx

    def batches_contiguous(self):
        """Yield (timestamps [b], indices [b], new_raw [b*new_bytes]).

        The stream's NEW bytes only -- no repeated history, no host
        unfold -- for consumers that overlap-save on DEVICE
        (``BatchDetector.detect_raw_stream``).  For regular files the
        yielded array is a zero-copy view straight over the page
        cache; live sources pay exactly one host copy (ring -> warm
        buffer).  Timestamp/index semantics match :meth:`batches`.
        """
        stamps = self._stamps

        if self._mm is not None:
            mm, start = self._mm
            base = np.frombuffer(mm, dtype=np.uint8)
            n_total = (len(base) - start) // self._new_bytes
            b0 = 0
            while b0 < n_total:
                n = min(self._batch_size, n_total - b0)
                off = start + b0 * self._new_bytes
                ts, idx = stamps(b0, n, self._timestamper())
                yield ts, idx, base[off:off + n * self._new_bytes]
                b0 += n
            return

        BUF_POOL = 4
        want = self._new_bytes * self._batch_size
        pool = [np.empty(want, np.uint8) for _ in range(BUF_POOL)]
        block_idx = 0
        batch_no = 0
        while True:
            data = self._ring.read(want, out=pool[batch_no % BUF_POOL])
            n = len(data) // self._new_bytes
            short = len(data) < want
            # Flush-then-raise, as in batches().
            if n == 0:
                if self._reader_error is not None:
                    raise self._reader_error
                break
            ts, idx = stamps(block_idx, n, self._timestamper())
            block_idx += n
            batch_no += 1
            yield ts, idx, data[:n * self._new_bytes]
            if short:
                if self._reader_error is not None:
                    raise self._reader_error
                break

    def _mmap_batches(self):
        """One-copy ingest for regular files: strided rows out of the
        page cache into the warm buffer pool, no ring, no reader
        thread.  Yields byte-identical batches to the ring path on the
        same data (asserted in tests/test_stream.py)."""
        BUF_POOL = 4
        mm, start = self._mm
        base = np.frombuffer(mm, dtype=np.uint8)
        n_total = (len(base) - start) // self._new_bytes
        pool = [np.empty((self._batch_size, self._block_bytes), np.uint8)
                for _ in range(BUF_POOL)]
        b0 = 0
        batch_no = 0
        while b0 < n_total:
            n = min(self._batch_size, n_total - b0)
            out = pool[batch_no % BUF_POOL][:n]
            off = start + b0 * self._new_bytes
            stamp = self._timestamper()
            if b0 == 0:
                # First batch: row 0's history precedes the stream;
                # unfold 128-fills it (same as the ring path's initial
                # tail), rows 1+ take history from the stream.
                self._native.unfold(
                    base[off:off + n * self._new_bytes],
                    self._block_bytes, self._hist_bytes, n, out=out)
            else:
                pre = self._hist_bytes - b0 * self._new_bytes
                if pre > 0:
                    # The earliest rows' history still reaches before
                    # the STREAM start (history > one batch's advance):
                    # assemble 128-padding + stream bytes once and
                    # gather rows out of that.  Indexing
                    # base[off - hist:] here would wrap negative
                    # offsets to the file tail (or, with start > 0,
                    # read pre-stream file bytes the ring path treats
                    # as 128s).
                    span = np.empty(
                        self._hist_bytes + n * self._new_bytes,
                        dtype=np.uint8)
                    span[:pre] = 128
                    span[pre:] = base[
                        start:start + (b0 + n) * self._new_bytes]
                    self._native.copy_rows(span, 0, out,
                                           self._new_bytes)
                else:
                    # Every row's bytes exist in the stream -- a
                    # thread-parallel strided row gather, nothing
                    # else (one memcpy stream is bound by a single
                    # core's copy bandwidth).
                    self._native.copy_rows(
                        base, off - self._hist_bytes, out,
                        self._new_bytes)
            ts, idx = self._stamps(b0, n, stamp)
            yield ts, idx, out
            b0 += n
            batch_no += 1

    def close(self):
        """Release the mmap / ring deterministically (best-effort).

        Without this, a large file's mapping lives until GC collects
        the pump.  If a consumer still holds zero-copy views over the
        map (``batches_contiguous`` on a regular file), the OS mapping
        survives until those arrays die -- mmap refuses to unmap
        exported buffers -- so closing is safe at any time.  Idempotent;
        also usable as a context manager.
        """
        if self._mm is not None:
            mm, _ = self._mm
            self._mm = None
            try:
                mm.close()
            except BufferError:
                pass  # zero-copy views still alive; GC finishes it
        if self._ring is not None:
            self._ring.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def overflows(self) -> int:
        """Times the producer stalled on a full ring (backpressure)."""
        return 0 if self._ring is None else self._ring.overflows

    def occupancy_histogram(self) -> np.ndarray:
        """8-bucket ring-occupancy histogram sampled at each write."""
        if self._ring is None:
            return np.zeros(8, dtype=np.int64)
        return self._ring.histogram()

    def stats_line(self) -> str:
        if self._ring is None:
            return "mmap ingest (regular file): no ring, one host copy"
        hist = self.occupancy_histogram()
        total = max(int(hist.sum()), 1)
        pct = ", ".join(
            "{:.0f}%".format(100.0 * h / total) for h in hist)
        return ("ring occupancy histogram (1/8 buckets): [{}]; "
                "producer stalls: {}".format(pct, self.overflows))
