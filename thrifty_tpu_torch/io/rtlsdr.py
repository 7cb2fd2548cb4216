"""In-process librtlsdr USB capture source (ctypes binding).

The in-process twin of the reference's rtlsdr reader
(fastcard/rtlsdr_reader.c:60-332), completing the reader family next
to the rtl_tcp network client: librtlsdr's async USB callback thread
produces into a bounded blocking byte ring with occupancy/overflow
accounting (the circbuf role, fastcard/circbuf.c:64-151), and the
consumer side is a file-like ``read``/``readinto`` that StreamPump
(which owns the native overlap-save ring and block timestamps) drains
like any other raw source.

Tuner bring-up mirrors rtlsdr_reader.c:243-294: device count check,
open by index, sample rate, center frequency, manual gain mode,
*nearest supported gain resolved against the device's own gain table*
(rtlsdr_get_tuner_gains -- unlike the rtl_tcp client, which must fall
back to published tables because the protocol only carries a count),
buffer reset; bias tee when the library exports it
(rtlsdr_reader.c:327-332, conditional on LIBRTLSDR_BIAS_TEE_SUPPORT).

Library resolution: ``$THRIFTY_LIBRTLSDR`` (tests point this at a mock
.so), then the usual sonames.  No USB hardware exists in CI, so the
binding is exercised against a replaying mock library
(tests/test_rtlsdr.py).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

from thrifty_tpu_torch.io.rtl_tcp import TUNER_NAMES, nearest_gain

# librtlsdr's defaults for rtlsdr_read_async, as used by the reference
# (fastcard/rtlsdr_reader.c:10-12); ring capacity likewise 32 MiB.
BUF_NUM = 16
BUF_LENGTH = 16 * 16384
RING_BYTES = 16 * 16384 * 128

_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_ubyte),
                             ctypes.c_uint32, ctypes.c_void_p)

_SONAMES = ("librtlsdr.so.2", "librtlsdr.so.0", "librtlsdr.so",
            "librtlsdr.dylib")


def load_library(path=None):
    """Load and prototype librtlsdr; raises OSError when absent.

    Resolution order: explicit ``path`` arg, ``$THRIFTY_LIBRTLSDR``,
    ctypes.util.find_library, then the common sonames.
    """
    candidates = []
    if path:
        candidates.append(path)
    env = os.environ.get("THRIFTY_LIBRTLSDR")
    if env:
        candidates.append(env)
    found = ctypes.util.find_library("rtlsdr")
    if found:
        candidates.append(found)
    candidates.extend(_SONAMES)

    last_err = None
    for cand in candidates:
        try:
            lib = ctypes.CDLL(cand)
            break
        except OSError as e:
            last_err = e
    else:
        raise OSError(
            "librtlsdr not found (tried {}); set THRIFTY_LIBRTLSDR or "
            "install librtlsdr".format(", ".join(candidates))
        ) from last_err

    c = ctypes
    proto = {
        "rtlsdr_get_device_count": (c.c_uint32, []),
        "rtlsdr_get_device_name": (c.c_char_p, [c.c_uint32]),
        "rtlsdr_open": (c.c_int, [c.POINTER(c.c_void_p), c.c_uint32]),
        "rtlsdr_close": (c.c_int, [c.c_void_p]),
        "rtlsdr_set_sample_rate": (c.c_int, [c.c_void_p, c.c_uint32]),
        "rtlsdr_set_center_freq": (c.c_int, [c.c_void_p, c.c_uint32]),
        "rtlsdr_set_tuner_gain_mode": (c.c_int, [c.c_void_p, c.c_int]),
        "rtlsdr_get_tuner_gains": (c.c_int,
                                   [c.c_void_p, c.POINTER(c.c_int)]),
        "rtlsdr_set_tuner_gain": (c.c_int, [c.c_void_p, c.c_int]),
        "rtlsdr_reset_buffer": (c.c_int, [c.c_void_p]),
        "rtlsdr_read_async": (c.c_int, [c.c_void_p, _CALLBACK,
                                        c.c_void_p, c.c_uint32,
                                        c.c_uint32]),
        "rtlsdr_cancel_async": (c.c_int, [c.c_void_p]),
    }
    optional = {
        "rtlsdr_get_tuner_type": (c.c_int, [c.c_void_p]),
        "rtlsdr_set_freq_correction": (c.c_int, [c.c_void_p, c.c_int]),
        "rtlsdr_set_bias_tee": (c.c_int, [c.c_void_p, c.c_int]),
        "rtlsdr_get_tuner_gain": (c.c_int, [c.c_void_p]),
    }
    for name, (res, args) in proto.items():
        fn = getattr(lib, name, None)
        if fn is None:
            # Keep the documented OSError contract even when the
            # resolved .so is some unrelated library, so the CLIs'
            # supervisor-friendly "stream error:" path handles it.
            raise OSError("{} is not librtlsdr (missing symbol {})"
                          .format(getattr(lib, "_name", "library"),
                                  name))
        fn.restype, fn.argtypes = res, args
    for name, (res, args) in optional.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = res, args
    return lib


class ByteRing:
    """Bounded blocking byte queue between the USB callback thread and
    the consumer -- the circbuf role (fastcard/circbuf.c).

    ``put`` BLOCKS the producer when full instead of dropping samples,
    counting the stall as an overflow (circbuf.c semantics: real-time
    margin shows up as backpressure, never as silent data loss), and
    records an occupancy histogram sample per put so the at-exit
    report mirrors rtlsdr_reader_print_histogram
    (rtlsdr_reader.c:310-325).
    """

    HISTOGRAM_BINS = 10

    def __init__(self, capacity=RING_BYTES):
        self.capacity = int(capacity)
        self._chunks = []
        self._size = 0
        self._offset = 0  # consumed prefix of _chunks[0]
        self._cond = threading.Condition()
        self._eof = False
        self._error = None
        self.overflows = 0
        self.histogram = [0] * self.HISTOGRAM_BINS
        self.total_in = 0

    def put(self, data):
        """Producer side; returns False once the ring is shut down."""
        with self._cond:
            bin_idx = min(self._size * self.HISTOGRAM_BINS
                          // self.capacity, self.HISTOGRAM_BINS - 1)
            self.histogram[bin_idx] += 1
            def blocked():
                # A chunk larger than the whole ring is accepted once
                # the ring is empty (soft capacity): waiting for space
                # that can never exist would deadlock both sides.
                return (self._size + len(data) > self.capacity
                        and self._size > 0 and not self._eof)

            if blocked():
                self.overflows += 1
                while blocked():
                    self._cond.wait(0.1)
            if self._eof:
                return False
            self._chunks.append(data)
            self._size += len(data)
            self.total_in += len(data)
            self._cond.notify_all()
            return True

    def readinto(self, b):
        """Consumer side: up to len(b) bytes; 0 = clean end-of-stream.

        Raises IOError when the producer reported an error (the async
        reader exiting prematurely, rtlsdr_reader.c:108-113).
        """
        view = memoryview(b).cast("B")
        with self._cond:
            while self._size == 0 and not self._eof:
                self._cond.wait()
            if self._size == 0 and self._error is not None:
                # Buffered samples drain first (the consumer flushes
                # in-flight data, as capture does on SIGTERM); the
                # error surfaces once the ring is dry.
                raise IOError(self._error)
            n = 0
            want = len(view)
            while n < want and self._size:
                chunk = self._chunks[0]
                avail = len(chunk) - self._offset
                take = min(avail, want - n)
                view[n:n + take] = chunk[self._offset:self._offset + take]
                n += take
                self._size -= take
                if take == avail:
                    self._chunks.pop(0)
                    self._offset = 0
                else:
                    self._offset += take
            self._cond.notify_all()
            return n

    def shutdown(self, error=None):
        """End the stream: wakes both sides; later puts are refused."""
        with self._cond:
            if error is not None and self._error is None:
                self._error = error
            self._eof = True
            self._cond.notify_all()

    def histogram_line(self):
        total = sum(self.histogram) or 1
        cells = " ".join("{:.2f}".format(100.0 * h / total)
                         for h in self.histogram)
        line = "Histogram (%): " + cells
        if self.overflows:
            line += "; ring overflows: {}".format(self.overflows)
        return line


class RtlSdrSource:
    """File-like in-process USB SDR source, StreamPump-ready.

    Same surface as :class:`thrifty_tpu_torch.io.rtl_tcp.RtlTcpSource`
    (``read``/``readinto``/``close``/``describe``), so the capture and
    detect CLIs treat network and USB radios identically; block
    timestamps come from StreamPump at batch formation, the same
    wall-clock convention as the reference's per-block gettimeofday in
    the callback (rtlsdr_reader.c:84-95).
    """

    def __init__(self, device_index=0, frequency=433.83e6,
                 sample_rate=2.4e6, gain_db=0.0, bias_tee=False,
                 freq_correction_ppm=None, lib_path=None,
                 ring_bytes=RING_BYTES, buf_num=BUF_NUM,
                 buf_length=BUF_LENGTH):
        self._lib = load_library(lib_path)
        self.device_index = int(device_index)

        count = self._lib.rtlsdr_get_device_count()
        if count == 0:
            raise IOError("no RTL-SDR devices found")
        if self.device_index >= count:
            raise IOError("RTL-SDR #{} not found ({} device{} present)"
                          .format(self.device_index, count,
                                  "s" if count != 1 else ""))
        name = self._lib.rtlsdr_get_device_name(self.device_index)
        self.device_name = (name or b"").decode("ascii", "replace")

        dev = ctypes.c_void_p()
        if self._lib.rtlsdr_open(ctypes.byref(dev), self.device_index) < 0:
            raise IOError("failed to open RTL-SDR #{}"
                          .format(self.device_index))
        self._dev = dev
        try:
            # Everything between open and a successfully started
            # reader must release the device on failure -- on real
            # hardware a leaked handle keeps the USB interface claimed
            # for the rest of the process.
            self._configure(frequency, sample_rate, gain_db, bias_tee,
                            freq_correction_ppm)
            self._ring = ByteRing(ring_bytes)
            self._buf_num = int(buf_num)
            self._buf_length = int(buf_length)
            self._running = True
            # The ctypes callback object must outlive read_async: bind
            # it to self, not a local.
            self._cb = _CALLBACK(self._on_samples)
            self._thread = threading.Thread(
                target=self._async_routine, name="rtlsdr-async",
                daemon=True)
            self._thread.start()
        except Exception:
            self._running = False
            self._lib.rtlsdr_close(self._dev)
            raise

    # -- tuner bring-up (rtlsdr_reader.c:243-294 order) ----------------
    def _configure(self, frequency, sample_rate, gain_db, bias_tee,
                   freq_correction_ppm):
        lib, dev = self._lib, self._dev
        if lib.rtlsdr_set_sample_rate(dev, int(sample_rate)) < 0:
            raise IOError("failed to set sample rate")
        if lib.rtlsdr_set_center_freq(dev, int(frequency)) < 0:
            raise IOError("failed to set center frequency")
        if freq_correction_ppm is not None:
            fn = getattr(lib, "rtlsdr_set_freq_correction", None)
            if fn is None:
                raise IOError("librtlsdr lacks rtlsdr_set_freq_correction")
            # librtlsdr returns -2 for "already at that value" -- not
            # an error.
            if fn(dev, int(freq_correction_ppm)) not in (0, -2):
                raise IOError("failed to set frequency correction")

        get_type = getattr(lib, "rtlsdr_get_tuner_type", None)
        self.tuner_type = int(get_type(dev)) if get_type else 0
        self.tuner_name = TUNER_NAMES.get(self.tuner_type, "unknown")

        if gain_db is None:
            self.tuner_gain = None  # hardware AGC
            if lib.rtlsdr_set_tuner_gain_mode(dev, 0) < 0:
                raise IOError("failed to enable auto gain")
        else:
            if lib.rtlsdr_set_tuner_gain_mode(dev, 1) < 0:
                raise IOError("failed to enable manual gain")
            gains = self._tuner_gains()
            self.tuner_gain = nearest_gain(int(round(gain_db * 10)),
                                           gains)
            if lib.rtlsdr_set_tuner_gain(dev, self.tuner_gain) != 0:
                raise IOError("failed to set tuner gain")

        if bias_tee:
            fn = getattr(lib, "rtlsdr_set_bias_tee", None)
            if fn is None:
                # The reference compiles the call out when the library
                # predates bias-tee support; asking for power the
                # library cannot switch must fail loudly, not silently
                # leave an LNA dark.
                raise IOError("this librtlsdr has no bias tee support")
            if fn(dev, 1) < 0:
                raise IOError("failed to enable bias tee")
        self.bias_tee = bool(bias_tee)

        if lib.rtlsdr_reset_buffer(dev) < 0:
            import sys
            print("WARNING: failed to reset RTL-SDR buffers",
                  file=sys.stderr)

    def _tuner_gains(self):
        """The device's own gain table, via the count-then-fill
        protocol of rtlsdr_get_tuner_gains (rtlsdr_reader.c:41-46)."""
        count = self._lib.rtlsdr_get_tuner_gains(self._dev, None)
        if count <= 0:
            return ()
        buf = (ctypes.c_int * count)()
        count = self._lib.rtlsdr_get_tuner_gains(self._dev, buf)
        return tuple(buf[:max(count, 0)])

    # -- async producer (rtlsdr_reader.c:60-117) -----------------------
    def _on_samples(self, buf, length, _ctx):
        if not self._running:
            return
        data = ctypes.string_at(buf, length)
        self._ring.put(data)

    def _async_routine(self):
        r = self._lib.rtlsdr_read_async(
            self._dev, self._cb, None, self._buf_num, self._buf_length)
        if self._running:
            # Premature exit: a USB error (r != 0) cancels the stream
            # with an error; r == 0 is the device/mock ending the
            # stream cleanly (EOF for the consumer).
            if r != 0:
                self._ring.shutdown(
                    "rtlsdr_read_async failed (code {})".format(r))
            else:
                self._ring.shutdown()
        else:
            self._ring.shutdown()

    # -- consumer side --------------------------------------------------
    def read(self, n):
        buf = bytearray(n)
        got = self.readinto(buf)
        return bytes(buf[:got])

    def readinto(self, b):
        return self._ring.readinto(b)

    def close(self):
        if not self._running:
            return
        self._running = False
        self._ring.shutdown()
        # A cancel issued before the async thread has entered
        # read_async is LOST (librtlsdr returns -2 without setting the
        # cancel flag), so keep re-cancelling until the thread exits;
        # and never call rtlsdr_close while the thread might still be
        # inside read_async (use-after-free on real hardware) -- if it
        # refuses to die, leak the handle instead.
        deadline = 20
        while self._thread.is_alive() and deadline > 0:
            self._lib.rtlsdr_cancel_async(self._dev)
            self._thread.join(timeout=0.5)
            deadline -= 1
        if self._thread.is_alive():
            import sys
            print("WARNING: rtlsdr async thread did not exit; leaking "
                  "the device handle instead of freeing it under a "
                  "live reader", file=sys.stderr)
            return
        self._lib.rtlsdr_close(self._dev)

    def describe(self):
        gain = ("auto" if self.tuner_gain is None
                else "{:.1f} dB".format(self.tuner_gain / 10.0))
        extra = " bias-tee" if self.bias_tee else ""
        return "rtlsdr #{} ({}): tuner={} gain={}{}".format(
            self.device_index, self.device_name, self.tuner_name, gain,
            extra)

    def stats_line(self):
        """At-exit ring report (rtlsdr_reader.c:310-325)."""
        return self._ring.histogram_line()

    @property
    def overflows(self):
        return self._ring.overflows


def make_source_cli(device_index, config, bias_tee=False, quiet=False,
                    ppm=None, lib_path=None):
    """``RtlSdrSource`` with the CLIs' shared failure convention
    (mirrors rtl_tcp.make_source_cli): returns the source, or ``None``
    after printing ``stream error:`` to stderr."""
    import sys

    try:
        src = RtlSdrSource(
            device_index=device_index, frequency=config.tuner_freq,
            sample_rate=config.sample_rate, gain_db=config.tuner_gain,
            bias_tee=bias_tee, freq_correction_ppm=ppm,
            lib_path=lib_path)
    except (OSError, ValueError) as e:
        print("stream error: {}".format(e), file=sys.stderr)
        return None
    if not quiet:
        print(src.describe(), file=sys.stderr)
    return src
