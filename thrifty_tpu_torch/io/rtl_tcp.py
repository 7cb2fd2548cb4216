"""rtl_tcp network client: a live SDR source for StreamPump.

TPU hosts have no USB SDR attached, so the live front-end speaks the
standard rtl_tcp protocol (librtlsdr's network server, the lingua
franca of SDR-over-TCP): the radio runs wherever the antenna is and
the detector host pulls the raw uint8 I/Q stream over the network.
This replaces the reference's in-process librtlsdr binding
(fastcard/rtlsdr_reader.c:201-297) hardware-for-hardware:

  rtlsdr_open / set_sample_rate / set_center_freq /
  set_tuner_gain_mode(1) / nearest_gain + set_tuner_gain /
  reset_buffer            (rtlsdr_reader.c:253-291)
      -> the same sequence as rtl_tcp SET_* commands on connect,
  rtlsdr_set_bias_tee     (rtlsdr_reader.c:327-332) -> SET_BIAS_TEE,
  async USB callback + ring (rtlsdr_reader.c:60-117)
      -> the TCP socket feeds io.stream.StreamPump's reader thread,
         which owns the native ring buffer.

Protocol (librtlsdr src/rtl_tcp.c): on accept the server sends a
12-byte banner -- magic ``RTL0``, big-endian u32 tuner type, u32 gain
count -- then an endless uint8 interleaved I/Q stream; the client
sends 5-byte commands (u8 opcode + u32 big-endian argument).

Gain selection reproduces convenience.c's nearest_gain (vendored at
rtlsdr_reader.c:38-57): the server's banner does not carry the gain
*values*, so the client resolves "nearest supported gain" against the
published gain table of the advertised tuner model.
"""

from __future__ import annotations

import socket
import struct

# Command opcodes (librtlsdr src/rtl_tcp.c command handler).
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03  # 0 = auto, 1 = manual
CMD_SET_GAIN = 0x04       # tenths of a dB
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_GAIN_BY_INDEX = 0x0d
CMD_SET_BIAS_TEE = 0x0e

TUNER_NAMES = {0: "unknown", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}

# Published tuner gain tables, in tenths of a dB (librtlsdr
# src/tuner_*.c via rtlsdr_get_tuner_gains); R828D shares the R820T
# table.  Used for nearest-gain resolution since rtl_tcp's banner only
# carries the count.
_R820T_GAINS = (0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
                229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
                434, 439, 445, 480, 496)
TUNER_GAINS = {
    1: (-10, 15, 40, 65, 90, 115, 140, 165, 190, 215, 240, 290, 340, 420),
    2: (-99, -40, 71, 179, 192),
    3: (-99, -73, -65, -63, -60, -58, -54, 58, 61, 63, 65, 67, 68, 70,
        71, 179, 181, 182, 184, 186, 188, 191, 197),
    4: (0,),
    5: _R820T_GAINS,
    6: _R820T_GAINS,
}


def nearest_gain(target_tenth_db, gains):
    """Nearest supported gain, first-wins on ties.

    Same scan as the reference's vendored convenience.c helper
    (fastcard/rtlsdr_reader.c:38-57): linear pass keeping the current
    candidate unless a strictly closer gain appears, so an exact
    midpoint resolves to the earlier (lower) table entry.
    """
    gains = list(gains)
    if not gains:
        return 0
    best = gains[0]
    for g in gains:
        if abs(target_tenth_db - g) < abs(target_tenth_db - best):
            best = g
    return best


def parse_hostport(text, default_port=1234):
    """'host[:port]' -> (host, port).

    IPv6 literals use the standard bracket syntax (``[::1]:1234`` or
    ``[::1]``); a bare string with multiple colons and no bracket is
    treated as an IPv6 host with the default port.  Raises ValueError
    (with a readable message) on a malformed port.
    """
    if text.startswith("["):
        host, sep, rest = text[1:].partition("]")
        if not sep or (rest and not rest.startswith(":")):
            raise ValueError("malformed rtl_tcp address: {!r}".format(text))
        if not rest or rest == ":":
            return host, default_port
        port = rest[1:]
    else:
        host, sep, port = text.rpartition(":")
        if not sep:
            return text, default_port
        if ":" in host:  # bare IPv6 literal, no port
            return text, default_port
    try:
        return host, int(port)
    except ValueError:
        raise ValueError("bad rtl_tcp port in {!r}".format(text)) from None


def make_source_cli(hostport, config, bias_tee=False, reconnect=0,
                    quiet=False, ppm=None):
    """``make_source`` with the CLIs' shared failure convention.

    Returns the source, or ``None`` after printing ``stream error:``
    to stderr -- the same supervisor-friendly path as a mid-stream
    failure, so a dead radio host at startup exits 1 without a
    traceback (used by detect/capture/scope).
    """
    import sys

    try:
        src = make_source(hostport, config, bias_tee=bias_tee,
                          reconnect=reconnect, ppm=ppm)
    except (OSError, ValueError) as e:
        # ValueError: malformed host:port on the command line -- same
        # supervisor-friendly exit as an unreachable radio.
        print("stream error: {}".format(e), file=sys.stderr)
        return None
    if not quiet:
        print(src.describe(), file=sys.stderr)
    return src


def make_source(hostport, config, bias_tee=False, reconnect=0,
                ppm=None):
    """Build the rtl_tcp source a CLI asked for.

    Shared by the detect / capture / scope entry points so the tuner
    configuration (from the settings registry) and the
    reconnect-vs-plain choice live in one place.  ``ppm``: crystal
    frequency correction forwarded to the dongle
    (SET_FREQ_CORRECTION; librtlsdr's rtlsdr_set_freq_correction).
    """
    host, port = parse_hostport(hostport)
    kwargs = dict(frequency=config.tuner_freq,
                  sample_rate=config.sample_rate,
                  gain_db=config.tuner_gain, bias_tee=bias_tee,
                  freq_correction_ppm=ppm)
    if reconnect:
        return ReconnectingRtlTcpSource(host, port,
                                        max_retries=reconnect, **kwargs)
    return RtlTcpSource(host, port, **kwargs)


class RtlTcpSource:
    """File-like rtl_tcp client (``read``/``close``), StreamPump-ready.

    Configures the remote dongle on connect with the reference's init
    sequence (rtlsdr_reader.c:253-291): sample rate, center frequency,
    then either manual gain mode + nearest supported gain, or
    auto-gain when ``gain_db`` is None.
    """

    def __init__(self, host, port=1234, frequency=433.83e6,
                 sample_rate=2.4e6, gain_db=0.0, bias_tee=False,
                 freq_correction_ppm=None, timeout=10.0,
                 stream_timeout=30.0):
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        banner = self._recv_exact(12)
        if banner[:4] != b"RTL0":
            self._sock.close()
            raise IOError("not an rtl_tcp server (bad magic {!r})"
                          .format(banner[:4]))
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", banner[4:])
        self.tuner_name = TUNER_NAMES.get(self.tuner_type, "unknown")

        self._cmd(CMD_SET_SAMPLE_RATE, int(sample_rate))
        self._cmd(CMD_SET_FREQ, int(frequency))
        if freq_correction_ppm is not None:
            self._cmd(CMD_SET_FREQ_CORRECTION,
                      int(freq_correction_ppm))
        if gain_db is None:
            self.tuner_gain = None  # hardware AGC
            self._cmd(CMD_SET_GAIN_MODE, 0)
        else:
            self._cmd(CMD_SET_GAIN_MODE, 1)
            gains = TUNER_GAINS.get(self.tuner_type, ())
            self.tuner_gain = nearest_gain(int(round(gain_db * 10)),
                                           gains)
            self._cmd(CMD_SET_GAIN, self.tuner_gain)
        if bias_tee:
            self._cmd(CMD_SET_BIAS_TEE, 1)
        # The handshake timeout must not govern streaming, but blocking
        # forever would turn a half-open connection (peer power-cut, NAT
        # entry dropped -- no FIN/RST ever arrives) into a silent hang.
        # An SDR stream is continuous (~2 x sample_rate bytes/s), so ANY
        # multi-second silence is a dead transport: surface it as an
        # IOError that the reconnect wrapper or the CLI can act on.
        self._sock.settimeout(stream_timeout)

    def _cmd(self, opcode, arg):
        # u32 wraps negative arguments (e.g. negative tenth-dB gains)
        # exactly like the C server reads them back.
        self._sock.sendall(struct.pack(">BI", opcode, arg & 0xFFFFFFFF))

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise IOError("rtl_tcp server closed during handshake")
            buf += chunk
        return buf

    def read(self, n):
        """Up to ``n`` bytes of raw interleaved uint8 I/Q.

        Returns ``b""`` only on clean end-of-stream (server FIN).  A
        network failure raises: truncation must be distinguishable
        from a completed capture, so callers can exit non-zero or
        reconnect instead of silently losing data.
        """
        try:
            return self._sock.recv(n)
        except socket.timeout as e:
            raise IOError("rtl_tcp stream stalled (no data for "
                          "stream_timeout; dead transport?)") from e
        except (ConnectionResetError, BrokenPipeError) as e:
            raise IOError("rtl_tcp stream failed: {}".format(e)) from e

    def readinto(self, b):
        """Receive directly into a writable buffer (StreamPump hands
        us a span inside ring memory, so samples go kernel -> ring
        with no intermediate bytes object).  Returns bytes received
        (0 only on clean end-of-stream); same error mapping as
        :meth:`read`."""
        try:
            return self._sock.recv_into(b)
        except socket.timeout as e:
            raise IOError("rtl_tcp stream stalled (no data for "
                          "stream_timeout; dead transport?)") from e
        except (ConnectionResetError, BrokenPipeError) as e:
            raise IOError("rtl_tcp stream failed: {}".format(e)) from e

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def describe(self):
        gain = ("auto" if self.tuner_gain is None
                else "{:.1f} dB".format(self.tuner_gain / 10.0))
        return "rtl_tcp: tuner={} gains={} gain={}".format(
            self.tuner_name, self.tuner_gain_count, gain)


class ReconnectingRtlTcpSource:
    """RtlTcpSource that survives server restarts.

    On a mid-stream failure OR a clean server close it reconnects with
    exponential backoff (re-sending the full tuner configuration) and
    resumes the byte stream.  Samples lost while disconnected simply
    never appear -- block timestamps come from the wall clock, so the
    downstream matchmaker keeps working, exactly as if the SDR had
    been unplugged and replugged.  Gives the networked front-end the
    resilience the reference gets from systemd restarting the whole
    node (rpi/detector.service).

    ``max_retries`` bounds consecutive connection cycles that deliver
    no samples -- whether the connect itself fails OR it succeeds and
    the stream EOFs before producing data (a server in a crash loop
    completes the handshake, then dies; counting only failed connects
    would retry such a server forever at full speed).  The budget
    resets only when a connection actually delivers samples.  When it
    is exhausted, ``read`` raises IOError -- a live SDR stream has no
    legitimate end, so truncation must stay distinguishable from a
    completed capture (same invariant as :meth:`RtlTcpSource.read`),
    letting the CLI exit non-zero.
    """

    def __init__(self, host, port=1234, max_retries=6,
                 initial_backoff_s=0.5, **kwargs):
        self._addr = (host, port)
        self._kwargs = kwargs
        self._max_retries = max_retries
        self._backoff = initial_backoff_s
        # Delivered-byte parity: the consumer pairs I/Q bytes by
        # absolute stream offset, so a session that dies after an odd
        # byte count would swap I<->Q for the rest of the run if the
        # next session's bytes were appended directly.
        self._parity = 0
        self.reconnects = 0
        self._closed = False
        self._src = self._connect_initial()

    def _connect_initial(self):
        """First connect, under the same retry/backoff budget as
        mid-stream reconnects.

        At boot the radio host comes up independently of the detector
        host (deploy/detect.sh networked mode), so "connection
        refused" for a while is the normal case; without this, systemd
        Restart= turns the window into a tight restart loop that
        hammers the radio server.
        """
        import time

        delay = self._backoff
        last_err = None
        for attempt in range(self._max_retries + 1):
            if attempt:
                time.sleep(delay)
                delay = min(delay * 2, 30.0)
            try:
                return RtlTcpSource(*self._addr, **self._kwargs)
            except OSError as err:
                last_err = err
        raise IOError(
            "rtl_tcp connect failed after {} attempts"
            .format(self._max_retries + 1)) from last_err

    def read(self, n):
        buf = bytearray(n)
        got = self.readinto(buf)
        return bytes(buf[:got])

    def readinto(self, b):
        """Receive into a writable buffer, reconnecting as needed
        (StreamPump hands us a span inside ring memory, so the fast
        path is kernel -> ring with no intermediate bytes object)."""
        import time

        attempts = 0       # consecutive no-data connection cycles
        delay = self._backoff
        last_err = None
        while True:
            if self._closed:
                # close() was called (possibly from another thread
                # while we were blocked in recv): report end-of-stream
                # instead of "reconnecting" to a radio the caller just
                # asked us to release.
                raise IOError("rtl_tcp source is closed")
            src = self._src
            if src is not None:
                try:
                    n = src.readinto(b)
                    if n:
                        self._parity ^= n & 1
                        return n
                except IOError as err:
                    if self._closed:
                        raise IOError("rtl_tcp source is closed") from None
                    last_err = err
                src.close()
                self._src = None
            if attempts >= self._max_retries:
                # Chain the root cause so the operator can tell a
                # stream stall from a handshake failure at the CLI's
                # "stream error:" report.
                raise IOError(
                    "rtl_tcp reconnect failed after {} attempts"
                    .format(self._max_retries)) from last_err
            attempts += 1
            if attempts > 1:
                # First reconnect is immediate (a long-healthy link
                # dropping once should not stall the stream); repeat
                # failures back off exponentially.
                time.sleep(delay)
                delay = min(delay * 2, 30.0)
            try:
                self._src = RtlTcpSource(*self._addr, **self._kwargs)
                self.reconnects += 1
            except OSError as err:
                last_err = err
                self._src = None
                continue
            if self._parity:
                # The dead session delivered an odd byte count (TCP
                # hands over whatever was buffered; no 2-byte
                # alignment guarantee).  Pad one neutral byte
                # (128 = zero amplitude) so the new session's first I
                # byte lands on an even stream offset and I/Q pairing
                # survives the splice.
                self._parity = 0
                b[0:1] = b"\x80"
                return 1

    def close(self):
        # Mark closed FIRST: a reader thread blocked in recv wakes with
        # an OSError from the socket teardown and must see the flag
        # before deciding to reconnect.
        self._closed = True
        if self._src is not None:
            self._src.close()
            self._src = None

    def describe(self):
        if self._src is None:
            return "rtl_tcp {}:{} (disconnected)".format(*self._addr)
        return self._src.describe() + " (auto-reconnect)"

    @property
    def tuner_gain(self):
        return None if self._src is None else self._src.tuner_gain

    @property
    def tuner_name(self):
        return None if self._src is None else self._src.tuner_name
