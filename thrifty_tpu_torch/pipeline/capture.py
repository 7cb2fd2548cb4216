"""CLI: capture -- raw IQ stream -> carrier-gated .card archive, on PyTorch.

Counterpart of ``thrifty_tpu.pipeline.capture`` (fastcard's job,
reference fastcard/fastcard_cli.c:156-196): run the carrier threshold
detector over every overlap-save block of a raw uint8 I/Q stream and
archive only the blocks that pass as base64 ``.card`` lines.

Blocks are gated a batch [B, N] at a time by :class:`CarrierGate`: the
uint8 -> complex64 conversion and a full FFT on the device, then one
launch of the fused power/peak reduction (``csrc/power_peak.cu`` on a
CUDA card) for the windowed carrier peak and the spectrum energy.  Under
``--fft-impl matmul``/``matmul3`` the gate is a DFT at the carrier
window's bins instead (``carrier.detect_windowed``: GEMMs, its argmax
as torch ops, no kernel launch).  Only the verdicts and peak statistics
come back to the host.  With
``--device-unfold`` the host uploads only the stream's new bytes, the
overlap-save rows are built on the device, and the host rebuilds just
the hit rows it archives.

Without ``--raw-in``/``--rtl-tcp``/``--rtlsdr`` an external SDR capture
binary is spawned instead (``--capture-cmd``, reference
thrifty/fastcard_capture.py:35-93).  A stddev threshold term d*var(|X|)
over all N bins comes from the same launch (the reduction's magnitude
sums with an all-true stats mask).
"""

from __future__ import annotations

import argparse
import shlex
import signal
import subprocess
import sys
import time as time_mod

import numpy as np
import torch

from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.config.parsers import normalize_freq_range
from thrifty_tpu_torch.device import DEVICES, as_device, resolve_device
from thrifty_tpu_torch.dsp import carrier, iq, mxu_fft, power_peak, \
    unfold, xcorr
from thrifty_tpu_torch.io import card as card_io
from thrifty_tpu_torch.io.stream import StreamPump
from thrifty_tpu_torch.pipeline.host import PinnedUpload, open_source


class CarrierGate:
    """Batched carrier-threshold gate: raw uint8 [B, 2N] -> verdicts.

    Per block (fastcard/cardet.c:7-41 semantics): FFT, windowed argmax
    of the power and the spectrum energy in one power/peak reduction,
    then the signed-variance noise and threshold of
    ``carrier.noise_and_threshold_sq``; a stddev term d adds
    d*var(|X|) from the same launch's magnitude sums (JAX computes
    ``jnp.var(mag)``, thrifty_tpu/pipeline/capture.py:90-99).  The
    transform is ``mxu_fft.fft(fft_impl, fft_precision)``; under a matmul
    impl without a stddev term the gate is the windowed carrier DFT
    instead (``carrier.windowed_selection``/``detect_windowed``, shared
    with the detector).  Returns tensors on the gate's device: (detected
    bool, argmax int32, magnitude, noise, threshold).
    """

    def __init__(self, block_len, carrier_window, carrier_thresh,
                 history_len=None, fft_impl="auto", fft_precision="highest",
                 device="cuda"):
        mxu_fft._use_matmul(fft_impl)
        mxu_fft._resolve_precision(fft_precision)
        self.block_len = block_len
        self.history_len = history_len  # needed for gate_stream only
        self.device = as_device(device)
        self._mask = power_peak.Mask(
            carrier.window_mask(carrier_window, block_len), self.device)
        self._thresh = tuple(carrier_thresh)
        self._fft_impl = fft_impl
        self._fft_precision = fft_precision
        self._stats = (power_peak.Mask(np.ones(block_len, bool), self.device)
                       if self._thresh[2] else None)
        self._win = carrier.windowed_selection(
            carrier_window, self._thresh, block_len, fft_impl)
        if self._win is not None:
            self._win_sel = torch.tensor(self._win[0].astype(np.int64),
                                         device=self.device)
        self._stream = None

    def _detect_blocks(self, blocks):
        if self._win is not None:
            det, idx, mag, noise, thresh_sq, _, _ = carrier.detect_windowed(
                blocks, self._win_sel, self._win[1], 0, self._thresh,
                self._fft_impl, self._fft_precision)
            return det, idx, mag, noise, torch.sqrt(
                torch.clamp(thresh_sq, min=0.0))
        fft = mxu_fft.fft(blocks, self._fft_impl, self._fft_precision)
        out = power_peak.fused_power_peak(fft, self._mask,
                                          stats_mask=self._stats)
        idx, peak_pow, energy = out[:3]
        mag = torch.sqrt(peak_pow)
        noise, thresh_sq = carrier.noise_and_threshold_sq(
            energy, peak_pow, self.block_len, self._thresh)
        if self._stats is not None:
            thresh_sq = thresh_sq + self._thresh[2] * xcorr.var_from_stats(
                out[3], out[4], self.block_len)
        # Report the DECISION threshold, from the signed variance (an
        # ultra-strong carrier drives it negative; rebuilding it from
        # the clamped noise would print a threshold above the magnitude
        # of a block that WAS detected).
        thresh = torch.sqrt(torch.clamp(thresh_sq, min=0.0))
        return mag > thresh, idx, mag, noise, thresh

    def _program_stream(self, new_u8, carry):
        rows, carry = unfold.unfold_stream(new_u8, carry, self.block_len,
                                           self.history_len)
        return self._detect_blocks(iq.raw_to_iq(rows)), carry

    def __call__(self, raw):
        """Gate raw uint8 interleaved I/Q [B, 2N] (tensor or numpy)."""
        raw = torch.as_tensor(raw).to(self.device)
        if raw.dim() != 2 or raw.shape[1] != 2 * self.block_len:
            raise ValueError("raw must be uint8 [B, {}]".format(
                2 * self.block_len))
        return self._detect_blocks(iq.raw_to_iq(raw))

    def gate_stream(self, new_raw):
        """Gate CONTIGUOUS raw stream bytes uint8 [B*2*new_len]; the
        overlap-save unfold runs on the device against a carry kept
        there (pre-stream history: 0x80 zero-signal bytes), with the
        detector's own carry protocol (``dsp.unfold.StreamCarry``)."""
        if self.history_len is None:
            raise ValueError("gate_stream needs history_len")
        if self._stream is None:
            self._stream = unfold.StreamCarry(self.history_len, self.device)
        return self._stream.call(self._program_stream, new_raw,
                                 new_len=self.block_len - self.history_len)

    def reset_stream(self):
        """Reset the :meth:`gate_stream` carry to the pre-stream state."""
        if self._stream is not None:
            self._stream.reset()


def card_header(config, window, tool="thrifty-tpu capture", sdr=False,
                t0=None):
    """Reference-format .card header (fastcard/fargs.c:194-214).

    ``t0``: deterministic stream start time; when given it is used as
    start_time instead of the wall clock, so re-recording the same
    stream yields byte-identical archives.
    """
    c, s, _ = config.carrier_threshold
    lines = [
        "arguments: {{ carrier_bin: '{}-{}', threshold: '{:g}c+{:g}s', "
        "block_size: {}, history_size: {} }}".format(
            window[0], window[1], c, s,
            config.block_size, config.block_history),
    ]
    if sdr:
        lines.append("tuner: {{ freq: {}; sample_rate: {}; gain: {} }}"
                     .format(int(config.tuner_freq),
                             int(config.sample_rate), config.tuner_gain))
    lines.append("tool: '{}'".format(tool))
    lines.append("start_time: {:.6f}".format(
        time_mod.time() if t0 is None else t0))
    return "\n".join(lines)


def record_cards(gate, batches, batch_size, out_stream, info_out=None,
                 skip=0, stats=None, device_unfold=False):
    """Drive the gate over raw batches, writing .card lines for hits.

    ``batches`` yields (timestamps [b], indices [b], raw [b, 2N]), or
    with ``device_unfold`` (timestamps, indices, new stream bytes
    [b*2*new_len]).  The first ``skip`` blocks are discarded and the
    survivors RENUMBERED from 0 (the reference starts its block counter
    at ``-skip - 1``, fastcard.c:108-109).  One batch stays in flight,
    uploaded through :class:`PinnedUpload`.  Returns (blocks_read,
    blocks_written); a ``stats`` dict holds the running counts even when
    the stream dies mid-run.
    """
    upload = PinnedUpload(gate.device)
    pending = []
    if stats is None:
        stats = {}
    stats.update(read=0, written=0)
    if device_unfold:
        from numpy.lib.stride_tricks import as_strided

        hist_bytes = 2 * gate.history_len
        new_bytes = 2 * (gate.block_len - gate.history_len)
        # Host-side tail of the previous batch: only HIT rows are
        # materialized, cut out of [prev_tail | new bytes].
        host_tail = np.full(hist_bytes, 128, np.uint8)

    def drain(entry):
        ts, idx, n, raw, tail, dev = entry
        det, amax, mag, noise, thr = (a.cpu().numpy()[:n] for a in dev)
        keep = det & (idx >= skip)
        idx = idx - skip
        stats["read"] += n
        if info_out is not None:
            for i in np.nonzero(keep)[0]:
                print("block #{}: mag[{}] = {:.1f} (thresh = {:.1f}, "
                      "noise = {:.1f})".format(
                          int(idx[i]), int(amax[i]), float(mag[i]),
                          float(thr[i]), float(noise[i])), file=info_out)
        if np.any(keep):
            if device_unfold:
                full = np.concatenate([tail, raw[:n * new_bytes]])
                rows = as_strided(
                    full, (n, hist_bytes + new_bytes), (new_bytes, 1))
                rows = rows[keep]  # fancy index copies the hit rows
            else:
                rows = raw[:n][keep]
            card_io.write_card(out_stream, ts[keep], idx[keep], rows)
            out_stream.flush()
            stats["written"] += int(np.count_nonzero(keep))

    try:
        for ts, idx, raw in batches:
            n = len(ts)
            if n == 0:
                continue
            if device_unfold:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n) * new_bytes,
                                      128, np.uint8)])
                dev = gate.gate_stream(upload(raw))
                # raw stays valid while <= BUF_POOL-1 further batches
                # are drawn (StreamPump contract); pending holds one.
                valid = raw[:n * new_bytes]
                prev_tail, host_tail = host_tail, (
                    valid[-hist_bytes:].copy()
                    if len(valid) >= hist_bytes else np.concatenate(
                        [host_tail, valid])[-hist_bytes:])
                pending.append((ts, idx, n, valid, prev_tail, dev))
            else:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n, raw.shape[1]), 128,
                                      np.uint8)])
                dev = gate(upload(raw))
                pending.append((ts, idx, n, raw, None, dev))
            if len(pending) > 1:
                drain(pending.pop(0))
    except (IOError, KeyboardInterrupt):
        # The stream died or SIGTERM/SIGINT arrived: gated blocks
        # already in flight still reach the archive before the
        # exception surfaces.
        while pending:
            drain(pending.pop(0))
        raise
    while pending:
        drain(pending.pop(0))
    return stats["read"], stats["written"]


def build_args(config, output=None):
    """Translate settings into fastcard-style CLI flags."""
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    thresh_c, thresh_s, thresh_d = config.carrier_threshold
    if thresh_d:
        print("warning: stddev threshold not supported by capture backends",
              file=sys.stderr)
    args = [
        "-i", "rtlsdr",
        "-s", str(config.sample_rate),
        "-f", str(config.tuner_freq),
        "-g", str(config.tuner_gain),
        "-b", str(config.block_size),
        "-h", str(config.block_history),
        "-w", "{}-{}".format(window[0], window[1]),
        "-t", "{}c{}s".format(thresh_c, thresh_s),
        "-k", str(config.capture_skip),
    ]
    if output:
        args += ["-o", output]
    return args


def _record_main(config, args):
    """The carrier-gated raw -> .card recorder."""
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    gate = CarrierGate(config.block_size, window, config.carrier_threshold,
                       history_len=config.block_history,
                       fft_impl=args.fft_impl,
                       device=resolve_device(args.device))

    in_stream = open_source(args, config, args.raw_in)
    if in_stream is None:
        return 1
    sdr = args.raw_in is None
    if args.output and args.output != "-":
        out_stream, close_out = open(args.output, "w"), True
    else:
        out_stream, close_out = sys.stdout, False
    info_out = sys.stderr if out_stream is sys.stdout else sys.stdout
    if args.quiet:
        info_out = None

    out_stream.write("# " + card_header(config, window, sdr=sdr,
                                        t0=args.t0).replace(
        "\n", "\n# ") + "\n")

    pump = StreamPump(in_stream, config.block_size, config.block_history,
                      config.batch_size, sample_rate=config.sample_rate,
                      t0=args.t0)
    batches = (pump.batches_contiguous() if args.device_unfold
               else pump.batches())

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread

    exit_code = 0
    t_start = time_mod.perf_counter()
    stats = {"read": 0, "written": 0}
    try:
        record_cards(
            gate, batches, config.batch_size, out_stream,
            info_out=info_out, skip=config.capture_skip, stats=stats,
            device_unfold=args.device_unfold)
    except KeyboardInterrupt:
        print("interrupted; output flushed", file=sys.stderr)
    except IOError as e:
        # Live stream died (e.g. rtl_tcp reconnect retries exhausted):
        # flush, report, exit non-zero so a supervisor restarts us.
        print("stream error: {}; output flushed".format(e),
              file=sys.stderr)
        exit_code = 1
    finally:
        if close_out:
            out_stream.close()
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
    elapsed = time_mod.perf_counter() - t_start
    if info_out is not None:
        new_len = config.block_size - config.block_history
        rate = stats["read"] * new_len / max(elapsed, 1e-9)
        print("\nRead {} blocks, wrote {} ({:.3g} IQ samples/s = {:.1f}x "
              "realtime @ {:.1f} Msps) on {}".format(
                  stats["read"], stats["written"], rate,
                  rate / config.sample_rate, config.sample_rate / 1e6,
                  gate.device), file=info_out)
        print(pump.stats_line(), file=info_out)
        if hasattr(in_stream, "stats_line"):
            # USB ring report (rtlsdr_reader.c:310-325).
            print(in_stream.stats_line(), file=info_out)
    pump.close()
    return exit_code


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--raw-in", type=str, default=None,
                        help="raw interleaved uint8 I/Q stream to gate "
                             "('-' for stdin); without this or a live "
                             "source, an external capture binary is "
                             "spawned")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="output .card file ('-'/default: stdout in "
                             "--raw-in mode)")
    parser.add_argument("--device-unfold", action="store_true",
                        help="carrier-gate the contiguous stream with "
                             "the overlap-save unfold on the device; "
                             "only HIT rows are materialized on the host")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-block detection lines")
    parser.add_argument("--t0", type=float, default=None,
                        help="stamp blocks deterministically as "
                             "t0 + block_idx*block_dt instead of the "
                             "wall clock")
    parser.add_argument("--rtl-tcp", type=str, default=None,
                        metavar="HOST[:PORT]",
                        help="capture live from an rtl_tcp server "
                             "(configures freq/sample-rate/gain on "
                             "connect)")
    parser.add_argument("--rtlsdr", type=int, default=None, metavar="N",
                        help="capture live from USB RTL-SDR device N via "
                             "the in-process librtlsdr binding")
    parser.add_argument("--ppm", type=int, default=None,
                        help="crystal frequency correction in ppm "
                             "forwarded to the dongle")
    parser.add_argument("--bias-tee", action="store_true",
                        help="with --rtl-tcp/--rtlsdr: enable the dongle's "
                             "bias tee (antenna power)")
    parser.add_argument("--reconnect", type=int, default=0, metavar="N",
                        help="with --rtl-tcp: survive server restarts, "
                             "retrying up to N times with exponential "
                             "backoff [default: 0 = exit on disconnect]")
    parser.add_argument("--fft-impl", type=str, default="auto",
                        choices=list(mxu_fft.IMPLS),
                        help="transform of the carrier gate (dsp/mxu_fft.py):"
                             " 'auto'/'xla' = torch.fft (cuFFT on the card) "
                             "and the power/peak kernel; 'matmul'/'matmul3' "
                             "= the windowed carrier DFT as GEMMs (full "
                             "matmul FFT with a stddev term) "
                             "[default: auto]")
    parser.add_argument("--capture-cmd", type=str, default="fastcard",
                        help="capture binary to spawn [default: fastcard]")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES),
                        help="where the gate runs; 'cuda' fails when no "
                             "card is available [default: cuda]")
    keys = ["sample_rate", "tuner_freq", "tuner_gain", "block_size",
            "block_history", "carrier_window", "carrier_threshold",
            "capture_skip", "batch_size"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    given = [o for o, v in (("--raw-in", args.raw_in),
                            ("--rtl-tcp", args.rtl_tcp),
                            ("--rtlsdr", args.rtlsdr)) if v is not None]
    if len(given) > 1:
        parser.error("give only one of {}".format(" / ".join(given)))
    if given:
        return _record_main(config, args)

    cmd = shlex.split(args.capture_cmd) + build_args(config, args.output)
    print("capture:", " ".join(cmd), file=sys.stderr)
    try:
        proc = subprocess.Popen(cmd)
    except FileNotFoundError:
        print("error: capture binary {!r} not found (SDR capture requires "
              "external hardware support)".format(cmd[0]), file=sys.stderr)
        return 1

    def forward(signum, frame):
        proc.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGINT, forward)
    signal.signal(signal.SIGTERM, forward)
    return proc.wait()


if __name__ == "__main__":
    sys.exit(_main())
