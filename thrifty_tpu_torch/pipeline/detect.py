"""Streaming detect loop + CLI on PyTorch: .card / raw IQ -> .toad.

Counterpart of ``thrifty_tpu.pipeline.detect``: the same config keys,
the same .toad output and the same per-block summary lines
(reference thrifty/detect.py:161-223), plus ``--device {cuda,cpu}``.
The host reads fixed-size batches of raw uint8 blocks, copies each into
one of two pinned buffers, sends it to the card with a non-blocking
copy and queues the detect program; one batch stays in flight, so host
decoding of batch k+1 overlaps the card's work on batch k.  Batches
are padded to a fixed shape with zero-signal bytes and the padding is
dropped from the output.

Inputs: a .card file, a raw uint8 I/Q stream (``--raw``, host unfold,
or ``--device-unfold``: only the stream's new bytes are uploaded and
the overlap-save rows are built on the device), or a live SDR
(``--rtl-tcp``, ``--rtlsdr``).  ``--gate-capacity`` runs the
correlation on the carrier-positive blocks only; the config key
``sync_mode`` picks fractional, integer (fastdet's numerics) or
preshift sync.  ``--corr-interp``, ``--carrier-interp`` and
``--peak-filter`` are the JAX CLI's; a 2-D [T, L] template file is a
code-division bank, and ``--emit-txid`` writes its winning template as
the txid.  The JAX CLI's TPU knobs (``--pallas``, ``--fft-impl``,
``--fft-precision``, ``--carrier-fast``, ``--carrier-precision``,
``--ramp-fast``) have no counterpart here.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.config.parsers import normalize_freq_range
from thrifty_tpu_torch.device import DEVICES, resolve_device
from thrifty_tpu_torch.dsp import util
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu_torch.io import card, toad
from thrifty_tpu_torch.io import tpl as tpl_io
from thrifty_tpu_torch.io.stream import StreamPump, prefetch_iter
from thrifty_tpu_torch.pipeline.host import PinnedUpload, open_source


class SummaryFormatter:
    """One-line per-block summary (reference thrifty/detect.py:103-158)."""

    def __init__(self, sample_rate, block_len):
        self.sample_rate = sample_rate
        self.block_len = block_len

    def __call__(self, block_idx, out, i):
        bin_idx = int(out["carrier_bin"][i])
        offset = float(out["carrier_offset"][i])
        freq = (util.fft_bin(bin_idx, self.block_len) + offset) \
            * self.sample_rate / self.block_len
        carrier_det = bool(out["carrier_detect"][i])
        snr = util.snr_db(float(out["carrier_energy"][i]),
                          float(out["carrier_noise"][i]))
        line = ("blk={blk}; carrier: {det} @ {freq:.3f} kHz"
                " / {idx:>3.0f}:{off:+.2f}, "
                "SNR = {ampl:>4.0f} / {noise:>2.0f} = {snr:>5.2f} dB"
                .format(blk=block_idx, det="yes" if carrier_det else "no ",
                        freq=freq / 1e3, idx=bin_idx, off=offset,
                        ampl=float(out["carrier_energy"][i]),
                        noise=float(out["carrier_noise"][i]), snr=snr))
        if carrier_det:
            det = bool(out["detected"][i])
            snr = util.snr_db(float(out["corr_energy"][i]),
                              float(out["corr_noise"][i]))
            line += ("; corr: {det} @ {idx:>4}{off:+.3f}"
                     ", SNR = {ampl:>4.0f}/{noise:>2.0f} = {snr:>5.2f} dB"
                     .format(det="yes" if det else "no ",
                             idx=int(out["corr_sample"][i]),
                             off=float(out["corr_offset"][i]),
                             ampl=float(out["corr_energy"][i]),
                             noise=float(out["corr_noise"][i]), snr=snr))
        return line


def detect_batches(detector, batches, batch_size, rxid=-1,
                   summary=None, summary_out=None,
                   txid_from_template=False, card_out=None,
                   device_unfold=False):
    """Run the detector over an iterator of (ts, idx, raw) batches.

    Yields detection record arrays (toad.DETECTION_DTYPE) per batch.
    Batches shorter than ``batch_size`` are padded with byte 128 (zero
    signal) and the padded rows are dropped.  ``txid_from_template``
    writes a bank's winning template as the txid.  ``card_out``: optional
    stream teeing the raw bytes of corr-detected blocks as .card lines
    (reference fastdet/fastdet.cpp:210-219).
    ``device_unfold``: batches carry CONTIGUOUS new stream bytes
    ([n*2*new_len], from ``StreamPump.batches_contiguous``) and the
    overlap-save unfold runs on the device against a carry kept there
    (``detector.submit_raw_stream``); incompatible with ``card_out``
    (the rows never exist on the host).

    Each batch is uploaded through :class:`PinnedUpload` and queued; a
    batch is drained (its :class:`PendingBatch` resolved, which re-runs
    an overflowed gated batch in full, and its outputs copied back) only
    after the next one has been queued.
    """
    if device_unfold and card_out is not None:
        raise ValueError("card_out needs host-side overlap-save rows; "
                         "incompatible with device_unfold")
    upload = PinnedUpload(detector.device)
    pending = []  # [(ts, idx, n_valid, raw, PendingBatch)]

    def drain(entry):
        ts, idx, n, raw, batch = entry
        out = {k: v.cpu().numpy()[:n] for k, v in batch.result().items()}
        soa = detector.soa(idx, out["corr_sample"], out["corr_offset"])
        if summary is not None and summary_out is not None:
            for i in range(n):
                print(summary(int(idx[i]), out, i), file=summary_out)
        if card_out is not None and np.any(out["detected"]):
            keep = out["detected"]
            card.write_card(card_out, ts[keep], idx[keep], raw[:n][keep])
            card_out.flush()
        return toad.from_detector_output(
            ts, idx, soa, out, rxid=rxid,
            txid_from_template=txid_from_template)

    try:
        for ts, idx, raw in batches:
            n = len(ts)
            if n == 0:  # a batch can be all-junk rows
                continue
            if device_unfold:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n) * 2
                                      * detector.new_len, 128, np.uint8)])
                # Contiguous new bytes only (no repeated history); the
                # unfold runs on the device.
                batch = detector.submit_raw_stream(upload(raw))
            else:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n, raw.shape[1]), 128,
                                      np.uint8)])
                # Upload raw uint8 (2 B/sample); conversion runs on
                # device.
                batch = detector.submit_raw(upload(raw))
            pending.append((ts, idx, n, raw, batch))
            # Keep one batch in flight: overlap host decode with device
            # work.
            if len(pending) > 1:
                yield drain(pending.pop(0))
    except (IOError, KeyboardInterrupt):
        # The stream died or SIGTERM/SIGINT arrived: results already
        # queued on the device still reach the output before the
        # exception surfaces.
        while pending:
            yield drain(pending.pop(0))
        raise
    while pending:
        yield drain(pending.pop(0))


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", type=str, nargs="?", default="-",
                        help="input .card file ('-' streams from stdin)")
    parser.add_argument("--raw", action="store_true",
                        help="input is raw interleaved uint8 I/Q")
    parser.add_argument("--rtl-tcp", type=str, default=None,
                        metavar="HOST[:PORT]",
                        help="detect live from an rtl_tcp server "
                             "(implies --raw; configures freq/"
                             "sample-rate/gain on connect)")
    parser.add_argument("--rtlsdr", type=int, default=None, metavar="N",
                        help="detect live from USB RTL-SDR device N via "
                             "the in-process librtlsdr binding (implies "
                             "--raw)")
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
    parser.add_argument("--t0", type=float, default=None,
                        help="with --raw: stamp blocks deterministically "
                             "as t0 + block_idx*block_dt instead of the "
                             "wall clock")
    parser.add_argument("--device-unfold", action="store_true",
                        help="upload only the raw stream's new bytes and "
                             "build the overlap-save rows on the device; "
                             "raw/live inputs only, incompatible with "
                             "--card-out/--skip")
    parser.add_argument("-k", "--skip", type=int, default=0,
                        metavar="N",
                        help="with --raw/--rtl-tcp/--rtlsdr: discard the "
                             "first N blocks and renumber the survivors "
                             "from 0, like fastdet (ignored for .card "
                             "input) [default: 0]")
    parser.add_argument("--gate-capacity", type=int, default=0,
                        metavar="C",
                        help="carrier-gated correlation: run the "
                             "correlation stages on at most C "
                             "carrier-positive blocks per batch (exact: "
                             "a batch with more re-runs in full); size C "
                             "above the expected carrier blocks per "
                             "batch, e.g. batch/2 at <=25%% duty "
                             "[default: 0 = off]")
    parser.add_argument("--quiet", action="store_true",
                        help="do not print per-block summary lines")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("-o", "--output", type=str,
                       help="output .toad file ('-' for stdout)")
    group.add_argument("-a", "--append", type=str,
                       help="output .toad file to append to")
    parser.add_argument("--card-out", type=str, default=None,
                        help="tee corr-detected blocks to this .card file "
                             "(the fastdet-style sparse capture archive)")
    parser.add_argument("--corr-interp", type=str, default="gaussian",
                        choices=["gaussian", "parabolic", "cosine",
                                 "autocorr", "none", "maximise"],
                        help="sub-sample correlation-peak interpolator "
                             "(the reference's experimental set, "
                             "batched) [default: gaussian]")
    parser.add_argument("--carrier-interp", type=str, default="auto",
                        choices=["auto", "dirichlet", "parabolic",
                                 "polyfit", "gaussian", "cosine", "none"],
                        help="sub-bin carrier interpolator [default: "
                             "auto = dirichlet, or parabolic in integer "
                             "sync mode]")
    parser.add_argument("--peak-filter", type=int, default=0,
                        metavar="LEN",
                        help="Dirichlet matched filter length for the "
                             "carrier peak search (-1 = auto width, "
                             "0 = off; the filtered search runs as torch "
                             "ops, not the power/peak kernel) "
                             "[default: 0]")
    parser.add_argument("--emit-txid", action="store_true",
                        help="write .toads lines with txid taken from the "
                             "winning template of a template bank (the "
                             "template file must hold a [T, L] array)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES),
                        help="where the detector runs; 'cuda' fails when "
                             "no card is available [default: cuda]")

    keys = ["sample_rate", "block_size", "block_history", "carrier_window",
            "carrier_threshold", "corr_threshold", "template", "rxid",
            "batch_size", "sync_mode", "tuner_freq", "tuner_gain"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    # Usage errors before any expensive setup, worded as the JAX CLI's.
    if args.rtl_tcp is not None and args.rtlsdr is not None:
        parser.error("give either --rtl-tcp or --rtlsdr, not both")
    live = args.rtl_tcp if args.rtl_tcp is not None else args.rtlsdr
    if live is not None and args.input != "-":
        parser.error("give either an input file or a live SDR source, "
                     "not both")
    if args.device_unfold:
        if not args.raw and live is None:
            parser.error("--device-unfold needs a raw stream input "
                         "(--raw, --rtl-tcp or --rtlsdr); .card input "
                         "decodes to overlap-save rows already")
        if args.card_out:
            parser.error("--card-out needs host-side overlap-save "
                         "rows; incompatible with --device-unfold")
        if args.skip > 0:
            parser.error("--skip filters host-side rows; incompatible "
                         "with --device-unfold")

    template = tpl_io.load_template(config.template)
    if args.emit_txid and template.ndim != 2:
        parser.error("--emit-txid requires a template bank "
                     "(a 2-D [T, L] .npy array)")
    device = resolve_device(args.device)
    bin_freq = config.sample_rate / config.block_size
    window = normalize_freq_range(config.carrier_window, bin_freq)

    detector = BatchDetector(template, DetectorConfig(
        block_len=config.block_size,
        history_len=config.block_history,
        carrier_thresh=config.carrier_threshold,
        carrier_window=window,
        corr_thresh=config.corr_threshold,
        sync_mode=config.sync_mode,
        corr_interp=args.corr_interp,
        carrier_interp=args.carrier_interp,
        peak_filter_len=args.peak_filter,
        gate_capacity=args.gate_capacity,
    ), device=device)

    in_stream = open_source(args, config, args.input)
    if in_stream is None:
        return 1
    if live is not None:
        args.raw = True
    pump = None
    if args.raw:
        pump = StreamPump(in_stream, config.block_size,
                          config.block_history, config.batch_size,
                          sample_rate=config.sample_rate, t0=args.t0)
        batches = (pump.batches_contiguous() if args.device_unfold
                   else pump.batches())
    else:
        # Parse/decode batches in a background thread so host IO
        # overlaps device compute.
        batches = prefetch_iter(
            card.iter_card_batches(in_stream, config.batch_size), depth=2)

    if args.output == "-":
        out_stream, close_out = sys.stdout, False
    elif args.output:
        out_stream, close_out = open(args.output, "w"), True
    elif args.append:
        out_stream, close_out = open(args.append, "a"), True
    else:
        out_stream, close_out = None, False
    info_out = sys.stderr if out_stream is sys.stdout else sys.stdout

    summary = None if args.quiet else SummaryFormatter(
        config.sample_rate, config.block_size)

    card_out = open(args.card_out, "w") if args.card_out else None

    import signal
    import time as time_mod

    # Convert SIGTERM into a normal exit so open .toad output is flushed.
    def _terminate(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread (e.g. under a test harness)

    num = 0
    counter = {"blocks": 0}

    def counted(batch_iter):
        for ts, idx, raw in batch_iter:
            counter["blocks"] += len(ts)
            yield ts, idx, raw

    if args.raw and args.skip > 0:
        def skipped(batch_iter, skip=args.skip):
            # fastdet semantics: the first `skip` blocks are discarded and
            # block k becomes index k - skip (fastcard.c:108-109).
            for ts, idx, raw in batch_iter:
                keep = idx >= skip
                if not np.all(keep):
                    if not np.any(keep):
                        continue
                    ts, idx, raw = ts[keep], idx[keep], raw[keep]
                yield ts, idx - skip, raw
        batches = skipped(batches)

    exit_code = 0
    t_start = time_mod.perf_counter()
    try:
        for records in detect_batches(
                detector, counted(batches), config.batch_size,
                rxid=config.rxid, summary=summary, summary_out=info_out,
                txid_from_template=args.emit_txid, card_out=card_out,
                device_unfold=args.device_unfold):
            num += len(records)
            if out_stream is not None:
                toad.save(out_stream, records, with_txid=args.emit_txid)
                out_stream.flush()
    except KeyboardInterrupt:
        print("interrupted; output flushed", file=sys.stderr)
    except IOError as e:
        print("stream error: {}; output flushed".format(e),
              file=sys.stderr)
        exit_code = 1
    finally:
        if close_out:
            out_stream.close()
        if card_out is not None:
            card_out.close()
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
    elapsed = time_mod.perf_counter() - t_start
    if not args.quiet:
        print("{} detections".format(num), file=info_out)
        rate = counter["blocks"] * detector.new_len / max(elapsed, 1e-9)
        print("throughput: {:.0f} blocks in {:.2f} s = {:.3g} IQ samples/s "
              "({:.1f}x realtime @ {:.1f} Msps) on {}".format(
                  counter["blocks"], elapsed, rate,
                  rate / config.sample_rate,
                  config.sample_rate / 1e6, device), file=info_out)
        if args.gate_capacity:
            print("gate: {} batches overflowed capacity {} and re-ran in "
                  "full".format(detector.gate_overflows,
                                args.gate_capacity), file=info_out)
        if pump is not None:
            print(pump.stats_line(), file=info_out)
        if hasattr(in_stream, "stats_line"):
            # USB ring occupancy/overflow report (rtlsdr_reader.c:310-325).
            print(in_stream.stats_line(), file=info_out)
    if pump is not None:
        pump.close()
    return exit_code


if __name__ == "__main__":
    sys.exit(_main())
