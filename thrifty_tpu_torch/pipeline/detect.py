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
the txid.  The JAX CLI's transform knobs keep their names, choices and
defaults: ``--pallas`` (the power/peak kernel; 'off', its plain
version, with ``--device cpu`` only), ``--fft-impl`` (cuFFT or the
matmul transforms, which bring the windowed carrier DFT and the
separable fractional-sync ramp) and ``--fft-precision`` (float32, TF32
or bf16 GEMMs).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from thrifty_tpu_torch import spans
from thrifty_tpu_torch.config import settings as settings_mod
from thrifty_tpu_torch.config.parsers import normalize_freq_range
from thrifty_tpu_torch.device import DEVICES, resolve_device
from thrifty_tpu_torch.dsp import util
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig, \
    gated
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


def spans_line(records):
    """The at-exit report's line on the recorded batches: the mean ms a
    batch of each span (``drain.redo`` over the batches that re-ran),
    the ring's wait, the carrier-positive rows and the gated batches
    that overflowed."""
    if not records:
        return "spans: no batch recorded"

    def mean(values):
        return sum(values) / len(values)

    parts = []
    for name in spans.SPANS + (spans.REDO,):
        took = [r["spans"][name] for r in records if name in r["spans"]]
        if took:
            parts.append("{} {:.3f}".format(
                name, mean([b - a for a, b in took]) * 1e-6))
    counts = [r["counts"] for r in records]
    line = "spans over {} batches, mean ms a batch: {}".format(
        len(records), ", ".join(parts))
    waits = [c["ring_wait_ns"] for c in counts if "ring_wait_ns" in c]
    if waits:
        line += "; ring_wait_ns {:.0f} a batch".format(mean(waits))
    carrier = [c["carrier_rows"] for c in counts if "carrier_rows" in c]
    if carrier:
        line += "; carrier rows {:.2f} a batch".format(mean(carrier))
    overflowed = [c["overflowed"] for c in counts if "overflowed" in c]
    if overflowed:
        line += "; overflowed {} of {} gated batches".format(
            sum(overflowed), len(overflowed))
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

    While :mod:`thrifty_tpu_torch.spans` records, each batch (id
    ``int(idx[0])``) gets the spans ``upload``, ``submit``,
    ``drain.wait``, ``drain.copy`` and ``drain.records`` and the counts
    ``rows``, ``carrier_rows`` and ``corr_rows``; a gated batch also
    ``gate_rows`` (from its carrier flags) and ``overflowed`` (from the
    detector's ``gate_overflows``), and one that overflowed the span
    ``drain.redo`` around its re-run, inside ``drain.wait``.  On a CUDA
    device a CUDA event recorded after the batch's launches is waited
    for in ``drain.wait``, so that the wait for the device leaves the
    copies and the re-run.
    """
    if device_unfold and card_out is not None:
        raise ValueError("card_out needs host-side overlap-save rows; "
                         "incompatible with device_unfold")
    upload = PinnedUpload(detector.device)
    device = torch.device(detector.device)
    # [(ts, idx, n_valid, raw, PendingBatch, event or None)]
    pending = []
    # Two CUDA events used in turn (at most two batches are pending), so
    # that none is created or destroyed outside the spans.
    events = []

    def mark():
        """A CUDA event after the work queued so far, while spans are
        recorded on a CUDA device."""
        if device.type != "cuda" or not spans.enabled():
            return None
        if not events:
            events.extend(torch.cuda.Event() for _ in range(2))
        events.reverse()
        events[0].record(torch.cuda.current_stream(device))
        return events[0]

    def drain(entry):
        ts, idx, n, raw, batch, done = entry
        bid = int(idx[0])
        recording = spans.enabled()
        with spans.span("drain.wait", bid):
            overflows = detector.gate_overflows if recording else 0
            if done is not None:
                done.synchronize()
            # An overflowed gated batch re-runs its correlation inside
            # result(); kept as drain.redo only where it did.
            with spans.span(spans.REDO, bid) as redo:
                result = batch.result()
                redone = recording and detector.gate_overflows != overflows
                if redone and done is not None:
                    # the re-run's launches follow the event
                    done.record(torch.cuda.current_stream(device))
                    done.synchronize()
                if not redone:
                    redo.drop()
        with spans.span("drain.copy", bid):
            full = {k: v.cpu().numpy() for k, v in result.items()}
            out = {k: v[:n] for k, v in full.items()}
        with spans.span("drain.records", bid):
            soa = detector.soa(idx, out["corr_sample"], out["corr_offset"])
            if summary is not None and summary_out is not None:
                for i in range(n):
                    print(summary(int(idx[i]), out, i), file=summary_out)
            if card_out is not None and np.any(out["detected"]):
                keep = out["detected"]
                card.write_card(card_out, ts[keep], idx[keep],
                                raw[:n][keep])
                card_out.flush()
            records = toad.from_detector_output(
                ts, idx, soa, out, rxid=rxid,
                txid_from_template=txid_from_template)
        if recording:
            spans.count(
                bid, rows=n,
                carrier_rows=int(np.count_nonzero(out["carrier_detect"])),
                corr_rows=detector.corr_rows(max(n, batch_size), redone))
            c_det = full["carrier_detect"]
            if gated(detector.config.gate_capacity, len(c_det)):
                # the count the gate compared: padding rows included
                spans.count(bid, gate_rows=int(np.count_nonzero(c_det)),
                            overflowed=int(redone))
        return records

    # Raw uint8 (2 B/sample) goes up and is converted on the device; with
    # device_unfold it is the contiguous new bytes only (no repeated
    # history), unfolded on the device too.
    submit = detector.submit_raw_stream if device_unfold \
        else detector.submit_raw
    try:
        for ts, idx, raw in batches:
            n = len(ts)
            if n == 0:  # a batch can be all-junk rows
                continue
            bid = int(idx[0])
            if n < batch_size:
                pad = ((batch_size - n) * 2 * detector.new_len,) \
                    if device_unfold else (batch_size - n, raw.shape[1])
                raw = np.concatenate([raw, np.full(pad, 128, np.uint8)])
            rows = upload(raw, batch=bid)
            with spans.span("submit", bid):
                batch = submit(rows)
                done = mark()
            pending.append((ts, idx, n, raw, batch, done))
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
    parser.add_argument("--pallas", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="power/peak reductions: 'auto'/'on' = the "
                             "CUDA kernel on the card ('on' also refuses "
                             "a batch not divisible by 8, a block not "
                             "divisible by 2048, --peak-filter and "
                             "--gate-capacity, as JAX's kernel program "
                             "does), 'off' = the plain torch reductions, "
                             "with --device cpu only: on the card the "
                             "kernel is the only reduction [default: auto]")
    parser.add_argument("--fft-impl", type=str, default="auto",
                        choices=["auto", "matmul", "matmul3", "xla"],
                        help="transforms: 'auto'/'xla' = torch.fft "
                             "(cuFFT on the card), 'matmul' = DFT / "
                             "four-step as GEMMs, 'matmul3' = the same "
                             "with Karatsuba's three real products; the "
                             "matmul impls also turn on the windowed "
                             "carrier DFT and the separable ramp "
                             "[default: auto]")
    parser.add_argument("--fft-precision", type=str, default="highest",
                        choices=["highest", "high", "default"],
                        help="GEMM precision of the matmul transforms on "
                             "the card: 'highest' = float32, 'high' = "
                             "TF32 tensor cores, 'default' = bf16 "
                             "operands (float32 on the CPU) "
                             "[default: highest]")
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
    if args.pallas == "off" and args.device == "cuda":
        parser.error("--pallas off runs the plain reductions, which only "
                     "--device cpu runs: on the card the power/peak kernel "
                     "is the only reduction")
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
        use_pallas=args.pallas,
        fft_impl=args.fft_impl,
        fft_precision=args.fft_precision,
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
    if not args.quiet:
        spans.enable()  # read by the at-exit report's spans line
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
        kept = spans.batches()
        spans.disable()
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
        if detector.graph_captures:
            print("graph: {} batches replayed the detect program's CUDA "
                  "graph ({} captured); {} of {} overflow re-runs replayed "
                  "the re-run's".format(
                      detector.graph_replays, detector.graph_captures,
                      detector.redo_replays, detector.gate_overflows),
                  file=info_out)
        if pump is not None:
            print(pump.stats_line(), file=info_out)
        print(spans_line(kept), file=info_out)
        if hasattr(in_stream, "stats_line"):
            # USB ring occupancy/overflow report (rtlsdr_reader.c:310-325).
            print(in_stream.stats_line(), file=info_out)
    if pump is not None:
        pump.close()
    return exit_code


if __name__ == "__main__":
    sys.exit(_main())
