#!/usr/bin/env python
"""SoA accuracy of the PyTorch port: RMS error vs SNR, the detection
knee and the false alarms, for one detector configuration.

The port's counterpart of ``scripts/accuracy_sweep.py``.  It sweeps the
burst amplitude over synthetic captures with fractional-sample ground
truth (``sim.synth_capture(frac_jitter=True)``: bursts at sub-sample
positions, 8-bit quantised, the deployment geometry 16384/4920 and the
4914-sample template) and reports per point the detections and the SoA
error of the port's detector, and with ``--with-oracle`` the float64
oracle's (``oracle/numpy_ref.py``) on the same blocks.  Then the
detection rate at amplitudes near the 15*snr threshold (``--knee``) and
the carrier and correlation detections on pure-noise blocks
(``--noise-blocks``).

    python scripts/accuracy_sweep_torch.py --device cuda \\
        --fft-impl matmul --fft-precision high --json out.json

Every transform knob of the detector is an option (``--sync-mode``,
``--fft-impl``, ``--fft-precision``), so the TF32 and bf16 GEMMs of the
matmul transforms can be held to the float32 curve.  Lines name the
device; ``--json`` also writes the rows.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from thrifty_tpu_torch import sim
from thrifty_tpu_torch.device import DEVICES, resolve_device
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu_torch.dsp.util import snr_db

WINDOW = (7, 110)


def make_detector(device, template, **knobs):
    return BatchDetector(template, DetectorConfig(carrier_window=WINDOW,
                                                  **knobs), device=device)


def run(detector, blocks):
    return {k: v.cpu().numpy() for k, v in detector(blocks).items()}


def sweep(detector, template, amplitudes, num_blocks=24, noise_std=0.05,
          seed=0, oracle=None):
    """One row per amplitude: bursts, detections, mean corr SNR of the
    detections, SoA RMS and max |error| in samples (and the oracle's RMS
    on the blocks the port detected)."""
    rows = []
    for ampl in amplitudes:
        cap = sim.synth_capture(
            num_blocks=num_blocks, bursts_every=2, template=template,
            amplitude=float(ampl), noise_std=noise_std, seed=seed,
            quantize=True, frac_jitter=True)
        out = run(detector, cap.blocks)
        soa = detector.soa(cap.indices, out["corr_sample"],
                           out["corr_offset"])
        errs, snrs, oracle_errs = [], [], []
        for burst in cap.bursts:
            i = burst.block_idx
            if not out["detected"][i]:
                continue
            errs.append(soa[i] - burst.expected_soa)
            snrs.append(snr_db(out["corr_energy"][i], out["corr_noise"][i]))
            if oracle is not None:
                res = oracle.detect_block(cap.blocks[i])
                if res.detected:
                    oracle_errs.append(
                        cap.indices[i] * detector.new_len + res.corr_sample
                        + res.corr_offset - burst.expected_soa)
        row = {"amplitude": float(ampl), "bursts": len(cap.bursts),
               "detected": len(errs),
               "snr_db": float(np.mean(snrs)) if snrs else float("nan"),
               "soa_rms": float(np.sqrt(np.mean(np.square(errs))))
               if errs else float("nan"),
               "soa_max": float(np.max(np.abs(errs))) if errs
               else float("nan")}
        if oracle is not None:
            row["oracle_rms"] = float(np.sqrt(np.mean(np.square(
                oracle_errs)))) if oracle_errs else float("nan")
        rows.append(row)
    return rows


def false_alarms(detector, template, num_blocks, noise_std=0.05, seed=1):
    """(carrier detections, correlation detections) on ``num_blocks``
    pure-noise blocks (the capture's bursts at amplitude 0)."""
    cap = sim.synth_capture(num_blocks=num_blocks, bursts_every=2,
                            template=template, amplitude=0.0,
                            noise_std=noise_std, seed=seed, quantize=True)
    out = run(detector, cap.blocks)
    return int(out["carrier_detect"].sum()), int(out["detected"].sum())


def floats(text):
    return [float(a) for a in text.split(",") if a]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--amplitudes", type=str,
                        default="0.05,0.08,0.12,0.2,0.35,0.6,1.0")
    parser.add_argument("--blocks", type=int, default=24,
                        help="blocks per amplitude (a burst every 2)")
    parser.add_argument("--noise", type=float, default=0.05)
    parser.add_argument("--knee", type=str,
                        default="0.006,0.008,0.01,0.012,0.015",
                        help="amplitudes of the detection-knee rows, "
                             "--knee-blocks blocks each ('' = none)")
    parser.add_argument("--knee-blocks", type=int, default=40)
    parser.add_argument("--noise-blocks", type=int, default=640,
                        help="pure-noise blocks for the false alarms "
                             "(0 = none)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES))
    parser.add_argument("--sync-mode", type=str, default="fractional",
                        choices=["fractional", "integer", "preshift"])
    parser.add_argument("--fft-impl", type=str, default="auto",
                        choices=["auto", "matmul", "matmul3", "xla"])
    parser.add_argument("--fft-precision", type=str, default="highest",
                        choices=["highest", "high", "default"])
    parser.add_argument("--with-oracle", action="store_true",
                        help="also run the float64 oracle detector on each "
                             "detected block and report its SoA RMS")
    parser.add_argument("--json", type=str, default=None,
                        help="also write the configuration and rows here")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    knobs = dict(sync_mode=args.sync_mode, fft_impl=args.fft_impl,
                 fft_precision=args.fft_precision)
    template = sim.make_template()
    detector = make_detector(device, template, **knobs)
    oracle = None
    if args.with_oracle:
        from thrifty_tpu_torch.oracle.numpy_ref import (
            FastdetOracleDetector, OracleDetector)
        oracle = (OracleDetector if args.sync_mode == "fractional"
                  else FastdetOracleDetector)(template, carrier_window=WINDOW)

    print("config {} on {}".format(knobs, where))
    rows = sweep(detector, template, floats(args.amplitudes), args.blocks,
                 args.noise, oracle=oracle)
    knee = sweep(detector, template, floats(args.knee), args.knee_blocks,
                 args.noise)
    alarms = false_alarms(detector, template, args.noise_blocks, args.noise) \
        if args.noise_blocks else None
    header = "{:>10} {:>7} {:>9} {:>8} {:>10} {:>10}".format(
        "amplitude", "bursts", "detected", "SNR dB", "SoA RMS", "SoA max")
    for title, table in (("SoA vs SNR", rows), ("detection knee", knee)):
        if not table:
            continue
        print(title)
        print(header + (" {:>10}".format("oracle RMS")
                        if "oracle_rms" in table[0] else ""))
        for r in table:
            line = ("{amplitude:>10.4f} {bursts:>7} {detected:>9} "
                    "{snr_db:>8.2f} {soa_rms:>10.6f} {soa_max:>10.6f}"
                    .format(**r))
            if "oracle_rms" in r:
                line += " {:>10.6f}".format(r["oracle_rms"])
            print(line)
    if alarms is not None:
        print("false alarms on {} pure-noise blocks: {} carrier, {} "
              "correlation".format(args.noise_blocks, *alarms))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": knobs, "device": where, "rows": rows,
                       "knee": knee, "noise_blocks": args.noise_blocks,
                       "false_alarms": alarms}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
