#!/usr/bin/env python
"""Interleaved in-process A/B timing of two detector configs on the card
(the PyTorch + CUDA port's counterpart of scripts/tpu_ab_time.py).

The same program's per-batch time moves 1.3-2.4x between separate runs
on the card (PERF.md section 7), so cross-invocation comparisons are
unsound.  This harness times BOTH configs inside ONE process, strictly
interleaved round by round (A B A B ...), and reports per-round paired
ratios plus medians.

Timing is the port bench's slope method
(``thrifty_tpu_torch.bench.time_tpu_slope``): K and 2K chained batches,
each perturbed by the previous batch's output, between CUDA events;
per-batch = (T(2K) - T(K)) / K.

Usage:

    python scripts/card_ab_time_torch.py --ab fft_impl=matmul --rounds 4
    python scripts/card_ab_time_torch.py --base fft_impl=matmul \\
        --ab fft_impl=matmul,fft_precision=high

Prints one JSON line: medians, paired per-round ratios, and a verdict
('b_faster' / 'a_faster' only when one side wins every round, else
'parity'); fewer than 2 valid rounds is 'unresolved' with exit code 1.
``--device cuda`` (the default) without a card raises.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from thrifty_tpu_torch.device import DEVICES

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--scan-k", type=int, default=32)
    parser.add_argument("--rounds", type=int, default=4,
                        help="interleaved A/B measurement rounds "
                             "[default: 4]")
    parser.add_argument("--base", type=str, default=None,
                        help="side-A DetectorConfig string overrides, "
                             "K=V[,K=V...] [default: bench defaults]")
    parser.add_argument("--ab", type=str, required=True,
                        help="side-B DetectorConfig string overrides "
                             "applied ON TOP of --base, K=V[,K=V...]")
    parser.add_argument("--sync-mode", type=str, default="fractional")
    parser.add_argument("--input", type=str, default="raw",
                        choices=["raw", "c64"])
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where both detectors run; 'cuda' fails "
                             "without a card [default: cuda]")
    args = parser.parse_args(argv)

    import dataclasses

    from thrifty_tpu_torch import bench, sim
    from thrifty_tpu_torch.dsp import iq as iq_mod
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    # Same override contract (and code) as bench --ab.
    base_over = bench.parse_config_overrides(args.base, parser.error)
    b_over = dict(base_over)
    b_over.update(bench.parse_config_overrides(args.ab, parser.error))

    def make_detector(overrides):
        # replace() lets an override target ANY overridable field --
        # including sync_mode, which would collide as a duplicate
        # keyword if overrides were splatted into the constructor.
        cfg = DetectorConfig(carrier_window=(7, 110),
                             sync_mode=args.sync_mode)
        cfg = dataclasses.replace(cfg, **overrides)
        return BatchDetector(sim.make_template(), cfg, device=args.device)

    det_a = make_detector(base_over)
    det_b = make_detector(b_over)

    caps = [sim.synth_capture(num_blocks=args.batch, bursts_every=4,
                              template=sim.make_template(), seed=s,
                              quantize=False)
            for s in (0, 1)]
    blocks_list = [c.blocks for c in caps]
    raw_input = args.input == "raw"
    if raw_input:
        inputs = [iq_mod.iq_to_raw(b) for b in blocks_list]
    else:
        inputs = blocks_list

    # Run both programs once before any timed round so neither side's
    # first round carries the one-time costs (cuFFT plans, the kernel's
    # build and load, the transform constants' upload).
    for det in (det_a, det_b):
        bench.time_tpu_slope(det, inputs, 1, raw_input, repeats=1)

    def slope_once(det):
        slopes, _, _ = bench.time_tpu_slope(
            det, inputs, args.scan_k, raw_input, repeats=1)
        return slopes[0]

    rounds, invalid = [], 0
    for i in range(max(args.rounds, 1)):
        pair = {}
        for tag, det in (("a", det_a), ("b", det_b)):
            s = slope_once(det)
            if s <= 0:
                # Host-load jitter can make T(2K) < T(K); one in-round
                # retry, else the whole round is discarded -- a negative
                # slope would silently poison the ratios, medians AND
                # the paired verdict.
                s = slope_once(det)
            pair[tag] = s
        if pair["a"] <= 0 or pair["b"] <= 0:
            invalid += 1
            print("round {}: DISCARDED (non-positive slope a={:.6f} "
                  "b={:.6f})".format(i, pair["a"], pair["b"]),
                  file=sys.stderr)
            continue
        pair["ratio_b_over_a"] = pair["b"] / pair["a"]
        rounds.append(pair)
        print("round {}: a={:.6f}s b={:.6f}s b/a={:.3f}".format(
            i, pair["a"], pair["b"], pair["ratio_b_over_a"]),
            file=sys.stderr)

    if len(rounds) < 2:
        print(json.dumps({
            "metric": "config_ab_time", "value": 0.0,
            "unit": "sec_b_over_sec_a", "vs_baseline": 0.0,
            "verdict": "unresolved",
            "invalid_rounds": invalid,
            "a": base_over, "b": b_over,
        }))
        return 1

    a_med = statistics.median(r["a"] for r in rounds)
    b_med = statistics.median(r["b"] for r in rounds)
    ratios = sorted(r["ratio_b_over_a"] for r in rounds)
    ratio_med = statistics.median(ratios)
    # Paired verdict: B must win/lose in EVERY round, not just on the
    # median, before the difference is called real -- the paired ratio
    # cancels slow drift but not all ambient noise.
    if ratios[-1] < 1.0:
        verdict = "b_faster"
    elif ratios[0] > 1.0:
        verdict = "a_faster"
    else:
        verdict = "parity"

    new_len = det_a.new_len
    print(json.dumps({
        "metric": "config_ab_time",
        "value": round(ratio_med, 4),
        "unit": "sec_b_over_sec_a",
        "vs_baseline": round(1.0 / ratio_med, 4),
        "verdict": verdict,
        "a": base_over, "b": b_over,
        "batch": args.batch, "scan_k": args.scan_k,
        "sync_mode": args.sync_mode, "input": args.input,
        "device": str(det_a.device),
        "a_sec_per_batch_median": round(a_med, 7),
        "b_sec_per_batch_median": round(b_med, 7),
        "a_samples_per_s": round(args.batch * new_len / a_med, 1),
        "b_samples_per_s": round(args.batch * new_len / b_med, 1),
        "invalid_rounds": invalid,
        "rounds": [{k: (round(v, 7) if k != "ratio_b_over_a"
                        else round(v, 4))
                    for k, v in r.items()} for r in rounds],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
