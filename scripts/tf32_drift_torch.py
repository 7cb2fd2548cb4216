#!/usr/bin/env python
"""How far TF32 and bf16 transforms move the port's detections from the
float32 default, over many captures.

For each seed it synthesises a capture like ``chip_smoke.py``'s
full-size one (512 blocks of 16384 samples, history 4920, the golden
4914-sample template, a burst every 4 blocks, amplitude 0.5, 8-bit
quantised); seed 0 is that capture itself (carrier bin 40.25), the
others draw the carrier bin uniformly from [10, 105] and put the bursts
at sub-sample positions.  Each configuration detects it in 256-block
batches, as the ``detect`` CLI does, and is compared with the default
configuration (cuFFT, float32) on the same raw bytes.  Per capture the
script reports the rows whose decision or ``.toad`` integer field
(carrier bin, corr sample) differs, and on the other detected rows the
largest |difference| of ``corr_offset`` (the SoA moves with it),
``carrier_offset`` and the relative one of ``carrier_energy``; and on
every row both runs detected, flipped ones included, the largest
|difference| of the SoA (corr sample + offset) and of the carrier
position (bin + offset); and against the ground truth on each burst's
own block, the worst |SoA error| and the bursts off by more than 0.05
samples, beside the default's.

    python scripts/tf32_drift_torch.py --device cuda --seeds 32 \\
        --json drift.json

Lines name the device.  Exits 1 when the float32 matmul configuration
changes a decision or an integer field; the TF32 and bf16 ones are
reported.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from thrifty_tpu_torch import sim
from thrifty_tpu_torch.device import DEVICES, resolve_device
from thrifty_tpu_torch.dsp import iq
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

BATCH = 256
CONFIGS = {
    "matmul": dict(fft_impl="matmul"),
    "fft_high": dict(fft_impl="matmul", fft_precision="high"),
    "fft_default": dict(fft_impl="matmul", fft_precision="default"),
}
# The configuration whose decisions and .toad integer fields must equal
# the default run's on every capture; TF32 and bf16 flip near-ties (an
# argmax between two nearly equal bins or lags), which is reported.
EXACT_CONFIGS = ("matmul",)


def capture(seed, template, num_blocks):
    if seed == 0:
        return sim.synth_capture(num_blocks=num_blocks, bursts_every=4,
                                 template=template, seed=0)
    bin_ = float(np.random.default_rng(seed).uniform(10.0, 105.0))
    return sim.synth_capture(num_blocks=num_blocks, bursts_every=4,
                             template=template, seed=seed,
                             carrier_bin=bin_, frac_jitter=True)


def detect(detector, raw, device):
    outs = []
    for start in range(0, len(raw), BATCH):
        rows = torch.from_numpy(raw[start:start + BATCH]).to(device)
        outs.append({k: v.cpu().numpy()
                     for k, v in detector.detect_raw(rows).items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def drift(got, ref):
    """Rows whose decision or .toad integer field differs (decisions on
    every row, the carrier bin where both found a carrier, the corr
    sample where both detected: the fields a .toad line holds), and the
    largest differences on the rows where all of them agree."""
    both_c = got["carrier_detect"] & ref["carrier_detect"]
    both = got["detected"] & ref["detected"]
    flips = {
        "detected": int(np.sum(got["detected"] != ref["detected"])),
        "carrier_detect": int(np.sum(got["carrier_detect"]
                                     != ref["carrier_detect"])),
        "carrier_bin": int(np.sum(both_c & (got["carrier_bin"]
                                            != ref["carrier_bin"]))),
        "corr_sample": int(np.sum(both & (got["corr_sample"]
                                          != ref["corr_sample"]))),
    }
    det = both & (got["corr_sample"] == ref["corr_sample"]) \
        & (got["carrier_bin"] == ref["carrier_bin"])
    d = lambda k: np.abs(got[k][det].astype(np.float64) - ref[k][det])
    rel = d("carrier_energy") / np.abs(ref["carrier_energy"][det])
    # Positions (integer field + offset) on every row both detected, the
    # rows with a flipped integer field included: a flip at a near-tie
    # should move the position no more than the offsets move elsewhere.
    pos = lambda o, i, f, m: o[i][m].astype(np.float64) + o[f][m]
    soa = np.abs(pos(got, "corr_sample", "corr_offset", both)
                 - pos(ref, "corr_sample", "corr_offset", both))
    car = np.abs(pos(got, "carrier_bin", "carrier_offset", both_c)
                 - pos(ref, "carrier_bin", "carrier_offset", both_c))
    return {"corr_offset": float(np.max(d("corr_offset"), initial=0.0)),
            "carrier_offset": float(np.max(d("carrier_offset"),
                                           initial=0.0)),
            "carrier_energy_rel": float(np.max(rel, initial=0.0)),
            "soa_all": float(np.max(soa, initial=0.0)),
            "carrier_pos_all": float(np.max(car, initial=0.0)),
            "detections": int(det.sum()), "flips": flips}


def truth(detector, cap, out):
    """Ground truth on each burst's own block: the largest |SoA error| of
    the detected ones, and the bursts missed or off by more than 0.05
    samples (chip_smoke.py's bar), and the set of those blocks."""
    soa = detector.soa(cap.indices, out["corr_sample"], out["corr_offset"])
    errs = [abs(soa[b.block_idx] - b.expected_soa) if out["detected"][
        b.block_idx] else np.inf for b in cap.bursts]
    found = [e for e in errs if np.isfinite(e)]
    return {"burst_err": float(max(found, default=0.0)),
            "bursts_off": int(sum(e > 0.05 for e in errs)),
            "burst_blocks": {b.block_idx for b in cap.bursts}}


def card_name(device):
    if device.type != "cuda":
        return "CPU"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=list(DEVICES), default="cuda")
    parser.add_argument("--seeds", type=int, default=16,
                        help="captures 0..SEEDS-1 [default: 16]")
    parser.add_argument("--num-blocks", type=int, default=512)
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS),
                        choices=list(CONFIGS))
    parser.add_argument("--json", type=str, default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    name = card_name(device)
    template = np.load(os.path.join(ROOT, "tests", "golden", "input",
                                    "template.npy"))
    make = lambda **kw: BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), **kw), device=device)
    base = make()
    dets = {c: make(**CONFIGS[c]) for c in args.configs}
    rows, ok = [], True
    for seed in range(args.seeds):
        cap = capture(seed, template, args.num_blocks)
        raw = iq.iq_to_raw(cap.blocks)
        ref = detect(base, raw, device)
        ref_truth = truth(base, cap, ref)
        for c, det in dets.items():
            got = detect(det, raw, device)
            got_truth = truth(det, cap, got)
            # Rows whose corr sample or carrier bin flipped: on a burst's
            # own block, or on a neighbour holding part of a burst.
            moved = np.flatnonzero(
                (got["detected"] & ref["detected"])
                & ((got["corr_sample"] != ref["corr_sample"])
                   | (got["carrier_bin"] != ref["carrier_bin"])))
            r = dict(drift(got, ref), seed=seed, config=c,
                     burst_err=got_truth["burst_err"],
                     bursts_off=got_truth["bursts_off"],
                     default_burst_err=ref_truth["burst_err"],
                     default_bursts_off=ref_truth["bursts_off"],
                     flipped_own_blocks=int(sum(
                         int(i) in ref_truth["burst_blocks"]
                         for i in moved)))
            rows.append(r)
            flipped = {k: v for k, v in r["flips"].items() if v}
            if flipped and c in EXACT_CONFIGS:
                ok = False
            print("seed {} {}: max |d corr_offset| {:.3g}, |d "
                  "carrier_offset| {:.3g}, rel d carrier_energy {:.3g} over "
                  "{} detections; rows that differ {} ({} on a burst's own "
                  "block); with them |d SoA| {:.3g}, |d carrier position| "
                  "{:.3g}; bursts off by > 0.05 or missed {} (default {}), "
                  "worst |SoA error| {:.3g} (default {:.3g}); {}".format(
                      seed, c, r["corr_offset"], r["carrier_offset"],
                      r["carrier_energy_rel"], r["detections"],
                      flipped or "none", r["flipped_own_blocks"],
                      r["soa_all"], r["carrier_pos_all"], r["bursts_off"],
                      r["default_bursts_off"], r["burst_err"],
                      r["default_burst_err"], name))
    print("largest over {} captures:".format(args.seeds))
    summary = {}
    for c in args.configs:
        mine = [r for r in rows if r["config"] == c]
        if not mine:
            continue
        summary[c] = {k: max(r[k] for r in mine) for k in
                      ("corr_offset", "carrier_offset", "carrier_energy_rel",
                       "soa_all", "carrier_pos_all")}
        for k in ("flipped_own_blocks", "bursts_off", "default_bursts_off"):
            summary[c][k] = sum(r[k] for r in mine)
        summary[c]["rows_that_differ"] = sum(sum(r["flips"].values())
                                             for r in mine)
        summary[c]["burst_err"] = max(r["burst_err"] for r in mine)
        summary[c]["worst_corr_seed"] = max(
            mine, key=lambda r: r["corr_offset"])["seed"]
        print("  {}: {}; {}".format(c, summary[c], name))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": name, "rows": rows, "largest": summary}, f,
                      indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
