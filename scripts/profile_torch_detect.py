#!/usr/bin/env python
"""Profile the PyTorch port's detect path on one CUDA card.

    python scripts/profile_torch_detect.py [--blocks 512] [--seed 0]
        [--sync-mode fractional|integer] [--gate C]
        [--corr-interp gaussian|autocorr|maximise|...]

At the deployment geometry (block 16384, history 4920, batch 256, the
committed 4914-sample golden template) on a synthetic capture, for the
detect program of the chosen carrier sync, gate capacity (``--gate``;
0 = off) and correlation interpolator, it prints:

  A  device-resident ``submit_raw`` batches back to back: wall and
     enqueue ms per batch (host clock, one synchronise at the end);
  B  ``torch.profiler`` over a few batches: device kernel launches per
     batch, device busy and span time per batch, the device's idle share,
     and the kernels with the most device time;
  C  the detect program split into its stages with CUDA events (the
     stages of ``BatchDetector._detect_batch``, called one by one; under
     the gate the correlation is one stage);
  D  the CLI on the capture written as a .card: the host's .card decode
     alone and the whole run, in IQ samples/s.

Every line carries the card's name and power limit (``nvidia-smi``).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from thrifty_tpu_torch import sim
from thrifty_tpu_torch.cli import main as cli_main
from thrifty_tpu_torch.device import resolve_device
from thrifty_tpu_torch.dsp import carrier, dirichlet, power_peak
from thrifty_tpu_torch.dsp import iq, mxu_fft
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu_torch.io import card

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = os.path.join(ROOT, "tests", "golden", "input")
BATCH = 256


def device_time_us(avg):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(avg, name, None)
        if value is not None:
            return value
    return 0.0


def back_to_back(det, raw, card_name, batches=20, trials=3):
    for trial in range(trials):
        t0 = time.perf_counter()
        for _ in range(batches):
            det.submit_raw(raw)
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("A trial {}: {:.4f} ms/batch wall, {:.4f} ms/batch enqueue "
              "({} batches of {}); {}".format(
                  trial, wall / batches * 1e3, enqueue / batches * 1e3,
                  batches, raw.shape[0], card_name))


def profiled(det, raw, card_name, batches=5):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            det.submit_raw(raw)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur = 0.0, None
    for s, e in spans:  # union of the device intervals
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    print("B {:.1f} device kernel launches per batch; busy {:.1f} us, span "
          "{:.1f} us per batch; idle share {:.3f}; {}".format(
              len(events) / batches, busy / batches, span / batches,
              1 - busy / span if span else float("nan"), card_name))
    top = sorted(prof.key_averages(), key=device_time_us, reverse=True)
    for avg in [a for a in top if device_time_us(a) > 0][:12]:
        print("B   {:<64} count {:5d}  device us/batch {:9.2f}".format(
            avg.key[:64], avg.count, device_time_us(avg) / batches))


def stages(det, raw, card_name, reps=12, skip=2):
    n = det.config.block_len

    def mark(name, marks):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    def run():
        marks = []
        mark("start", marks)
        blocks = iq.raw_to_iq(raw)
        mark("u8 -> complex64", marks)
        spec = mxu_fft.fft(blocks)
        mark("carrier fft", marks)
        c_idx, c_pow, c_energy = power_peak.fused_power_peak(
            spec, det._carrier_mask)
        mark("power_peak carrier", marks)
        c_mag = torch.sqrt(c_pow)
        c_noise, c_th = carrier.noise_and_threshold_sq(
            c_energy, c_pow, n, det.config.carrier_thresh)
        c_det = c_mag > torch.sqrt(torch.clamp(c_th, min=0.0))
        mark("carrier threshold", marks)
        neigh = torch.abs(dirichlet.gather_neighborhood(
            spec, c_idx, det._carrier_offs))
        c_off = torch.where(c_det, det._interp(neigh), 0.0)
        mark(det.carrier_interp_resolved + " fit", marks)
        src = spec if det.config.sync_mode == "integer" else blocks
        if det.config.gate_capacity:
            rows = (src, c_idx, c_off, det._signal_energy(blocks))
            det._corr_stage_gated(rows, c_det, det.config.gate_capacity)
            mark("gated correlation stage", marks)
            return marks
        corr, spec = det._remove_carrier_and_despread(src, c_idx, c_off)
        mark("carrier removal + despread + ifft", marks)
        p_idx, p_pow, _ = power_peak.fused_power_peak(
            corr, det._corr_mask_full)
        mark("power_peak corr", marks)
        p_mag = torch.sqrt(p_pow)
        name = det.config.corr_interp
        if name == "maximise":
            det._corr_interp(spec, p_idx)
        elif name != "none":
            neigh = torch.abs(dirichlet.gather_neighborhood(
                corr, p_idx, det._corr_offs))
            det._corr_interp(None, p_idx, values=neigh, length=det.corr_len)
        mark(name + " interpolation", marks)
        det._corr_noise(det._signal_energy(blocks), p_mag, n)
        mark("noise + threshold", marks)
        return marks

    times = {}
    for rep in range(reps):
        torch.cuda.synchronize()
        marks = run()
        torch.cuda.synchronize()
        if rep < skip:
            continue
        for (_, a), (name, b) in zip(marks, marks[1:]):
            times.setdefault(name, []).append(a.elapsed_time(b))
    for name, t in times.items():
        print("C {:<32} median {:.4f} ms of {}; {}".format(
            name, float(np.median(t)), len(t), card_name))


def through_cli(cap, card_name, extra, trials=2):
    with tempfile.TemporaryDirectory(prefix="profile_detect_") as tmp:
        path = os.path.join(tmp, "capture.card")
        card.write_card(path, cap.timestamps, cap.indices,
                        iq.iq_to_raw(cap.blocks))
        tpl = os.path.join(tmp, "template.npy")
        np.save(tpl, cap.template)
        for trial in range(trials):
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                blocks = sum(len(b[0]) for b in card.iter_card_batches(
                    f, BATCH))
            decode = time.perf_counter() - t0
            t0 = time.perf_counter()
            cli_main(["detect", path, "-o", os.path.join(tmp, "out.toad"),
                      "-c", os.path.join(INPUT, "detector.cfg"),
                      "--template", tpl, "--batch-size", str(BATCH),
                      "--device", "cuda", "--quiet"] + extra)
            total = time.perf_counter() - t0
            print("D trial {}: .card decode alone {:.4f} s for {} blocks; "
                  "CLI end to end {:.4f} s = {:.4g} IQ samples/s; {}".format(
                      trial, decode, blocks, total,
                      blocks * (16384 - 4920) / total, card_name))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--blocks", type=int, default=512,
                        help="blocks in the synthetic capture [512]")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sync-mode", default="fractional",
                        choices=["fractional", "integer"])
    parser.add_argument("--gate", type=int, default=0, metavar="C",
                        help="gate capacity (0 = off) [0]")
    parser.add_argument("--corr-interp", default="gaussian",
                        choices=["gaussian", "parabolic", "cosine",
                                 "autocorr", "none", "maximise"])
    args = parser.parse_args(argv)

    dev = resolve_device("cuda")
    card_name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    template = np.load(os.path.join(INPUT, "template.npy"))
    cap = sim.synth_capture(num_blocks=args.blocks, bursts_every=4,
                            template=template, seed=args.seed)
    det = BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), sync_mode=args.sync_mode,
        gate_capacity=args.gate, corr_interp=args.corr_interp), device=dev)
    print("program: sync {}, gate capacity {}, corr interp {}, batch {}; "
          "{}".format(args.sync_mode, args.gate, args.corr_interp, BATCH,
                      card_name))
    raw = torch.from_numpy(iq.iq_to_raw(cap.blocks[:BATCH])).to(dev)
    for _ in range(5):
        det.detect_raw(raw)
    torch.cuda.synchronize()

    back_to_back(det, raw, card_name)
    profiled(det, raw, card_name)
    stages(det, raw, card_name)
    through_cli(cap, card_name, ["--sync-mode", args.sync_mode,
                                 "--gate-capacity", str(args.gate),
                                 "--corr-interp", args.corr_interp])
    print("peak device memory {:.1f} MB; {}".format(
        torch.cuda.max_memory_allocated() / 1e6, card_name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
