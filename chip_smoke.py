#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``thrifty_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the detect path's
shapes and on the inputs each path of the port gives it (capture gate,
integer sync, gated correlation and its overflow, device unfold), then
drives the port's CLI (``thrifty_tpu_torch.cli``) on the card:

- ``detect`` on the committed golden captures against the reference
  ``.toad`` goldens, and on a full-size synthetic capture (block 16384,
  history 4920, batch 256, the 4914-sample golden template) against its
  ground truth and against the same CLI on the CPU -- the main path,
  whose kernel launches the JSON line reports;
- ``detect --sync-mode integer`` and ``capture`` against the goldens of
  the compiled fastdet / fastcard (``tests/golden/fastdet``);
- ``detect --raw --device-unfold`` against ``detect --raw``;
- the carrier gate on the JAX bench's mix (a burst every 4 blocks,
  capacity 128) against the ungated detector, and an overflowing
  capacity;
- timings of the gated, integer and device-unfold programs and of the
  CLIs, each printed with the card's name and power limit.

Every phase raises on failure, so a non-zero exit means a failed phase;
without a CUDA card it fails at once.  JAX is never imported.  The one
exception to "nothing of the JAX package" is its numpy host modules,
which the port itself reuses: ``thrifty_tpu.io.card`` to write and count
captures and ``thrifty_tpu.sim`` to synthesise one; both leave ``jax``
unloaded, and the script checks that at its end.

Output: lines for each phase, then a JSON line describing each kernel
(with the paths that launched it and their launches per batch), the
card's name and power limit as ``nvidia-smi`` reports them, and, as the
last line, ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
INPUT = os.path.join(GOLDEN, "input")
BATCH = 256
# The .toad comparison of tests/test_golden_reference.py: integer columns
# exact (rxid, block, corr peak lag, carrier bin), floats within these.
TOAD_INT_COLS = (0, 2, 4, 8)
TOAD_TOLS = {1: dict(atol=1e-9), 3: dict(atol=1e-3), 5: dict(atol=1e-3),
             6: dict(rtol=1e-3, atol=1e-3), 7: dict(rtol=1e-2, atol=1e-3),
             9: dict(atol=2e-3), 10: dict(rtol=1e-3, atol=1e-3),
             11: dict(rtol=1e-2, atol=1e-3)}
SUM_RTOL = 1e-5  # kernel vs plain sums: float32 reassociation


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print("== {}".format(name), flush=True)


def card_phase():
    phase("card")
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print("torch {} cuda {} python {}".format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    return card


def build_phase():
    phase("build")
    from thrifty_tpu_torch import _build

    for name in _build.sources():
        path, seconds, log = _build.build(name, force=True)
        _build.load(name)
        print("built {} in {:.2f} s -> {}".format(
            name, seconds, os.path.relpath(path, ROOT)))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())


TIMINGS = {
    "cold": "device time, L2 scrubbed before each call",
    "warm": "device time, input read by the call before",
    "call": "call time, host launch included",
}


def median_ms(fn, mode, scrub, reps=25, warmup=10):
    """Median of per-call CUDA-event times (``mode`` a key of TIMINGS).

    "cold" and "warm" queue each call behind a ~1 ms device sleep, so
    the start event fires only after the host has queued the call and
    the interval is the device's time alone; "cold" also overwrites
    ``scrub`` (larger than the 50 MB L2) after the sleep, so the input
    comes from HBM.  "call" has neither, so the interval also holds the
    host's launch latency (the card idles while the wrapper runs).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if mode != "call":
            torch.cuda._sleep(2_000_000)
        if mode == "cold":
            scrub.fill_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def held_against_plain(x, mask, stats_mask=None, layout="interleaved",
                       what=""):
    """One power_peak launch against its plain version on the same input:
    idx and peak bit-equal, sums within SUM_RTOL.  Returns (the kernel's
    outputs as numpy, max abs err of idx/peak, max rel err of the sums)."""
    from thrifty_tpu_torch.dsp import power_peak as pp

    dev = x.device
    got = pp.fused_power_peak(x, mask, stats_mask=stats_mask, layout=layout)
    host = mask.host if isinstance(mask, pp.Mask) else mask
    ref = pp.fused_power_peak_reference(
        x.real, x.imag, torch.from_numpy(host).to(dev),
        None if stats_mask is None else torch.from_numpy(stats_mask).to(dev))
    torch.cuda.synchronize()
    got = [g.cpu().numpy() for g in got]
    ref = [r.cpu().numpy() for r in ref]
    check(np.array_equal(got[0], ref[0]), "idx differs: " + what)
    check(np.array_equal(got[1].view(np.uint32), ref[1].view(np.uint32)),
          "peak not bit-equal: " + what)
    max_rel = 0.0
    for g, r in zip(got[2:], ref[2:]):
        rel = float(np.max(np.abs(g - r) / np.abs(r)))
        check(rel <= SUM_RTOL, "sum off by rel {:.3g}: {}".format(rel, what))
        max_rel = max(max_rel, rel)
    max_abs = max(float(np.max(np.abs(got[0].astype(np.int64) - ref[0]))),
                  float(np.max(np.abs(got[1] - ref[1]))))
    return got, max_abs, max_rel


def kernel_phase(card, blocks_np, template):
    """power_peak kernel vs its plain version at the detect path's shapes."""
    phase("kernel vs plain")
    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp import xcorr
    from thrifty_tpu_torch.dsp.carrier import window_mask

    dev = torch.device("cuda")
    n = blocks_np.shape[1]
    blocks = torch.from_numpy(blocks_np).to(dev)
    spec = torch.fft.fft(blocks)
    tconj = torch.from_numpy(xcorr.template_fft_conj(template, n)).to(dev)
    corr = torch.fft.ifft(spec * tconj)
    start, stop = xcorr.corr_window(n, 4920, len(template))
    corr_mask = np.zeros(n, dtype=bool)
    corr_mask[start:stop] = True
    stats = np.zeros(n, dtype=bool)
    stats[:n - len(template) + 1] = True

    rng = np.random.default_rng(1)
    ragged = (rng.normal(size=(3, 1000))
              + 1j * rng.normal(size=(3, 1000))).astype(np.complex64)
    ties = (rng.uniform(-0.02, 0.02, (8, 2048))
            + 1j * rng.uniform(-0.02, 0.02, (8, 2048))).astype(np.complex64)
    ties[:, 300] = 3.0 + 4.0j
    ties[:, 1500] = 4.0 + 3.0j       # same power, later column
    last = corr.clone()
    last[:, -1] = 1e4                # peak in the last column
    cases = [
        ("carrier", spec, window_mask((7, 110), n)),
        ("corr", corr, corr_mask),
        ("last_column", last, np.ones(n, dtype=bool)),
        ("ragged", torch.from_numpy(ragged).to(dev),
         np.ones(1000, dtype=bool)),
        ("ties", torch.from_numpy(ties).to(dev),
         np.ones(2048, dtype=bool)),
    ]
    max_abs = 0.0
    max_rel = 0.0
    for name, x, mask in cases:
        for layout in ("interleaved", "planes"):
            for sm in (None, stats[:x.shape[1]]):
                what = "{} {} stats={}".format(name, layout, sm is not None)
                got, err, rel = held_against_plain(x, mask, sm, layout, what)
                max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
                if name == "ties":
                    check(np.all(got[0] == 300), "tie not earliest")
                if name == "last_column":
                    check(np.all(got[0] == n - 1), "last column missed")
    print("idx/peak bit-equal in {} comparisons; sums max rel err {:.3g} "
          "(limit {:g})".format(len(cases) * 4, max_rel, SUM_RTOL))

    # Time the main path's call (the correlation, interleaved, no stats)
    # in turns: plain, kernel, kernel, plain.
    corr_bool = torch.from_numpy(corr_mask).to(dev)
    mask_obj = pp.Mask(corr_mask, dev)
    runs = {"kernel": lambda: pp.fused_power_peak(corr, mask_obj),
            "plain": lambda: pp.fused_power_peak_reference(
                corr.real, corr.imag, corr_bool)}
    scrub = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    times = {}
    for mode in TIMINGS:
        for which in ("plain", "kernel", "kernel", "plain"):
            times.setdefault((which, mode), []).append(
                median_ms(runs[which], mode, scrub))
    del scrub
    med = {k: float(np.median(v)) for k, v in times.items()}
    ms, plain_ms = med["kernel", "cold"], med["plain", "cold"]
    for mode, what in TIMINGS.items():
        print("power_peak [{}, {}] complex64, {}: kernel {:.4f} ms (turns "
              "{}), plain {:.4f} ms (turns {}); each turn the median of 25 "
              "CUDA-event timings; {}".format(
                  corr.shape[0], n, what, med["kernel", mode],
                  "/".join("{:.4f}".format(t) for t in times["kernel", mode]),
                  med["plain", mode],
                  "/".join("{:.4f}".format(t) for t in times["plain", mode]),
                  card))
    mb = corr.numel() * 8 / 1e6
    print("kernel reads {:.1f} MB: {:.0f} GB/s cold, {:.0f} GB/s warm; {}"
          .format(mb, mb / ms, mb / med["kernel", "warm"], card))
    return {"name": "power_peak", "route": "cuda",
            "source": "thrifty_tpu_torch/csrc/power_peak.cu",
            "replaces": "thrifty_tpu/dsp/pallas_kernels.py:163",
            "max_abs_err": max_abs, "sum_max_rel_err": max_rel,
            "ms": ms, "plain_ms": plain_ms}


def load_toad(path):
    return np.atleast_2d(np.loadtxt(path))


def compare_toads(got, ref, what):
    check(got.shape == ref.shape, "{}: {} vs {} detections".format(
        what, got.shape[0], ref.shape[0]))
    for col in TOAD_INT_COLS:
        check(np.array_equal(got[:, col], ref[:, col]),
              "{}: toad column {} differs".format(what, col))
    for col, tol in TOAD_TOLS.items():
        check(np.allclose(got[:, col], ref[:, col], **tol),
              "{}: toad column {} beyond {}".format(what, col, tol))


def detect(args):
    from thrifty_tpu_torch.cli import main

    check(main(["detect"] + args) == 0, "detect failed: {}".format(args))


def common_args(device, template_path, rxid=0):
    return ["-c", os.path.join(INPUT, "detector.cfg"),
            "--template", template_path, "--rxid", str(rxid),
            "--batch-size", str(BATCH), "--device", device, "--quiet"]


def golden_phase(tmp):
    phase("golden slice")
    from thrifty_tpu.io import card
    from thrifty_tpu_torch.dsp import power_peak as pp

    tpl_path = os.path.join(INPUT, "template.npy")
    for rxid in (0, 1, 2):
        src = os.path.join(INPUT, "rx{}.card".format(rxid))
        out = os.path.join(tmp, "rx{}.toad".format(rxid))
        batches = math.ceil(len(card.read_card(src)[0]) / BATCH)
        pp.launches = 0
        detect([src, "-o", out] + common_args("cuda", tpl_path, rxid))
        check(pp.launches == 2 * batches,
              "rx{}: {} kernel launches for {} batches".format(
                  rxid, pp.launches, batches))
        got = load_toad(out)
        compare_toads(got, load_toad(os.path.join(
            GOLDEN, "rx{}.toad".format(rxid))), "rx{}".format(rxid))
        print("rx{}: {} detections match the reference golden; {} kernel "
              "launches".format(rxid, len(got), pp.launches))


def full_size_phase(card_name, tmp, cap):
    phase("full-size slice")
    from thrifty_tpu.io import card
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp import power_peak as pp

    tpl_path = os.path.join(tmp, "template.npy")
    np.save(tpl_path, cap.template)
    path = os.path.join(tmp, "full.card")
    card.write_card(path, cap.timestamps, cap.indices,
                    iq.iq_to_raw(cap.blocks))
    n_blocks = len(cap.indices)
    new_len = 16384 - 4920

    gpu_out = os.path.join(tmp, "full_gpu.toad")
    args = [path, "-o", gpu_out] + common_args("cuda", tpl_path)
    pp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    detect(args)
    elapsed = time.perf_counter() - t0
    launches = pp.launches
    batches = math.ceil(n_blocks / BATCH)
    check(launches == 2 * batches, "{} kernel launches for {} batches"
          .format(launches, batches))

    got = load_toad(gpu_out)
    by_block = {int(r[2]): r for r in got}
    worst = 0.0
    for b in cap.bursts:
        check(b.block_idx in by_block,
              "burst in block {} not detected".format(b.block_idx))
        err = abs(by_block[b.block_idx][3] - b.expected_soa)
        check(err < 0.05, "block {}: |soa - expected| = {:.4f}".format(
            b.block_idx, err))
        worst = max(worst, err)
    extra = len(got) - len(cap.bursts)
    rate = n_blocks * new_len / elapsed
    print("{} blocks, batch {}: all {} bursts detected, max |soa - "
          "expected| {:.5f} samples, {} other detections".format(
              n_blocks, BATCH, len(cap.bursts), worst, extra))
    print("detect throughput on the card: {:.4g} IQ samples/s ({} blocks "
          "in {:.3f} s, .card decode included); {}".format(
              rate, n_blocks, elapsed, card_name))

    cpu_out = os.path.join(tmp, "full_cpu.toad")
    t0 = time.perf_counter()
    detect([path, "-o", cpu_out] + common_args("cpu", tpl_path))
    cpu_s = time.perf_counter() - t0
    compare_toads(got, load_toad(cpu_out), "cuda vs cpu")
    print("cuda and cpu runs agree on every detection (cpu took {:.2f} s)"
          .format(cpu_s))
    return launches


# The .toad comparison of tests/test_golden_fastdet.py (goldens printed by
# the compiled fastdet with %f / %.8f).
FASTDET = os.path.join(GOLDEN, "fastdet")
FASTDET_TOLS = {1: dict(atol=1e-9), 3: dict(atol=1e-4), 5: dict(atol=1e-4),
                6: dict(rtol=1e-4), 7: dict(rtol=1e-4), 9: dict(atol=1e-4),
                10: dict(rtol=1e-4), 11: dict(rtol=1e-4)}
RAW0 = os.path.join(FASTDET, "input", "rx0.raw")
NEW_LEN = 16384 - 4920
# Detector output field -> .toad column, for TOAD_TOLS.
FIELD_COLS = {"corr_offset": 5, "corr_energy": 6, "corr_noise": 7,
              "carrier_offset": 9, "carrier_energy": 10,
              "carrier_noise": 11}
CORR_FIELDS = ("corr_sample", "corr_offset", "corr_energy", "corr_noise")


def run_cli(command, args, blocks, per_batch):
    """Run the port's CLI with the launch count set to 0 just before and
    read just after; it must equal ``per_batch`` launches for each
    batch of ``blocks`` blocks.  Returns (seconds, launches per batch)."""
    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.dsp import power_peak as pp

    batches = math.ceil(blocks / BATCH)
    torch.cuda.synchronize()
    pp.launches = 0
    t0 = time.perf_counter()
    check(main([command] + args) == 0, "{} failed: {}".format(command, args))
    seconds = time.perf_counter() - t0
    launches = pp.launches
    check(launches == per_batch * batches,
          "{} {}: {} kernel launches for {} batches, expected {} each".format(
              command, args[:2], launches, batches, per_batch))
    return seconds, launches / batches


def card_lines(path):
    """(index, payload) of each .card line (timestamps not compared)."""
    with open(path) as f:
        return [tuple(ln.split()[1:]) for ln in f
                if ln.strip() and not ln.startswith("#")]


def compare_fastdet(got, ref, what, skip_cols=()):
    check(got.shape == ref.shape, "{}: {} vs {} detections".format(
        what, got.shape[0], ref.shape[0]))
    for col in TOAD_INT_COLS:
        check(np.array_equal(got[:, col], ref[:, col]),
              "{}: toad column {} differs".format(what, col))
    for col, tol in FASTDET_TOLS.items():
        if col not in skip_cols:
            check(np.allclose(got[:, col], ref[:, col], **tol),
                  "{}: toad column {} beyond {}".format(what, col, tol))


def paths_phase(cap, template):
    """power_peak on each path of this slice, held against its plain
    version on exactly the inputs that path gives it (captured during one
    run of the path; these launches are not counted for the main path)."""
    phase("kernel vs plain on each path")
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.pipeline.capture import CarrierGate

    dev = torch.device("cuda")
    rows = torch.from_numpy(iq.iq_to_raw(cap.blocks[:BATCH])).to(dev)
    new = torch.from_numpy(iq.iq_to_raw(
        cap.blocks[:BATCH, 4920:].reshape(-1))).to(dev)

    def det(**kw):
        return BatchDetector(template, DetectorConfig(
            carrier_window=(7, 110), **kw), device=dev)

    gate = CarrierGate(16384, (7, 110), (0.0, 15.0, 0.0), history_len=4920,
                       device=dev)
    paths = {
        "capture_gate": (lambda: gate(rows), [BATCH]),
        "capture_gate_device_unfold": (lambda: gate.gate_stream(new),
                                       [BATCH]),
        "detect_integer": (lambda: det(sync_mode="integer").submit_raw(
            rows).result(), [BATCH, BATCH]),
        "detect_gated": (lambda: det(gate_capacity=BATCH // 2).submit_raw(
            rows).result(), [BATCH, BATCH // 2]),
        "detect_gate_overflow": (lambda: det(gate_capacity=8).submit_raw(
            rows).result(), [BATCH, 8, BATCH]),
        "detect_device_unfold": (lambda: det().submit_raw_stream(
            new).result(), [BATCH, BATCH]),
    }
    orig = pp.fused_power_peak
    captured = []

    def spy(x, mask, stats_mask=None, layout="interleaved"):
        captured.append((x.clone(), mask))
        return orig(x, mask, stats_mask=stats_mask, layout=layout)

    worst_abs = worst_rel = 0.0
    for name, (fn, rows_per_launch) in paths.items():
        captured.clear()
        pp.fused_power_peak = spy
        try:
            fn()
        finally:
            pp.fused_power_peak = orig
        shapes = [tuple(x.shape) for x, _ in captured]
        check([s[0] for s in shapes] == rows_per_launch,
              "{}: launches on rows {}, expected {}".format(
                  name, shapes, rows_per_launch))
        for k, (x, mask) in enumerate(captured):
            _, err, rel = held_against_plain(
                x, mask, what="{} launch {}".format(name, k))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        print("{}: {} launches on {}, idx/peak bit-equal to plain".format(
            name, len(shapes), shapes))
    print("sums max rel err {:.3g} (limit {:g})".format(worst_rel, SUM_RTOL))
    return worst_abs


def fastdet_phase(tmp):
    phase("fastdet goldens (integer sync)")
    from thrifty_tpu.io import card

    tpl = os.path.join(INPUT, "template.npy")
    common = ["--carrier-window", "7-110", "--quiet", "--sync-mode",
              "integer", "--template", tpl, "--batch-size", str(BATCH),
              "--device", "cuda"]
    for rxid in (0, 1, 2):
        src = os.path.join(INPUT, "rx{}.card".format(rxid))
        out = os.path.join(tmp, "rx{}_int.toad".format(rxid))
        tee = ["--card-out", os.path.join(tmp, "tee.card")] if rxid == 0 \
            else []
        _, per_batch = run_cli("detect", [src, "-o", out, "--rxid",
                                          str(rxid)] + tee + common,
                               len(card.read_card(src)[0]), 2)
        compare_fastdet(load_toad(out), load_toad(os.path.join(
            FASTDET, "rx{}_fastdet.toad".format(rxid))), "rx{}".format(rxid))
    check(card_lines(os.path.join(tmp, "tee.card"))
          == card_lines(os.path.join(FASTDET, "tee.card")),
          "--card-out differs from fastdet's tee.card")
    out = os.path.join(tmp, "raw_skip1.toad")
    run_cli("detect", ["--raw", RAW0, "-o", out, "-k", "1", "--t0", "0",
                       "--rxid", "0"] + common, 40, 2)
    compare_fastdet(load_toad(out), load_toad(os.path.join(
        FASTDET, "raw_skip1_fastdet.toad")), "raw -k 1", skip_cols=(1,))
    print("rx0/rx1/rx2 match the compiled fastdet's .toad, --card-out its "
          "tee.card (payloads identical), --raw -k 1 its "
          "raw_skip1_fastdet.toad; 2 kernel launches per batch")
    return {"detect_integer": per_batch}


def capture_phase(tmp):
    phase("capture golden")
    ref = card_lines(os.path.join(FASTDET, "gated.card"))
    per_batch = {}
    for name, extra in (("capture_gate", []),
                        ("capture_gate_device_unfold", ["--device-unfold"])):
        out = os.path.join(tmp, name + ".card")
        _, per_batch[name] = run_cli(
            "capture", ["--raw-in", RAW0, "-o", out, "--t0", "0", "--quiet",
                        "--carrier-window", "7-110", "--device", "cuda"]
            + extra, 40, 1)
        check(card_lines(out) == ref,
              "{}: archive differs from fastcard's gated.card".format(name))
    print("capture --raw-in rx0.raw, host and device unfold: the {} blocks "
          "of fastcard's gated.card, indices and payloads identical; 1 "
          "kernel launch per batch".format(len(ref)))
    return per_batch


def check_bursts(toad, cap, what):
    by_block = {int(r[2]): r for r in toad}
    for b in cap.bursts:
        check(b.block_idx in by_block, "{}: burst in block {} not "
              "detected".format(what, b.block_idx))
        err = abs(by_block[b.block_idx][3] - b.expected_soa)
        check(err < 0.05, "{}: block {}: |soa - expected| = {:.4f}".format(
            what, b.block_idx, err))


def raw_args(raw_path, out, tpl_path, extra=()):
    return [raw_path, "--raw", "-o", out, "--t0", "0"] \
        + common_args("cuda", tpl_path) + list(extra)


def device_unfold_phase(card_name, tmp, cap, raw_path, tpl_path):
    phase("device unfold")
    n = len(cap.indices)
    rate = {}
    texts = {}
    for name in ("raw", "device_unfold", "device_unfold", "raw"):
        out = os.path.join(tmp, name + ".toad")
        extra = ["--device-unfold"] if name == "device_unfold" else []
        seconds, per_batch = run_cli(
            "detect", raw_args(raw_path, out, tpl_path, extra), n, 2)
        rate.setdefault(name, []).append(n * NEW_LEN / seconds)
        texts[name] = open(out).read()
    check(texts["raw"] == texts["device_unfold"],
          "--device-unfold .toad differs from --raw")
    check_bursts(load_toad(os.path.join(tmp, "raw.toad")), cap, "--raw")
    print("detect --raw --device-unfold writes the .toad of detect --raw "
          "({} detections, every burst within 0.05 samples); 2 kernel "
          "launches per batch".format(texts["raw"].count("\n")))
    for name, r in rate.items():
        print("detect --raw{} CLI: {} IQ samples/s ({} blocks; turns raw, "
              "device-unfold, device-unfold, raw); {}".format(
                  " --device-unfold" if name == "device_unfold" else "",
                  "/".join("{:.4g}".format(x) for x in r), n, card_name))
    return {"detect_device_unfold": per_batch}


def gate_phase(card_name, tmp, cap, template, raw_path, tpl_path):
    """The JAX bench mix: a burst every 4 blocks, batch 256, gate
    capacity 128; then an overflowing capacity of 8."""
    phase("gate")
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = torch.device("cuda")
    cfg = DetectorConfig(carrier_window=(7, 110))
    full = BatchDetector(template, cfg, device=dev)
    gated = BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), gate_capacity=BATCH // 2), device=dev)
    n_pos = 0
    for b in range(len(cap.indices) // BATCH):
        rows = torch.from_numpy(iq.iq_to_raw(
            cap.blocks[b * BATCH:(b + 1) * BATCH])).to(dev)
        a = {k: v.cpu().numpy() for k, v in full.detect_raw(rows).items()}
        pending = gated.submit_raw(rows)
        g = {k: v.cpu().numpy() for k, v in pending.result().items()}
        check(pending.overflowed is False,
              "batch {} overflowed capacity {}".format(b, BATCH // 2))
        for k in ("detected", "carrier_detect"):
            check(np.array_equal(a[k], g[k]), "gate: {} differs".format(k))
        pos = a["carrier_detect"]
        n_pos += int(pos.sum())
        for k in ("corr_sample", "carrier_bin"):
            check(np.array_equal(a[k][pos], g[k][pos]),
                  "gate: {} differs on carrier rows".format(k))
        for k, col in FIELD_COLS.items():
            check(np.allclose(g[k][pos], a[k][pos], **TOAD_TOLS[col]),
                  "gate: {} beyond {}".format(k, TOAD_TOLS[col]))
        for k in CORR_FIELDS:
            check(np.all(g[k][~pos] == 0),
                  "gate: {} not zero on carrier-negative rows".format(k))
        check(not g["detected"][~pos].any(), "gate: negative row detected")
    print("gated (capacity {}) = ungated on {} carrier-positive rows of {} "
          "(decisions, bins, lags equal; floats within TOAD_TOLS); "
          "carrier-negative rows zero".format(BATCH // 2, n_pos,
                                              len(cap.indices)))

    n = len(cap.indices)
    ref = open(os.path.join(tmp, "raw.toad")).read()
    per_batch = {}
    for name, capacity, launches in (("detect_gated", BATCH // 2, 2),
                                     ("detect_gate_overflow", 8, 3)):
        out = os.path.join(tmp, name + ".toad")
        seconds, per_batch[name] = run_cli("detect", raw_args(
            raw_path, out, tpl_path, ["--gate-capacity", str(capacity)]),
            n, launches)
        print("detect --raw --gate-capacity {} CLI: {:.4g} IQ samples/s ({} "
              "blocks); {}".format(capacity, n * NEW_LEN / seconds, n,
                                   card_name))
        got = open(out).read()
        if capacity == 8:
            check(got == ref, "overflow run's .toad differs from ungated")
        else:
            compare_toads(load_toad(out), load_toad(os.path.join(
                tmp, "raw.toad")), "gated CLI")
    print("detect --raw --gate-capacity {}: the ungated .toad within "
          "TOAD_TOLS, 2 launches per batch; --gate-capacity 8 overflows "
          "every batch, re-runs it in full (3 launches per batch) and "
          "writes the ungated .toad byte for byte".format(BATCH // 2))
    return per_batch


def events_ms(fn, reps=10):
    """ms per call of ``fn`` between CUDA events around ``reps`` calls
    queued back to back after a synchronize (host launch included: the
    detect program is bound by it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timing_phase(card_name, tmp, cap, template, raw_path):
    phase("timings")
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = torch.device("cuda")
    rows = torch.from_numpy(iq.iq_to_raw(cap.blocks[:BATCH])).pin_memory()
    new = torch.from_numpy(iq.iq_to_raw(
        cap.blocks[:BATCH, 4920:].reshape(-1))).pin_memory()

    def det(**kw):
        return BatchDetector(template, DetectorConfig(
            carrier_window=(7, 110), **kw), device=dev)

    ungated, gated, integer = det(), det(gate_capacity=BATCH // 2), \
        det(sync_mode="integer")
    rows_dev = rows.to(dev)
    variants = {
        "ungated": lambda: ungated.submit_raw(rows_dev),
        "gated": lambda: gated.submit_raw(rows_dev),
        "integer": lambda: integer.submit_raw(rows_dev),
        "host_unfold": lambda: ungated.submit_raw(
            rows.to(dev, non_blocking=True)),
        "device_unfold": lambda: ungated.submit_raw_stream(
            new.to(dev, non_blocking=True)),
    }
    times = {}
    for a, b in (("ungated", "gated"), ("host_unfold", "device_unfold"),
                 ("ungated", "integer")):
        for name in (a, b, b, a):
            times.setdefault(name, []).append(events_ms(variants[name]))
    for name, t in times.items():
        print("device ms per {}-block batch, {}: {} (turns; CUDA events "
              "around 10 batches queued back to back{}); {}".format(
                  BATCH, name, "/".join("{:.4f}".format(x) for x in t),
                  ", pinned host -> device copy included"
                  if "unfold" in name else "", card_name))
    # The gate's one host read per batch: PendingBatch.result() reading
    # the overflow flag of a batch the card has finished, as the CLI's
    # drain does right before it copies the outputs back.
    reads = []
    for _ in range(20):
        pending = gated.submit_raw(rows_dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending.result()
        reads.append((time.perf_counter() - t0) * 1e3)
        check(pending.overflowed is False, "timing batch overflowed")
    print("gate overflow-flag read at drain: median {:.4f} ms per batch, "
          "max {:.4f} ms (host clock over 20 finished batches); {}".format(
              float(np.median(reads)), max(reads), card_name))
    n = len(cap.indices)
    rates = []
    for _ in range(2):
        seconds, _ = run_cli("capture", [
            "--raw-in", raw_path, "-o", os.path.join(tmp, "cap.card"),
            "--quiet", "--carrier-window", "7-110", "--batch-size",
            str(BATCH), "--device", "cuda"], n, 1)
        rates.append(n * NEW_LEN / seconds)
    print("capture --raw-in CLI: {} IQ samples/s ({} blocks); {}".format(
        "/".join("{:.4g}".format(r) for r in rates), n, card_name))
    return {k: float(np.median(v)) for k, v in times.items()}


def main():
    card_name = card_phase()
    build_phase()

    from thrifty_tpu import sim
    from thrifty_tpu_torch.dsp import iq

    template = np.load(os.path.join(INPUT, "template.npy"))
    cap = sim.synth_capture(num_blocks=512, bursts_every=4,
                            template=template, seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernel = kernel_phase(card_name, cap.blocks[:BATCH], template)
        kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                    paths_phase(cap, template))
        golden_phase(tmp)
        # The main path: detect on a .card, launches counted from 0.
        kernel["launches"] = full_size_phase(card_name, tmp, cap)
        paths = {"detect": kernel["launches"] / math.ceil(
            len(cap.indices) / BATCH)}
        tpl_path = os.path.join(tmp, "template.npy")
        raw_path = os.path.join(tmp, "full.raw")
        iq.iq_to_raw(cap.blocks[:, 4920:].reshape(-1)).tofile(raw_path)
        paths.update(fastdet_phase(tmp))
        paths.update(capture_phase(tmp))
        paths.update(device_unfold_phase(card_name, tmp, cap, raw_path,
                                         tpl_path))
        paths.update(gate_phase(card_name, tmp, cap, template, raw_path,
                                tpl_path))
        timing_phase(card_name, tmp, cap, template, raw_path)
        kernel["paths"] = sorted(paths)
        kernel["launches_per_batch"] = paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [kernel]}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
