#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``thrifty_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the detect path's
shapes, then drives the port's ``detect`` CLI (``thrifty_tpu_torch.cli``)
on the card: the committed golden captures against the reference
``.toad`` goldens, and a full-size synthetic capture (block 16384,
history 4920, batch 256, the 4914-sample golden template) against its
ground truth and against the same CLI on the CPU.  Every phase raises on
failure, so a non-zero exit means a failed phase; without a CUDA card
it fails at once.  JAX is never imported.  The one exception to "nothing
of the JAX package" is its numpy host modules, which the port itself
reuses: ``thrifty_tpu.io.card`` to write and count captures and
``thrifty_tpu.sim`` to synthesise one; both leave ``jax`` unloaded, and
the script checks that at its end.

Output: one line per phase, then a JSON line describing each kernel,
the card's name and power limit as ``nvidia-smi`` reports them, and, as
the last line, ``{"ok": true, "device": {...}}``.
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
                got = pp.fused_power_peak(x, mask, stats_mask=sm,
                                          layout=layout)
                ref = pp.fused_power_peak_reference(
                    x.real, x.imag, torch.from_numpy(mask).to(dev),
                    None if sm is None else torch.from_numpy(sm).to(dev))
                torch.cuda.synchronize()
                got = [g.cpu().numpy() for g in got]
                ref = [r.cpu().numpy() for r in ref]
                what = "{} {} stats={}".format(name, layout, sm is not None)
                check(np.array_equal(got[0], ref[0]),
                      "idx differs: " + what)
                check(np.array_equal(got[1].view(np.uint32),
                                     ref[1].view(np.uint32)),
                      "peak not bit-equal: " + what)
                for g, r in zip(got[2:], ref[2:]):
                    rel = float(np.max(np.abs(g - r) / np.abs(r)))
                    check(rel <= SUM_RTOL,
                          "sum off by rel {:.3g}: {}".format(rel, what))
                    max_rel = max(max_rel, rel)
                max_abs = max(max_abs, float(np.max(np.abs(
                    got[0].astype(np.int64) - ref[0]))),
                    float(np.max(np.abs(got[1] - ref[1]))))
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


def main():
    card_name = card_phase()
    build_phase()

    from thrifty_tpu import sim

    template = np.load(os.path.join(INPUT, "template.npy"))
    cap = sim.synth_capture(num_blocks=512, bursts_every=4,
                            template=template, seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernel = kernel_phase(card_name, cap.blocks[:BATCH], template)
        golden_phase(tmp)
        kernel["launches"] = full_size_phase(card_name, tmp, cap)
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
