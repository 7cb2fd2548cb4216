#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``thrifty_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the detect path's
shapes and on the inputs each path of the port gives it (capture gate
with and without a stddev term, integer sync, gated correlation and its
overflow, device unfold, a template bank's [B*T, N] rows and the gated
bank's [C*T, N] rows, both stats masks, the peak filter), then drives
the port on the card:

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
- stddev threshold terms, the peak filter and the polyfit carrier fit
  through the CLI, and ``capture`` with a stddev term;
- the interpolator, carrier and preshift goldens of
  ``tests/golden/interp`` through the CLI;
- the code-division flow at full width (3 receivers x 512 blocks, a
  3-code [3, 4914] bank, ``kitchen_sink.detect_all`` -> ``postdetect``
  with the batched solver) against the same flow on the CPU;
- the golden positioning chain detect -> identify -> match -> tdoa ->
  pos (and ``pos --batched`` on the card) against ``data.tdoa`` and
  ``data.pos``;
- the batched position solver at 8192 groups against the port on the
  CPU and scipy;
- timings of the detect programs, the solver and the CLIs, each printed
  with the card's name and power limit.

Every phase raises on failure, so a non-zero exit means a failed phase;
without a CUDA card it fails at once.  Neither JAX nor anything of the
JAX package is imported: captures are written and synthesised with the
port's own host modules (``io.card``, ``sim``, ``dsp.template``,
``pipeline.tdoa``), and the script checks ``sys.modules`` at its end.

Output: lines for each phase, then a JSON line describing each kernel
(with the paths that launched it and their launches per batch), the
card's name and power limit as ``nvidia-smi`` reports them, and, as the
last line, ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import re
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


# A control for the power_peak timings: a kernel that does nothing,
# launched as power_peak launches (cudaLaunchKernelEx, 512 threads, a
# cluster attribute only when it splits a row), so its CUDA-event time is
# the launch's and the events' own cost on the device.
LAUNCH_PROBE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(512) empty_kernel() {}

extern "C" int tt_empty(long long ctas, int cluster, void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
  config.blockDim = dim3(512, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""


def build_phase(others=()):
    """Build every kernel source, the native host engine, the launch probe
    and the other power_peak sources ``others``, all at once; print each
    kernel instance's registers and spills and fail on any spill.
    Returns {label: library path} of the probe and the other sources."""
    phase("build")
    from concurrent.futures import ThreadPoolExecutor

    from thrifty_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    probe = os.path.join(_build.BUILD_DIR, "launch_probe.cu")
    with open(probe, "w") as f:
        f.write(LAUNCH_PROBE)
    jobs = {name: (name, None) for name in _build.sources()}
    jobs["launch_probe"] = ("launch_probe", probe)
    extra = {source_label(path): path for path in others}
    for label, path in extra.items():
        check(label not in jobs and label not in ("kernel", "plain"),
              "{}: label {!r} is taken".format(path, label))
        jobs[label] = ("power_peak_" + label, os.path.abspath(path))
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        native = pool.submit(native_engine)
        futures = {key: pool.submit(_build.build, name, True, source)
                   for key, (name, source) in jobs.items()}
        built = {key: f.result() for key, f in futures.items()}
        native_status = native.result()
    for key, (path, seconds, log) in built.items():
        if key in _build.sources():
            _build.load(key)
        print("built {} in {:.2f} s -> {}".format(
            key, seconds, os.path.relpath(path, ROOT)))
        entry = ""
        for line in log.splitlines():
            named = re.search(r"Compiling entry function '([^']+)'", line)
            if named:
                entry = instance_name(named.group(1))
            if "registers" in line or "spill" in line:
                print("  {}: {}".format(entry, line.strip()))
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            check(not spills or spills.groups() == ("0", "0"),
                  "{}: the kernel spills: {}".format(key, line.strip()))
    print("native host engine (thrifty_tpu_torch/native, g++): {}".format(
        native_status))
    return {label: built[label][0]
            for label in ["launch_probe"] + list(extra)}


def source_label(path):
    """The label of another power_peak source: its file name without
    power_peak_ and .cu."""
    name = os.path.splitext(os.path.basename(path))[0]
    return name[len("power_peak_"):] if name.startswith("power_peak_") \
        else name


def instance_name(mangled):
    """power_peak_kernel<interleaved, stats, vec> from its mangled name."""
    flags = re.search(r"power_peak_kernelILb(\d)ELb(\d)ELb(\d)E", mangled)
    if not flags:
        return mangled
    return "power_peak_kernel<{}>".format(", ".join(
        "{}={}".format(k, "true" if v == "1" else "false")
        for k, v in zip(("interleaved", "stats", "vec"), flags.groups())))


def native_engine():
    """Build and load the port's native host I/O engine; 'loaded' or
    why not (the host modules then take their numpy paths)."""
    try:
        from thrifty_tpu_torch import native
    except ImportError as e:
        return "not loaded ({})".format(e)
    return "loaded ({})".format(os.path.relpath(native.LIBRARY_PATH, ROOT))


TIMINGS = {
    "cold": "device time, L2 scrubbed before each call",
    "cold_clean": "device time, L2 refilled with other, clean data before "
                  "each call (a 256 MB read)",
    "warm": "device time, input read by the call before",
    "call": "call time, host launch included",
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet


def median_ms(fn, mode, scrub, reps=25, warmup=10):
    """Median of per-call CUDA-event times (``mode`` a key of TIMINGS).

    "cold", "cold_clean" and "warm" queue each call behind a ~1 ms device
    sleep, so the start event fires only after the host has queued the
    call and the interval is the device's time alone (the launch's own
    latency on the device included); "cold" also overwrites ``scrub``
    (larger than the 50 MB L2) after the sleep, so the input comes from
    HBM and the call also writes the scrub's dirty lines back as it
    evicts them; "cold_clean" reads ``scrub`` instead, so the L2 holds
    only clean lines.  "call" has no sleep, so the interval also holds
    the host's launch latency (the card idles while the wrapper runs).
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
        elif mode == "cold_clean":
            torch.sum(scrub)
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
    return compare_outputs(got, ref, what)


def compare_outputs(got, ref, what):
    got = [g.cpu().numpy() for g in got]
    ref = [r.cpu().numpy() for r in ref]
    check(np.array_equal(got[0], ref[0]), "idx differs: " + what)
    check(np.array_equal(got[1].view(np.uint32), ref[1].view(np.uint32)),
          "peak not bit-equal: " + what)
    max_rel = 0.0
    for g, r in zip(got[2:], ref[2:]):
        nan = np.isnan(r)
        check(np.array_equal(nan, np.isnan(g)), "sum NaNs differ: " + what)
        rel = float(np.max(np.abs(g - r)[~nan] / np.maximum(
            np.abs(r)[~nan], np.finfo(np.float32).tiny), initial=0.0))
        check(rel <= SUM_RTOL, "sum off by rel {:.3g}: {}".format(rel, what))
        max_rel = max(max_rel, rel)
    fin = np.isfinite(ref[1])
    max_abs = max(float(np.max(np.abs(got[0].astype(np.int64) - ref[0]))),
                  float(np.max(np.abs(got[1] - ref[1])[fin], initial=0.0)))
    return got, max_abs, max_rel


def boundary_rows(rows, n, sms, seed):
    """[rows, n] complex64 with maxima on the kernel's slice boundaries: a
    peak in the last column of a slice, equal powers at the last column of
    slice k and the first of slice k+1 (the earliest must win), a NaN in a
    later slice; a mask with a masked-out head."""
    from thrifty_tpu_torch.dsp import power_peak as pp

    rng = np.random.default_rng(seed)
    x = (rng.uniform(-0.02, 0.02, (rows, n))
         + 1j * rng.uniform(-0.02, 0.02, (rows, n))).astype(np.complex64)
    bounds = pp.slice_bounds(n, rows, sms)
    last = len(bounds) - 1
    for r in range(rows):
        k = r % len(bounds)
        if r % 3 == 0:
            x[r, bounds[k][1] - 1] = 5.0 + 1.0j
        elif r % 3 == 1 and last:
            k = min(k, last - 1)
            x[r, bounds[k][1] - 1] = 3.0 + 4.0j
            x[r, bounds[k + 1][0]] = 4.0 + 3.0j
        elif r % 3 == 2:
            x[r, n - 1 - r % min(n, 3)] = np.nan
    mask = np.ones(n, dtype=bool)
    if n >= 100:
        mask[1:n // 50] = False
    return x, mask


def first_wrapper(lib, x, mask):
    """The power_peak library through the host work of the port's first
    wrapper (interleaved, no stats): one output tensor each and a device
    context per call."""
    b, n = x.shape
    dev = x.device
    outs = [torch.empty(b, dtype=torch.int32, device=dev)] + [
        torch.empty(b, dtype=torch.float32, device=dev) for _ in range(2)]
    y = torch.view_as_real(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tt_power_peak(
            y.data_ptr(), y.data_ptr() + 4, mask.flags.data_ptr(), None,
            *[o.data_ptr() for o in outs], None, None,
            b, n, 2 * x.stride(0), 2, 1, stream)
    check(err == 0, "power_peak launch failed ({})".format(err))
    return tuple(outs)


def lib_call(lib, x, mask, smask=None, layout="interleaved"):
    """A power_peak library other than the port's (the same C interface)
    on the operands the port's wrapper passes: (idx, peak, total[,
    stat_pow, stat_mag])."""
    from thrifty_tpu_torch.dsp import power_peak as pp

    b, n = x.shape
    out = torch.empty((3 if smask is None else 5, b), dtype=torch.float32,
                      device=x.device)
    re_ptr, im_ptr, row_stride, elem_stride, inter, _keep = pp._operands(
        x, layout)
    base, step = out.data_ptr(), 4 * b
    stats = smask is not None
    err = lib.tt_power_peak(
        re_ptr, im_ptr, mask.flags.data_ptr(),
        smask.flags.data_ptr() if stats else None, base, base + step,
        base + 2 * step, base + 3 * step if stats else None,
        base + 4 * step if stats else None, b, n, row_stride, elem_stride,
        inter, torch.cuda.current_stream().cuda_stream)
    check(err == 0, "power_peak launch failed ({})".format(err))
    rows = out.unbind(0)
    return (rows[0].view(torch.int32),) + rows[1:]


def load_power_peak(path):
    """A built power_peak library with its C function typed."""
    import ctypes

    lib = ctypes.CDLL(path)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.tt_power_peak.restype = ctypes.c_int
    lib.tt_power_peak.argtypes = [p] * 9 + [i64] * 4 + [ctypes.c_int, p]
    return lib


def launch_floor(probe_path, card, scrub):
    """CUDA-event times of the empty launch probe at power_peak's grids:
    256 CTAs (one row each) and one row split over a cluster of 8."""
    import ctypes

    lib = ctypes.CDLL(probe_path)
    lib.tt_empty.restype = ctypes.c_int
    lib.tt_empty.argtypes = [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p]

    def run(ctas, cluster):
        err = lib.tt_empty(ctas, cluster,
                           torch.cuda.current_stream().cuda_stream)
        check(err == 0, "empty kernel launch failed ({})".format(err))

    floors = {}
    for ctas, cluster in ((256, 1), (8, 8)):
        floors[ctas, cluster] = {
            mode: median_ms(lambda: run(ctas, cluster), mode, scrub)
            for mode in ("cold", "warm")}
        print("empty kernel, {} CTAs of 512 threads, cluster {} "
              "(cudaLaunchKernelEx as power_peak launches): {}; {}".format(
                  ctas, cluster, ", ".join(
                      "{} {:.4f} ms".format(m, t)
                      for m, t in floors[ctas, cluster].items()), card))
    return floors


def kernel_bound_ms(rows, n, stats=False):
    """The least time for one call on the card: each input byte read once
    (complex64 rows, the uint8 masks), each output written once, over
    HBM's 3.35 TB/s (the flops, ~4 per sample, take ~1/30 of that at
    67 TFLOP/s float32)."""
    nbytes = rows * n * 8 + n * (2 if stats else 1) \
        + rows * 4 * (5 if stats else 3)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def kernel_phase(card, blocks_np, template, probe, extra=None):
    """power_peak kernel vs its plain version at the detect path's shapes,
    the edge cases of its launch plan, and its time at the main path's,
    the gated correlation's and the bank's shapes, beside the other
    power_peak libraries in ``extra`` ({label: library path}: earlier
    kernels or other designs with the same C interface) and the empty
    launch ``probe``."""
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
    bank_conj = torch.from_numpy(xcorr.template_fft_conj(code_bank(),
                                                         n)).to(dev)
    bank_rows = torch.fft.ifft(spec[:, None] * bank_conj).reshape(-1, n)
    gated = corr[:BATCH // 2].clone()
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
        ("corr_gated_128", gated, corr_mask),
        ("bank_768", bank_rows, corr_mask),
        ("last_column", last, np.ones(n, dtype=bool)),
        ("ragged", torch.from_numpy(ragged).to(dev),
         np.ones(1000, dtype=bool)),
        ("ties", torch.from_numpy(ties).to(dev),
         np.ones(2048, dtype=bool)),
    ]
    # The launch plan's edges: n from 1 to past 8 slices of 2048, rows
    # from 1 to a bank's 768, maxima and NaNs on slice boundaries, and an
    # input 8 bytes past a 16-byte boundary (the scalar path).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, m in ((3, 1), (3, 7), (3, 2049), (3, 16385), (1, 16384),
                    (32, 16384), (64, 16384), (128, 16384), (768, 16384)):
        x, mask = boundary_rows(rows, m, sms, seed=rows + m)
        cases.append(("boundaries_{}x{}".format(rows, m),
                      torch.from_numpy(x).to(dev), mask))
    x, mask = boundary_rows(6, n, sms, seed=3)
    buf = torch.empty(6 * n + 1, dtype=torch.complex64, device=dev)
    misaligned = buf[1:].view(6, n)
    misaligned.copy_(torch.from_numpy(x))
    check(misaligned.data_ptr() % 16 == 8, "misaligned view is aligned")
    cases.append(("misaligned_8", misaligned, mask))

    max_abs = 0.0
    max_rel = 0.0
    plans = set()
    for name, x, mask in cases:
        m = x.shape[1]
        sm_full = stats[:m] if m == n else np.arange(m) < (3 * m) // 4
        for layout in ("interleaved", "planes"):
            plan = pp.kernel_plan(x, mask, layout=layout)
            want = pp.cluster_plan(m, x.shape[0], sms)
            check(plan[:2] == want and plan[3] == sms,
                  "{}: kernel plan {} != {}".format(name, plan, want))
            plans.add((x.shape[0], m, layout, plan[:3]))
            for sm in (None, sm_full):
                what = "{} {} stats={}".format(name, layout, sm is not None)
                got, err, rel = held_against_plain(x, mask, sm, layout, what)
                max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
                again = pp.fused_power_peak(x, mask, stats_mask=sm,
                                            layout=layout)
                check(all(np.array_equal(g.view(np.uint32),
                                         a.cpu().numpy().view(np.uint32))
                          for g, a in zip(got[1:], again[1:])),
                      "two launches differ: " + what)
                if name == "ties":
                    check(np.all(got[0] == 300), "tie not earliest")
                if name == "last_column":
                    check(np.all(got[0] == n - 1), "last column missed")
    check(not any(p[3][2] for p in plans if p[1] % 2 and p[2] ==
                  "interleaved"), "odd n took the vector path")
    print("idx/peak bit-equal in {} comparisons, sums within {:.3g} (limit "
          "{:g}) and bit-equal between two launches; launch plans on {} "
          "SMs (rows, n, layout, (CTAs per row, columns per CTA, 16-byte "
          "loads)): {}".format(len(cases) * 4, max_rel, SUM_RTOL, sms,
                               sorted(plans)))
    extra = extra or {}
    others = {label: load_power_peak(path) for label, path in extra.items()}
    for label, lib in others.items():
        for name, x, mask in cases:
            m = x.shape[1]
            mask_obj = pp.Mask(mask, dev)
            for layout in ("interleaved", "planes"):
                for sm in (None, np.arange(m) < (3 * m) // 4):
                    sm_obj = None if sm is None else pp.Mask(
                        sm, dev, allow_empty=True)
                    got = lib_call(lib, x, mask_obj, sm_obj, layout)
                    what = "{} {} {} stats={}".format(label, name, layout,
                                                      sm is not None)
                    ref = pp.fused_power_peak_reference(
                        x.real, x.imag, mask_obj.bool,
                        None if sm is None else sm_obj.bool)
                    torch.cuda.synchronize()
                    compare_outputs(got, ref, what)
                    again = lib_call(lib, x, mask_obj, sm_obj, layout)
                    check(all(torch.equal(g.view(torch.int32),
                                          a.view(torch.int32))
                              for g, a in zip(got[1:], again[1:])),
                          "two launches differ: " + what)
        print("{} ({}) is bit-equal to plain in idx/peak on every case "
              "above, both layouts, with and without stats, and between "
              "two launches".format(label, os.path.relpath(extra[label],
                                                           ROOT)))

    # Time the correlation call (interleaved, no stats) at the main
    # path's [256, N], the gated [128, N] and the bank's [768, N], in
    # turns: plain, the other libraries, kernel, kernel, the others in
    # reverse, plain.
    mask_obj = pp.Mask(corr_mask, dev)
    stats_obj = pp.Mask(stats, dev, allow_empty=True)
    scrub = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    order = ("plain",) + tuple(others) + ("kernel", "kernel") \
        + tuple(reversed(list(others))) + ("plain",)

    def runs_for(x, sm=None):
        runs = {"kernel": lambda: pp.fused_power_peak(x, mask_obj, sm),
                "plain": lambda: pp.fused_power_peak_reference(
                    x.real, x.imag, mask_obj.bool,
                    None if sm is None else sm.bool)}
        for label, lib in others.items():
            runs[label] = lambda lib=lib: lib_call(lib, x, mask_obj, sm)
        return runs

    def time_turns(runs, modes, order):
        times = {}
        for mode in modes:
            for which in order:
                times.setdefault((which, mode), []).append(
                    median_ms(runs[which], mode, scrub))
        return times, {k: float(np.median(v)) for k, v in times.items()}

    def report(title, runs, times, med, modes):
        for mode in modes:
            print("{}, {}: {}; each turn the median of 25 CUDA-event "
                  "timings; {}".format(title, TIMINGS[mode], ", ".join(
                      "{} {:.4f} ms (turns {})".format(
                          which, med[which, mode], "/".join(
                              "{:.4f}".format(t) for t in times[which, mode]))
                      for which in runs), card))

    results = {}
    for label, x in (("main", corr), ("gated", gated), ("bank", bank_rows)):
        runs = runs_for(x)
        times, med = time_turns(runs, TIMINGS, order)
        report("power_peak [{}, {}] complex64".format(x.shape[0], n), runs,
               times, med, TIMINGS)
        bound, nbytes = kernel_bound_ms(*x.shape)
        for mode in ("cold", "cold_clean", "warm"):
            print("bound [{}, {}]: {:.0f} bytes / 3.35 TB/s = {:.4f} ms; {} "
                  "share of the bound: {}; {}".format(
                      x.shape[0], n, nbytes, bound, mode, ", ".join(
                          "{} {:.1%} ({:.0f} GB/s)".format(
                              which, bound / med[which, mode],
                              nbytes / 1e6 / med[which, mode])
                          for which in runs), card))
        results[label] = (med, bound)
    # The stats instance at the main shape (the detect path with a stddev
    # term: the correlation's first corr_len lags).
    runs = runs_for(corr, stats_obj)
    device_modes = ("cold", "cold_clean", "warm")
    times, med = time_turns(runs, device_modes, order)
    report("power_peak with stats [{}, {}] complex64".format(BATCH, n), runs,
           times, med, device_modes)
    bound, _ = kernel_bound_ms(BATCH, n, stats=True)
    print("bound with stats [{}, {}]: {:.4f} ms; cold share: {}; {}".format(
        BATCH, n, bound, ", ".join(
            "{} {:.1%}".format(which, bound / med[which, "cold"])
            for which in runs), card))
    # The wrapper's host work: the port's wrapper against the first one's
    # (three output tensors and a device context per call), both on this
    # checkout's kernel: call time in 10 pairs, alternating which runs
    # first, since the host's noise between turns is as large as the
    # difference.
    from thrifty_tpu_torch import _build

    pp._library()
    this_lib = _build.load("power_peak")
    wrappers = {"wrapper": lambda: pp._launch(corr, mask_obj, None,
                                              "interleaved"),
                "first wrapper": lambda: first_wrapper(this_lib, corr,
                                                       mask_obj)}
    times = {which: [] for which in wrappers}
    wins = 0
    for i in range(10):
        for which in (list(wrappers) if i % 2 == 0 else
                      list(reversed(list(wrappers)))):
            times[which].append(median_ms(wrappers[which], "call", scrub))
        wins += times["wrapper"][-1] < times["first wrapper"][-1]
    print("power_peak [{}, {}], this kernel through two wrappers, {}: {}; "
          "the port's wrapper faster in {} of 10 pairs; each turn the "
          "median of 25 CUDA-event timings; {}".format(
              BATCH, n, TIMINGS["call"], ", ".join(
                  "{} median {:.4f} ms (quartiles {:.4f}-{:.4f})".format(
                      which, *np.percentile(t, [50, 25, 75]))
                  for which, t in times.items()), wins, card))
    # The planes layout (the port of the Pallas `_kernel`), on planes made
    # beforehand: layout='planes' makes them from x first.
    fn = pp._library()
    re_p, im_p = corr.real.contiguous(), corr.imag.contiguous()
    out = torch.empty((3, BATCH), dtype=torch.float32, device=dev)

    def planes_kernel():
        base, step = out.data_ptr(), 4 * BATCH
        check(fn(re_p.data_ptr(), im_p.data_ptr(), mask_obj.flags.data_ptr(),
                 None, base, base + step, base + 2 * step, None, None, BATCH,
                 n, n, 1, 0, torch.cuda.current_stream().cuda_stream) == 0,
              "planes launch failed")

    planes = {"kernel": planes_kernel,
              "plain": lambda: pp.fused_power_peak_reference(
                  re_p, im_p, mask_obj.bool)}
    planes_kernel()
    compare_outputs((out[0].view(torch.int32), out[1], out[2]),
                    planes["plain"](), "planes kernel")
    times, med = time_turns(planes, device_modes,
                            ("plain", "kernel", "kernel", "plain"))
    report("power_peak planes [{}, {}] f32 x 2, the kernel alone".format(
        BATCH, n), planes, times, med, device_modes)
    tiny = corr[:1, :64].contiguous()
    tiny_mask = pp.Mask(np.ones(64, dtype=bool), dev)
    floor = {mode: median_ms(lambda: pp.fused_power_peak(tiny, tiny_mask),
                             mode, scrub) for mode in TIMINGS}
    print("floor: a [1, 64] call, {}; {}".format(", ".join(
        "{} {:.4f} ms".format(mode, t) for mode, t in floor.items()), card))
    launch_floor(probe, card, scrub)
    del scrub
    med, bound = results["main"]
    return {"name": "power_peak", "route": "cuda",
            "source": "thrifty_tpu_torch/csrc/power_peak.cu",
            "replaces": "thrifty_tpu/dsp/pallas_kernels.py:163",
            "max_abs_err": max_abs, "sum_max_rel_err": max_rel,
            "ms": med["kernel", "cold"], "plain_ms": med["plain", "cold"],
            "cold_clean_ms": med["kernel", "cold_clean"],
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


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
    from thrifty_tpu_torch.io import card
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
    from thrifty_tpu_torch.io import card
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

    def det(tmpl=template, **kw):
        return BatchDetector(tmpl, DetectorConfig(
            carrier_window=(7, 110), **kw), device=dev)

    gate = CarrierGate(16384, (7, 110), (0.0, 15.0, 0.0), history_len=4920,
                       device=dev)
    gate_std = CarrierGate(16384, (7, 110), STDDEV_THRESH, device=dev)
    bank = code_bank()
    bank_rows = torch.from_numpy(iq.iq_to_raw(bank_capture(bank))).to(dev)
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
        # New inputs: a bank's [B*T, N] and gated [C*T, N] correlation
        # rows, both stats masks, the capture gate's stats mask.
        "bank": (lambda: det(bank).submit_raw(bank_rows).result(),
                 [BATCH, 3 * BATCH]),
        "bank_gated": (lambda: det(bank, gate_capacity=BATCH // 2).submit_raw(
            bank_rows).result(), [BATCH, 3 * BATCH // 2]),
        "stats": (lambda: det(carrier_thresh=STDDEV_THRESH,
                              corr_thresh=CORR_STDDEV_THRESH).submit_raw(
            rows).result(), [BATCH, BATCH]),
        "bank_stats_preshift": (lambda: det(
            bank, sync_mode="preshift", carrier_thresh=STDDEV_THRESH,
            corr_thresh=CORR_STDDEV_THRESH).submit_raw(bank_rows).result(),
            [BATCH, 3 * BATCH]),
        "capture_gate_stddev": (lambda: gate_std(rows), [BATCH]),
        "peak_filter": (lambda: det(peak_filter_len=-1).submit_raw(
            rows).result(), [BATCH]),
    }
    orig = pp.fused_power_peak
    captured = []

    def spy(x, mask, stats_mask=None, layout="interleaved"):
        captured.append((x.clone(), mask, stats_mask))
        return orig(x, mask, stats_mask=stats_mask, layout=layout)

    worst_abs = worst_rel = 0.0
    for name, (fn, rows_per_launch) in paths.items():
        captured.clear()
        pp.fused_power_peak = spy
        try:
            fn()
        finally:
            pp.fused_power_peak = orig
        shapes = [tuple(x.shape) for x, _, _ in captured]
        check([s[0] for s in shapes] == rows_per_launch,
              "{}: launches on rows {}, expected {}".format(
                  name, shapes, rows_per_launch))
        stats = []
        for k, (x, mask, smask) in enumerate(captured):
            check(x.is_contiguous() and len(mask) == x.shape[1],
                  "{}: launch {} rows not contiguous or mask length {} != "
                  "{}".format(name, k, len(mask), x.shape[1]))
            _, err, rel = held_against_plain(
                x, mask, None if smask is None else smask.host,
                what="{} launch {}".format(name, k))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            stats.append("none" if smask is None else "{}/{}".format(
                int(smask.host.sum()), len(smask)))
        print("{}: {} launches on {} (stats masks {}), idx/peak bit-equal "
              "to plain".format(name, len(shapes), shapes, stats))
    print("sums max rel err {:.3g} (limit {:g})".format(worst_rel, SUM_RTOL))
    return worst_abs


def fastdet_phase(tmp):
    phase("fastdet goldens (integer sync)")
    from thrifty_tpu_torch.io import card

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


STDDEV_THRESH = (0.0, 15.0, 2.0)      # carrier: c + s*noise^2 + d*var
CORR_STDDEV_THRESH = (0.0, 15.0, 2.0)
CHIP_RATE = 0.999707e6


def code_bank():
    """The 3-code bank of tests/test_code_division.py: [3, 4914]."""
    from thrifty_tpu_torch.dsp import template as template_mod

    return template_mod.generate_bank(11, [0, 1, 2], 2.4e6 / CHIP_RATE)


def bank_capture(bank):
    """One batch of full-size blocks carrying code 1, a burst every 4."""
    from thrifty_tpu_torch import sim

    return sim.synth_capture(num_blocks=BATCH, bursts_every=4,
                             template=bank[1], seed=1).blocks


def device_launches(fn, reps=3):
    """Device kernels per call of ``fn`` (every kernel, not only the
    port's own), counted by torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events) / reps


# The .toad comparison of tests/test_golden_interp.py.
INTERP = os.path.join(GOLDEN, "interp")
INTERP_CASES = {
    "corr_parabolic": (["--corr-interp", "parabolic"], "tight"),
    "corr_cosine": (["--corr-interp", "cosine"], "tight"),
    "corr_none": (["--corr-interp", "none"], "tight"),
    "corr_autocorr": (["--corr-interp", "autocorr"],
                      dict(hi=1e-2, median=1e-2, max=0.5)),
    "corr_maximise": (["--corr-interp", "maximise"],
                      dict(hi=3e-3, median=2e-3, max=0.05)),
    "carrier_parabolic": (["--carrier-interp", "parabolic"], "tight"),
    "carrier_gaussian": (["--carrier-interp", "gaussian"], "tight"),
    "carrier_cosine": (["--carrier-interp", "cosine"], "tight"),
    "carrier_none": (["--carrier-interp", "none"], "tight"),
    "preshift": (["--sync-mode", "preshift",
                  "--carrier-interp", "parabolic"], "tight"),
}


def compare_interp(got, ref, spec, what):
    check(got.shape == ref.shape, "{}: {} vs {} detections".format(
        what, got.shape[0], ref.shape[0]))
    for col in TOAD_INT_COLS:
        check(np.array_equal(got[:, col], ref[:, col]),
              "{}: toad column {} differs".format(what, col))
    for col, tol in ((9, dict(atol=1e-4)), (10, dict(rtol=1e-3)),
                     (11, dict(rtol=1e-2)), (6, dict(rtol=1e-3, atol=1e-3)),
                     (7, dict(rtol=1e-2, atol=1e-3))):
        check(np.allclose(got[:, col], ref[:, col], **tol),
              "{}: toad column {} beyond {}".format(what, col, tol))
    d = np.abs(got[:, 5] - ref[:, 5])
    if spec == "tight":
        check(d.max() < 1e-4, "{}: corr_offset max {:.2e}".format(
            what, d.max()))
        check(np.allclose(got[:, 3], ref[:, 3], atol=1e-3),
              "{}: soa beyond 1e-3".format(what))
        return d.max()
    hi = ref[:, 6] / np.maximum(ref[:, 7], 1e-12) > 10.0
    check(hi.any() and (~hi).any(), what + ": capture must span SNRs")
    check(d[hi].max() < spec["hi"] and np.median(d) < spec["median"]
          and d.max() < spec["max"],
          "{}: corr_offset hi {:.2e} median {:.2e} max {:.2e}".format(
              what, d[hi].max(), np.median(d), d.max()))
    return d.max()


def interp_golden_phase(tmp):
    """(a) The interpolator, carrier and preshift goldens of the
    reference's experimental drivers, through the port's CLI on the
    card."""
    phase("interp goldens")
    from thrifty_tpu_torch.io import card

    src = os.path.join(INPUT, "rx0.card")
    blocks = len(card.read_card(src)[0])
    common = ["--carrier-window", "7-110", "--quiet", "--rxid", "0",
              "--template", os.path.join(INPUT, "template.npy"),
              "--batch-size", str(BATCH), "--device", "cuda"]
    per_batch = {}
    for name, (extra, spec) in INTERP_CASES.items():
        out = os.path.join(tmp, name + ".toad")
        _, per_batch["detect_" + name] = run_cli(
            "detect", [src, "-o", out] + common + extra, blocks, 2)
        err = compare_interp(load_toad(out), load_toad(os.path.join(
            INTERP, "rx0_{}.toad".format(name))), spec, name)
        print("{}: matches rx0_{}.toad (max |corr_offset - golden| "
              "{:.2e}); 2 kernel launches per batch".format(name, name, err))
    return per_batch


# tests/test_code_division.py's network; its 0.02-0.36 s schedule is
# repeated every 0.4 s over the longer capture.
CD_RX_POS = {0: np.array([0.0, 0.0]), 1: np.array([9000.0, 500.0]),
             2: np.array([4000.0, 8000.0])}
CD_BEACON_POS = {0: np.array([4500.0, 3000.0])}
CD_MOBILE_POS = {2: np.array([6000.0, 2500.0])}
CD_BLOCKS = 2 * BATCH
# DETECTION_DTYPE field -> TOAD_TOLS column.
TOAD_FIELDS = {"timestamp": 1, "soa": 3, "offset": 5, "energy": 6,
               "noise": 7, "carrier_offset": 9, "carrier_energy": 10,
               "carrier_noise": 11}


def code_division_captures(bank, num_blocks=CD_BLOCKS):
    from thrifty_tpu_torch import sim

    reps = max(1, int(num_blocks * NEW_LEN / 2.4e6 / 0.4))
    schedule = []
    for k in range(reps):
        schedule += [(0, t + 0.4 * k) for t in np.arange(0.02, 0.36, 0.05)]
        schedule += [(2, t + 0.4 * k) for t in (0.085, 0.185, 0.285)]
    caps = sim.synth_rx_captures(
        rx_pos=CD_RX_POS, tx_pos={**CD_BEACON_POS, **CD_MOBILE_POS},
        tx_bins={0: 40, 2: 40}, tx_schedule=schedule, template=bank[0],
        num_blocks=num_blocks, amplitude=0.6, noise_std=0.04,
        clock_offsets={1: 777.25, 2: -123.5},
        clock_drifts={1: 3e-6, 2: -2e-6}, seed=11,
        tx_codes={0: bank[0], 2: bank[2]})
    return ({rx: (c.timestamps, c.indices, c.blocks)
             for rx, c in caps.items()}, len(schedule),
            sum(1 for tx, _ in schedule if tx == 2))


def run_code_division(caps, bank, dev, batch=BATCH, **kw):
    """kitchen_sink.detect_all(txid_from_template) -> postdetect(keep_
    txid) on ``dev``, the batched solver on ``dev``; returns (result,
    power_peak launches)."""
    import functools

    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.pipeline import kitchen_sink, pos

    det = BatchDetector(bank, DetectorConfig(carrier_window=(7, 110), **kw),
                        device=dev)
    pp.launches = 0
    detections = kitchen_sink.detect_all(caps, det, batch_size=batch,
                                         txid_from_template=True)
    launches = pp.launches
    settings = kitchen_sink.PostdetectSettings(
        freqmap=None, match_window=0.02, tdoa_est_window=8.0,
        rx_pos=CD_RX_POS, beacon_pos=CD_BEACON_POS, sample_rate=2.4e6,
        keep_txid=True)
    return kitchen_sink.postdetect(
        detections, settings, pos_estimator=functools.partial(
            pos.solve_batched, device=dev)), launches


def compare_code_division(got, ref, what):
    check(len(got.toads) == len(ref.toads), "{}: {} vs {} toads".format(
        what, len(got.toads), len(ref.toads)))
    for k in ("rxid", "txid", "block", "sample", "carrier_bin"):
        check(np.array_equal(got.toads[k], ref.toads[k]),
              "{}: toads field {} differs".format(what, k))
    for k, col in TOAD_FIELDS.items():
        check(np.allclose(got.toads[k], ref.toads[k], **TOAD_TOLS[col]),
              "{}: toads field {} beyond {}".format(what, k, TOAD_TOLS[col]))
    check([sorted(m) for m in got.matches] == [sorted(m) for m in
                                                ref.matches],
          what + ": matches differ")
    check(np.array_equal(got.pos["group_id"], ref.pos["group_id"]),
          what + ": fixes differ")
    err = np.hypot(got.pos["x"] - ref.pos["x"], got.pos["y"] - ref.pos["y"])
    check(err.max() < 0.05, "{}: cuda vs cpu fix {:.3g} m".format(
        what, err.max()))
    return err.max()


def code_division_phase():
    """(b) The code-division path at full width: 3 receivers, a 3-code
    bank [3, 4914], detect_all -> postdetect on the card against the same
    run on the CPU, in fractional sync (ungated and gated at capacity
    128), preshift sync and with the autocorr interpolator."""
    phase("code division")
    bank = code_bank()
    t0 = time.perf_counter()
    caps, sent, mobile = code_division_captures(bank)
    print("synthesised 3 receivers x {} blocks, {} transmissions ({} "
          "mobile) in {:.1f} s".format(CD_BLOCKS, sent, mobile,
                                       time.perf_counter() - t0))
    batches = 3 * math.ceil(CD_BLOCKS / BATCH)
    per_batch = {}
    for name, kw in (("bank", {}),
                     ("bank_gated", dict(gate_capacity=BATCH // 2)),
                     ("bank_preshift", dict(sync_mode="preshift")),
                     ("bank_autocorr", dict(corr_interp="autocorr"))):
        got, launches = run_code_division(caps, bank, torch.device("cuda"),
                                          **kw)
        check(launches == 2 * batches, "{}: {} kernel launches for {} "
              "batches".format(name, launches, batches))
        per_batch[name] = launches / batches
        t0 = time.perf_counter()
        ref, _ = run_code_division(caps, bank, torch.device("cpu"), **kw)
        cpu_s = time.perf_counter() - t0
        err = compare_code_division(got, ref, name)
        check(set(np.unique(got.toads["txid"])) == {0, 2},
              name + ": txids are not {0, 2}")
        check(len(got.toads) == 3 * sent, "{}: {} toads for {} "
              "transmissions x 3 receivers".format(name, len(got.toads),
                                                   sent))
        check(len(got.pos) == mobile, "{}: {} fixes for {} mobile "
              "transmissions".format(name, len(got.pos), mobile))
        miss = np.hypot(got.pos["x"] - CD_MOBILE_POS[2][0],
                        got.pos["y"] - CD_MOBILE_POS[2][1])
        check(miss.max() < 60.0, "{}: mobile fix {:.1f} m off".format(
            name, miss.max()))
        print("{}: txids {{0, 2}}, {} toads, {} fixes, worst {:.2f} m from "
              "the mobile; toads, matches and fixes equal to the CPU run "
              "(fixes within {:.2g} m; CPU took {:.1f} s); {} kernel "
              "launches per batch".format(name, len(got.toads), len(got.pos),
                                          miss.max(), err, cpu_s,
                                          per_batch[name]))
    return per_batch


SOLVER_GROUPS = 8192
RX4 = {0: np.array([0.0, 0.0]), 1: np.array([9000.0, 500.0]),
       2: np.array([4000.0, 8000.0]), 3: np.array([-2000.0, 6000.0])}
RX4_3D = {0: np.array([0.0, 0.0, 0.0]), 1: np.array([9000.0, 500.0, 300.0]),
          2: np.array([4000.0, 8000.0, -200.0]),
          3: np.array([-2000.0, 6000.0, 600.0])}
# tests/test_pos.py's near-collinear and near-coplanar arrays.
COLLINEAR = {0: np.array([2066.0, -1867.0]), 1: np.array([439.0, 29.0]),
             2: np.array([-1205.0, 1922.0]),
             3: np.array([-2837.0, 3821.0])}
COPLANAR = {0: np.array([-29181.41857066, 25948.32954709, -222.0839601]),
            1: np.array([16777.85870735, 22205.93886653, 162.13191117]),
            2: np.array([8084.68323547, -17724.71793607, -203.5907017]),
            3: np.array([2359.35794116, -20197.98664509, 174.45982677])}
PAIRS6 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def forward_groups(rx_pos, n, seed, noise=10e-9):
    """``n`` TDOA groups from the forward model: transmitters spread
    over the array's box (+2 km; z in [0, 1500] m in 3-D), the 6 pairs
    (4 in every third group: ragged), Gaussian TDOA noise."""
    from thrifty_tpu_torch.pipeline import tdoa

    rng = np.random.default_rng(seed)
    coords = np.array(list(rx_pos.values()))
    lo, hi = coords.min(0) - 2000.0, coords.max(0) + 2000.0
    if coords.shape[1] == 3:
        lo[2], hi[2] = 0.0, 1500.0
    txs = rng.uniform(lo, hi, (n, coords.shape[1]))
    a = np.array([p[0] for p in PAIRS6])
    b = np.array([p[1] for p in PAIRS6])
    dist = np.linalg.norm(txs[:, None, :] - coords[None], axis=-1)
    t = (dist[:, a] - dist[:, b]) / tdoa.SPEED_OF_LIGHT
    t += rng.normal(0.0, noise, t.shape)
    groups = []
    for i in range(n):
        k = 4 if i % 3 == 0 else 6
        rows = np.zeros(k, dtype=tdoa.TDOA_DTYPE)
        rows["rx0"], rows["rx1"], rows["tdoa"] = a[:k], b[:k], t[i, :k]
        rows["snr"], rows["model_quality"] = 100.0, 1.0
        groups.append(tdoa.TdoaGroup(group_id=i, timestamp=float(i), tx=3,
                                     tdoas=rows))
    return groups


def residual_norms(fixes, rx_pos, groups):
    from thrifty_tpu_torch.pipeline import tdoa

    out = np.empty(len(groups))
    names = [k for k in ("x", "y", "z") if k in fixes.dtype.names]
    for i, g in enumerate(groups):
        p = np.array([fixes[k][i] for k in names])
        d0 = np.linalg.norm(np.array([rx_pos[int(r)] for r in g.tdoas["rx0"]])
                            - p, axis=1)
        d1 = np.linalg.norm(np.array([rx_pos[int(r)] for r in g.tdoas["rx1"]])
                            - p, axis=1)
        out[i] = np.linalg.norm(d0 - d1 - g.tdoas["tdoa"]
                                * tdoa.SPEED_OF_LIGHT)
    return out


def solver_phase(card_name):
    """(d) The batched position solver at 8192 groups on the card: against
    the port on the CPU (float64) and scipy's solve."""
    phase("batched solver")
    from thrifty_tpu_torch.pipeline import pos

    dev = torch.device("cuda")
    timings = {}
    for name, rx_pos, n in (("2d", RX4, SOLVER_GROUPS),
                            ("3d", RX4_3D, SOLVER_GROUPS),
                            ("collinear", COLLINEAR, 1024),
                            ("coplanar", COPLANAR, 1024)):
        groups = forward_groups(rx_pos, n, seed=len(name))
        got = pos.solve_batched(groups, rx_pos, device=dev)
        t0 = time.perf_counter()
        ref = pos.solve_batched(groups, rx_pos, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(len(got) == len(ref) == n, name + ": groups skipped")
        names = [k for k in ("x", "y", "z") if k in got.dtype.names]
        diff = np.sqrt(sum((got[k] - ref[k]) ** 2 for k in names))
        res_got = residual_norms(got, rx_pos, groups)
        res_ref = residual_norms(ref, rx_pos, groups)
        # Beyond 1e-6 m only where the two fixes are minima of equal
        # residual (mirror minima, flat valleys): float64 rounding of
        # the two libraries picks between them.
        far = diff > 1e-6
        check(np.all(np.abs(res_got - res_ref)[far]
                     <= 1e-9 * res_ref[far] + 1e-9),
              "{}: cuda vs cpu fixes differ at unequal residual".format(name))
        # scipy on the first 512 groups.  On the 2-D array, test_pos's
        # assertions: no residual worse than scipy's by 1% + 1 m, and
        # fixes within 0.5 m where the residuals match.  The 4-receiver
        # 3-D array (3 independent TDOAs), the collinear and the
        # coplanar arrays have distinct minima of equal residual, and
        # the multi-start solver (JAX's as well) misses scipy's minimum
        # on a few coplanar groups: those counts are printed.
        m = 512
        sp = pos.solve(groups[:m], rx_pos, verbose=False)
        res_sp = residual_norms(sp, rx_pos, groups[:m])
        worse = res_got[:m] > res_sp * 1.01 + 1.0
        same = np.abs(res_got[:m] - res_sp) <= 1e-6 * res_sp + 1e-6
        sp_diff = np.sqrt(sum((got[k][:m] - sp[k]) ** 2 for k in names))
        if name == "2d":
            check(not worse.any(), name + ": residual worse than scipy's")
            check(np.all(sp_diff[same] < 0.5),
                  name + ": fix > 0.5 m from scipy at equal residual")
        # Device program alone, host set-up excluded.
        args = solver_inputs(groups, rx_pos)
        call = lambda: pos.solve_groups_batched(*args, iters=30, device=dev)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        launches = device_launches(call, reps=1)
        timings[name] = float(np.median(ms))
        print("{}: {} groups, cuda vs cpu max {:.3g} m ({} beyond 1e-6 m, all "
              "at equal residual); first {} vs scipy: {} worse than scipy's "
              "residual by > 1% + 1 m, {} at equal residual ({} of them "
              "> 0.5 m apart: other minima); solver {:.2f} ms per call "
              "(median of 5, CUDA events, H2D and D2H included; cpu {:.2f} s "
              "per solve_batched), {:.0f} device kernels per call; {}".format(
                  name, n, diff.max(), int(far.sum()), m, int(worse.sum()),
                  int(same.sum()), int((sp_diff[same] >= 0.5).sum()),
                  timings[name], cpu_s, launches, card_name))
    return timings


def solver_inputs(groups, rx_pos):
    from thrifty_tpu_torch.pipeline import pos

    pmax = max(len(g.tdoas) for g in groups)
    dims = len(next(iter(rx_pos.values())))
    n = len(groups)
    tp, mask = np.zeros((n, pmax)), np.zeros((n, pmax), bool)
    rx0, rx1 = np.zeros((n, pmax, dims)), np.zeros((n, pmax, dims))
    for i, g in enumerate(groups):
        k = len(g.tdoas)
        tp[i, :k], mask[i, :k] = g.tdoas["tdoa"], True
        rx0[i, :k] = [rx_pos[int(a)] for a in g.tdoas["rx0"]]
        rx1[i, :k] = [rx_pos[int(b)] for b in g.tdoas["rx1"]]
        rx0[i, k:], rx1[i, k:] = rx0[i, 0], rx1[i, 0]
    coords = np.array(list(rx_pos.values()))
    return tp, mask, rx0, rx1, (coords.min(0) - pos.MAX_DIST,
                                coords.max(0) + pos.MAX_DIST)


def chain_phase(tmp):
    """(e) The golden positioning chain through the port's CLI: detect on
    the card -> identify -> match -> tdoa -> pos, and pos --batched on
    the card, against tests/golden/data.tdoa and data.pos."""
    phase("positioning chain")
    from thrifty_tpu_torch.cli import main as cli

    tpl = os.path.join(INPUT, "template.npy")
    for rxid in (0, 1, 2):
        detect([os.path.join(INPUT, "rx{}.card".format(rxid)), "-o",
                os.path.join(tmp, "c{}.toad".format(rxid))]
               + common_args("cuda", tpl, rxid) + ["--carrier-window",
                                                   "7-110"])
    d = lambda name: os.path.join(tmp, name)
    rx_cfg = os.path.join(INPUT, "pos-rx.cfg")
    for args in (["identify"] + [d("c{}.toad".format(i)) for i in range(3)]
                 + ["-o", d("c.toads"), "-m",
                    os.path.join(INPUT, "freq-map.cfg")],
                 ["match", d("c.toads"), "-o", d("c.match"), "-w", "0.02"],
                 ["tdoa", d("c.toads"), d("c.match"), "-o", d("c.tdoa"),
                  "-r", rx_cfg, "-b", os.path.join(INPUT, "pos-beacon.cfg")],
                 ["pos", d("c.tdoa"), "-o", d("c.pos"), "-r", rx_cfg],
                 ["pos", d("c.tdoa"), "-o", d("b.pos"), "-r", rx_cfg,
                  "--batched", "--device", "cuda"]):
        check(cli(args) == 0, "{} failed".format(args[0]))
    ref, got = load_toad(os.path.join(GOLDEN, "data.tdoa")), \
        load_toad(d("c.tdoa"))
    check(got.shape == ref.shape, "data.tdoa: different group structure")
    check(np.array_equal(got[:, (0, 2, 3, 4, 8, 9)],
                         ref[:, (0, 2, 3, 4, 8, 9)]), "data.tdoa ids differ")
    check(np.allclose(got[:, 1], ref[:, 1], atol=1e-9)
          and np.allclose(got[:, 5], ref[:, 5], atol=0.01)
          and np.allclose(got[:, 6:8], ref[:, 6:8], atol=0.05),
          "data.tdoa beyond tolerance")
    ref = load_toad(os.path.join(GOLDEN, "data.pos"))
    for name, pos_tol in (("c.pos", 0.05), ("b.pos", 0.5)):
        got = load_toad(d(name))
        check(got.shape == ref.shape, name + ": different fix count")
        check(np.array_equal(got[:, (0, 2)], ref[:, (0, 2)]),
              name + ": group/tx differ")
        check(np.allclose(got[:, 1], ref[:, 1], atol=1e-9)
              and np.allclose(got[:, 3], ref[:, 3],
                              **(dict(atol=1e-5) if name == "c.pos"
                                 else dict(rtol=1e-3)))
              and np.allclose(got[:, 4], ref[:, 4], rtol=0.05)
              and np.allclose(got[:, 5:], ref[:, 5:], atol=pos_tol),
              "{}: beyond tolerance of data.pos".format(name))
    print("detect (cuda) -> identify -> match -> tdoa -> pos: data.tdoa "
          "and data.pos ({} fixes) within tests/test_golden_reference.py's "
          "tolerances; pos --batched --device cuda within 0.5 m".format(
              len(ref)))


def program_timings(card_name, template):
    """ms and device kernels per 256-block batch of the new detect
    programs (CUDA events around 10 batches queued back to back)."""
    phase("program timings")
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = torch.device("cuda")
    bank = code_bank()
    rows = torch.from_numpy(iq.iq_to_raw(bank_capture(bank))).to(dev)
    out = {}
    for name, tmpl, kw in (
            ("fractional", template, {}),
            ("bank", bank, {}),
            ("preshift", template, dict(sync_mode="preshift")),
            ("bank_preshift", bank, dict(sync_mode="preshift")),
            ("autocorr", template, dict(corr_interp="autocorr")),
            ("maximise", template, dict(corr_interp="maximise")),
            ("stats", template, dict(carrier_thresh=STDDEV_THRESH,
                                     corr_thresh=CORR_STDDEV_THRESH)),
            ("peak_filter", template, dict(peak_filter_len=-1))):
        det = BatchDetector(tmpl, DetectorConfig(carrier_window=(7, 110),
                                                 **kw), device=dev)
        fn = lambda: det.submit_raw(rows)
        ms = [events_ms(fn) for _ in range(2)]
        launches = device_launches(fn)
        out[name] = (float(np.median(ms)), launches)
        print("{}: {} ms per {}-block batch (2 turns, CUDA events around 10 "
              "batches queued back to back), {:.0f} device kernels per "
              "batch; {}".format(name, "/".join("{:.3f}".format(m)
                                                for m in ms),
                                 BATCH, launches, card_name))
    return out


def options_phase(card_name, tmp, cap, tpl_path, raw_path):
    """Launches per batch of the detect options that change the kernel's
    inputs or count, through the CLI on the full-size capture: stddev
    terms (both stats masks), the peak filter (1 launch: the carrier
    search is torch ops), the polyfit carrier fit (the one interpolator
    without a reference golden), and the capture gate with a stddev
    term."""
    phase("detect options through the CLI")
    n = len(cap.indices)
    card_path = os.path.join(tmp, "full.card")
    ref = load_toad(os.path.join(tmp, "full_gpu.toad"))
    per_batch = {}
    for name, extra, launches in (
            ("detect_stats", ["--carrier-threshold", "15s+2d",
                              "--corr-threshold", "15s+2d"], 2),
            ("detect_peak_filter", ["--peak-filter", "-1"], 1),
            ("detect_carrier_polyfit", ["--carrier-interp", "polyfit"], 2)):
        out = os.path.join(tmp, name + ".toad")
        seconds, per_batch[name] = run_cli(
            "detect", [card_path, "-o", out] + common_args("cuda", tpl_path)
            + extra, n, launches)
        got = load_toad(out)
        check_bursts(got, cap, name)
        print("{}: {} detections ({} without the option), every burst "
              "within 0.05 samples; {} kernel launches per batch; CLI {:.4g} "
              "IQ samples/s; {}".format(name, len(got), len(ref), launches,
                                         n * NEW_LEN / seconds, card_name))
    out = os.path.join(tmp, "cap_std.card")
    _, per_batch["capture_gate_stddev"] = run_cli("capture", [
        "--raw-in", raw_path, "-o", out, "--quiet", "--carrier-window",
        "7-110", "--carrier-threshold", "15s+2d", "--batch-size",
        str(BATCH), "--device", "cuda"], n, 1)
    print("capture --carrier-threshold 15s+2d: {} blocks archived; 1 kernel "
          "launch per batch".format(len(card_lines(out))))
    return per_batch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--baseline", metavar="CU", action="append", default=[],
        help="an earlier or another power_peak source with the same C "
             "interface (named power_peak_<label>.cu), built, held against "
             "the plain version on every kernel case and timed in turns "
             "beside the kernel of this checkout; repeatable")
    args = parser.parse_args(argv)
    card_name = card_phase()
    built = build_phase(args.baseline)
    probe = built.pop("launch_probe")

    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import iq

    template = np.load(os.path.join(INPUT, "template.npy"))
    cap = sim.synth_capture(num_blocks=512, bursts_every=4,
                            template=template, seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        kernel = kernel_phase(card_name, cap.blocks[:BATCH], template,
                              probe, built)
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
        paths.update(options_phase(card_name, tmp, cap, tpl_path, raw_path))
        paths.update(interp_golden_phase(tmp))
        paths.update(code_division_phase())
        chain_phase(tmp)
        solver_phase(card_name)
        timing_phase(card_name, tmp, cap, template, raw_path)
        program_timings(card_name, template)
        kernel["paths"] = sorted(paths)
        kernel["launches_per_batch"] = paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                    ("jax", "jaxlib", "thrifty_tpu"))
    check(not loaded, "imported {}".format(loaded))
    print(json.dumps({"kernels": [kernel]}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
