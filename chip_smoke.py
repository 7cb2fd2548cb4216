#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``thrifty_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the detect path's
shapes and on the inputs each path of the port gives it (capture gate
with and without a stddev term, integer sync, gated correlation and its
overflow, device unfold, a template bank's [B*T, N] rows and the gated
bank's [C*T, N] rows, both stats masks, the peak filter), holds the three
fit kernels of ``csrc/fits.cu`` (the Dirichlet carrier fit, the autocorr
fit, the maximise search) against their plain versions on the inputs of
every detect program that selects them -- each program run once with
every launch count set to 0, each fit one launch per stage call -- and
on edge rows, and times them at the main path's shapes beside their
bounds and the empty launch, then drives the port on the card:

- ``detect`` on the committed golden captures against the reference
  ``.toad`` goldens, and on a full-size synthetic capture (block 16384,
  history 4920, batch 256, the 4914-sample golden template) against its
  ground truth and against the same CLI on the CPU -- the main path,
  whose kernel runs the JSON line reports; then this slice's own
  paths, ``detect --corr-interp autocorr`` and ``maximise`` at full
  width (1 run of the named fit per batch).  A CLI run's kernels are
  counted by name in a device trace (``device_kernels()``), where a
  CUDA graph's replay runs them too; elsewhere the kernels' launch
  counters, which count their launchers' calls, are held to the
  program runs (``_detect_batch``: eager or captured; a gated batch's
  re-run from its bytes, ``_redo_program``) that called them;
- the transform family (``dsp/mxu_fft.py``): ``fft``, ``ifft``,
  ``ifft_head``, ``windowed_dft`` (the carrier window, W = 110, and a
  wrapped window) and ``fft_ramped`` as matmul and matmul3 at each
  precision against the float64 FFT at [256, 16384], the dense n = 1024
  and the unfactorable n = 6000 (TF32 off after every call), with their
  cold-L2 times and bounds beside cuFFT's; ``detect`` under
  ``--fft-impl matmul`` (windowed carrier, separable ramp), with
  ``matmul3`` and with TF32 transforms, against the default run and the
  ground truth, and with stddev threshold terms (the full-FFT carrier
  stage) against the torch.fft run with the same terms; the golden cards under ``--fft-impl matmul``; ``capture
  --fft-impl matmul`` against fastcard's archive; ``--pallas off`` (the
  plain reductions) refused on the card, by the CLI and the detector,
  before any launch;
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
- the live server (``PositioningServer``, batched solver on the card) on
  the JAX bench's serve mix at 20k detections against the same server on
  the CPU, and at 100k (the 10x density), with fixes/s, ms per step and
  device kernels per step; ``serve --once --track`` through the CLI on
  tailed ``.toad`` files against the server run in process;
- ``template_extract`` on the card against the CPU on the full-size
  capture and on ``rx0.card``; ``doctor --selfcheck --batch 256``;
- the ``bench`` command's programs at the deployment's geometry: the
  batch program with a 64/128/256 sweep, complex64 input in integer
  sync, ``selfcheck --wide``, an A/B of ``fft_impl=matmul``, the knee
  A/B of ``gate_capacity=64``, ``e2e`` on a raw stream (host and device
  unfold) and on a ``.card``, ``serve``, and ``stream`` in a child
  process (a NCCL world of one): each rc 0, its JSON line's contract,
  and the power/peak launches of every batch it queued;
- the multi-rank streaming program (``thrifty_tpu_torch.parallel``), as
  ``__graft_entry__.dryrun_multichip`` runs JAX's: a gloo world of 4
  spawned ranks on an (rx=2, time=2) mesh, all on the one card, at a
  tiny and at the full geometry (plain, gated, the GSPMD twin, 2-code
  banks; planted bursts across the rank boundary) against ground truth
  and the single-process detector, the network demo's scenario through
  identify -> match -> tdoa -> pos against the same chain in one CPU
  process, and a world of 1 over NCCL; power/peak launches per rank and
  ms per rank call split into halo exchange, detect and gather;
- the port's tool scripts (the tools phase), each in a child process as
  a user runs it: ``scripts/validation_sweep_torch.py`` (20 trials, every
  suite clean), ``card_golden_check_torch.py`` at ``--tol-scale 1``,
  plain and gated, ``chip_rate_search_torch.py`` and
  ``deploy/detect_torch.sh`` (a raw capture through its FIFO, stopped by
  SIGTERM) side by side, then ``card_ab_time_torch.py --ab
  fft_impl=matmul`` (its paired verdict) and ``scaling_sweep_torch.py``
  (tiny 1x1, 1x2, 2x2 with gloo ranks sharing the card; full 1x1); a
  ``sitecustomize`` hook reads every child's power/peak launches, held
  to the batches it queued;
- timings of the detect programs, the solver and the CLIs, each printed
  with the card's name and power limit.

Every phase raises on failure, so a non-zero exit means a failed phase;
without a CUDA card it fails at once.  Neither JAX nor anything of the
JAX package is imported: captures are written and synthesised with the
port's own host modules (``io.card``, ``sim``, ``dsp.template``,
``pipeline.tdoa``), and the script checks ``sys.modules`` at its end.

Output: lines for each phase, then a JSON line describing each kernel,
power/peak and the three fits (with the paths that launched it and their
launches per batch), the
card's name and power limit as ``nvidia-smi`` reports them, and, as the
last line, ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
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
    """power_peak_kernel<interleaved, stats, vec>, or a fit kernel's name,
    from its mangled name."""
    flags = re.search(r"power_peak_kernelILb(\d)ELb(\d)ELb(\d)E", mangled)
    if not flags:
        fit = re.search(r"(dirichlet_fit_kernel|autocorr_fit_kernel|"
                        r"maximise_kernel)", mangled)
        return fit.group(1) if fit else mangled
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


def empty_launcher(probe_path):
    """``run(ctas, cluster)``: one launch of the empty probe kernel."""
    import ctypes

    lib = ctypes.CDLL(probe_path)
    lib.tt_empty.restype = ctypes.c_int
    lib.tt_empty.argtypes = [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p]

    def run(ctas, cluster):
        err = lib.tt_empty(ctas, cluster,
                           torch.cuda.current_stream().cuda_stream)
        check(err == 0, "empty kernel launch failed ({})".format(err))

    return run


def launch_floor(probe_path, card, scrub):
    """CUDA-event times of the empty launch probe at power_peak's grids:
    256 CTAs (one row each) and one row split over a cluster of 8."""
    run = empty_launcher(probe_path)
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

    tpl_path = os.path.join(INPUT, "template.npy")
    for rxid in (0, 1, 2):
        src = os.path.join(INPUT, "rx{}.card".format(rxid))
        out = os.path.join(tmp, "rx{}.toad".format(rxid))
        batches = math.ceil(len(card.read_card(src)[0]) / BATCH)
        with device_kernels() as ran:
            detect([src, "-o", out] + common_args("cuda", tpl_path, rxid))
        check(ran["power_peak"] == 2 * batches,
              "rx{}: {} kernel runs for {} batches".format(
                  rxid, ran["power_peak"], batches))
        got = load_toad(out)
        compare_toads(got, load_toad(os.path.join(
            GOLDEN, "rx{}.toad".format(rxid))), "rx{}".format(rxid))
        print("rx{}: {} detections match the reference golden; {} kernel "
              "runs".format(rxid, len(got), ran["power_peak"]))


def full_size_phase(card_name, tmp, cap):
    phase("full-size slice")
    from thrifty_tpu_torch.io import card
    from thrifty_tpu_torch.dsp import iq

    tpl_path = os.path.join(tmp, "template.npy")
    np.save(tpl_path, cap.template)
    path = os.path.join(tmp, "full.card")
    card.write_card(path, cap.timestamps, cap.indices,
                    iq.iq_to_raw(cap.blocks))
    n_blocks = len(cap.indices)
    new_len = 16384 - 4920

    gpu_out = os.path.join(tmp, "full_gpu.toad")
    args = [path, "-o", gpu_out] + common_args("cuda", tpl_path)
    with device_kernels() as counts:
        t0 = time.perf_counter()
        detect(args)
        elapsed = time.perf_counter() - t0
    batches = math.ceil(n_blocks / BATCH)
    check(counts == {"power_peak": 2 * batches, "dirichlet_fit": batches,
                     "autocorr_fit": 0, "maximise": 0},
          "{} kernel runs for {} batches".format(counts, batches))

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
    print("cuda and cpu runs agree on every detection (cpu took {:.2f} s); "
          "kernel runs {}".format(cpu_s, counts))
    return counts


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


def launch_counts():
    """Each kernel's launches, as its wrapper counts them."""
    from thrifty_tpu_torch.dsp import dirichlet, power_peak, xcorr

    return {"power_peak": power_peak.launches,
            "dirichlet_fit": dirichlet.launches,
            "autocorr_fit": xcorr.autocorr_launches,
            "maximise": xcorr.maximise_launches}


def reset_launch_counts():
    from thrifty_tpu_torch.dsp import dirichlet, power_peak, xcorr

    power_peak.launches = dirichlet.launches = 0
    xcorr.autocorr_launches = xcorr.maximise_launches = 0


# Each kernel of launch_counts() by its name in a device trace.
KERNEL_NAMES = {"power_peak": "power_peak_kernel",
                "dirichlet_fit": "dirichlet_fit_kernel",
                "autocorr_fit": "autocorr_fit_kernel",
                "maximise": "maximise_kernel"}


@contextlib.contextmanager
def device_kernels():
    """Each hand-written kernel's runs on the card while the block runs,
    counted by name in a torch.profiler trace of the device.  The launch
    counters count the calls of the kernels' launchers, so a CUDA
    graph's replay, which runs the kernels its capture recorded, is
    seen only here.  Yields the dict of launch_counts()'s keys, filled
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    counts = dict.fromkeys(KERNEL_NAMES, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for key, name in KERNEL_NAMES.items():
                counts[key] += name in e.name


def run_cli(command, args, blocks, per_batch, fits=None, traced=True,
            first=None):
    """Run the port's CLI with the kernels' runs on the card counted
    (device_kernels()); power_peak's must equal ``per_batch`` runs for
    each batch of ``blocks`` blocks (``first`` for the first batch,
    where given), and each fit kernel's its count in ``fits`` ({kernel:
    runs per batch}).  ``traced`` False, for a run that is timed, counts
    the launchers' calls instead (launch_counts() from 0), which is the
    runs where the CLI replays no CUDA graph.
    Returns (seconds, power_peak runs per batch)."""
    from thrifty_tpu_torch.cli import main

    batches = math.ceil(blocks / BATCH)
    torch.cuda.synchronize()
    reset_launch_counts()
    with device_kernels() if traced else contextlib.nullcontext() as ran:
        t0 = time.perf_counter()
        check(main([command] + args) == 0,
              "{} failed: {}".format(command, args))
        seconds = time.perf_counter() - t0
    counts = ran if traced else launch_counts()
    launches = counts["power_peak"]
    want = per_batch * (batches - 1) + (per_batch if first is None
                                        else first)
    check(launches == want,
          "{} {}: {} kernel launches for {} batches, expected {}".format(
              command, args[:2], launches, batches, want))
    for name, want in (fits or {}).items():
        check(counts[name] == want * batches,
              "{} {}: {} {} launches for {} batches, expected {} each".format(
                  command, args[:2], counts[name], name, batches, want))
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


# -- the fit kernels (csrc/fits.cu) -------------------------------------------

FITS = ("dirichlet_fit", "autocorr_fit", "maximise")
FIT_SOURCE = "thrifty_tpu_torch/csrc/fits.cu"
# The JAX loop each kernel replaces (no Pallas kernel: a compiled XLA loop).
FIT_REPLACES = {"dirichlet_fit": "thrifty_tpu/dsp/dirichlet.py:141",
                "autocorr_fit": "thrifty_tpu/dsp/xcorr.py:388",
                "maximise": "thrifty_tpu/dsp/xcorr.py:279"}
# Kernel against plain: the CPU tests' tolerances against JAX for the two
# Gauss-Newton fits; for maximise the card selfcheck's (bench.py, 2e-3 for
# maximise's corr_offset between two float32 programs): on a detected row
# with a flat-topped peak a near-tie of its golden-section comparison turns
# the order of a float32 sum into an offset ~1.6e-3 away (the plain version
# on the CPU and on the card differ as much; the phase prints that spread
# and the rows beyond 1e-3).
FIT_TOLS = {"dirichlet_fit": 1e-5, "autocorr_fit": 1e-5, "maximise": 2e-3}
MAXIMISE_TIGHT = 1e-3
# The programs whose fit inputs are timed: the main path's shapes, gated
# and bank rows.
FIT_TIMED = ("detect", "autocorr", "autocorr_gated", "autocorr_bank",
             "maximise", "maximise_gated", "maximise_bank")
FLOAT32_PEAK = 67e12   # H100 SXM float32 outside the tensor cores
# Float32 operations of each fit as csrc/fits.cu does them (sin, cos and
# sincos not counted, so the bound is a lower one): per point and step and
# per step of the two per-row fits; per element of the maximise rotation and
# of each of its evaluations.
DIRICHLET_FLOPS = (27, 16)
AUTOCORR_FLOPS = (24, 16)
MAXIMISE_FLOPS = (8, 11)


def fit_work(name, args):
    """(bytes, flops) one call of fit ``name`` on ``args`` needs: each
    input read once, each output written once; the operations the
    kernel does on these inputs."""
    def iters(k, default):   # the wrappers' positional iters argument
        return args[k] if len(args) > k else default

    if name == "dirichlet_fit":
        y = args[0]
        rows, points = y.numel() // y.shape[-1], y.shape[-1]
        per_point, per_step = DIRICHLET_FLOPS
        return (rows * (points + 1) * 4,
                rows * iters(3, 12) * (points * per_point + per_step))
    if name == "autocorr_fit":
        y, table = args[0], args[1]
        rows, points = y.numel() // y.shape[-1], y.shape[-1]
        per_point, per_step = AUTOCORR_FLOPS
        return (rows * (points + 1) * 4 + 2 * table.numel() * 4,
                rows * iters(4, 10) * (points * per_point + per_step))
    spec, idx = args[0], args[1]
    n = spec.shape[-1]
    rows = spec.numel() // n
    rotate, evaluate = MAXIMISE_FLOPS
    return (rows * n * 8 + rows * (idx.element_size() + 4),
            rows * n * (rotate + (2 + iters(3, 34)) * evaluate))


def fit_bound(name, args):
    nbytes, flops = fit_work(name, args)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FLOAT32_PEAK * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations", nbytes, flops)


def fit_functions():
    """{kernel: (wrapper, plain version)}, looked up when called."""
    from thrifty_tpu_torch.dsp import dirichlet, xcorr

    return {"dirichlet_fit": (dirichlet.dirichlet_fit,
                              dirichlet.dirichlet_fit_reference),
            "autocorr_fit": (xcorr.autocorr_fit,
                             xcorr.autocorr_fit_reference),
            "maximise": (xcorr.maximise_search, xcorr.maximise_reference)}


def fit_held(name, args, what, rows=None):
    """One fit kernel launch against its plain version on ``args``:
    NaNs in the same places, offsets within FIT_TOLS on every row, or on
    the rows of the bool mask ``rows`` (those whose offset the detector
    reports).  Returns (the kernel's offsets as numpy, max abs err on
    the held rows, max abs err on every row, held rows beyond
    MAXIMISE_TIGHT)."""
    kernel, plain = fit_functions()[name]
    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == torch.float32,
          "{}: {} {} vs plain {}".format(what, got.shape, got.dtype,
                                          ref.shape))
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    nan = np.isnan(ref)
    check(np.array_equal(nan, np.isnan(got)), "{}: NaNs differ".format(what))
    diff = np.where(nan, 0.0, np.abs(got - ref)).reshape(-1)
    held = diff if rows is None else np.where(rows.reshape(-1), diff, 0.0)
    err = float(np.max(held, initial=0.0))
    worst = int(np.argmax(held)) if held.size else 0
    check(err <= FIT_TOLS[name], "{}: off by {:.3g} (limit {:g}) at row {}: "
          "kernel {!r}, plain {!r}".format(
              what, err, FIT_TOLS[name], worst, got.reshape(-1)[worst],
              ref.reshape(-1)[worst]))
    return (got, err, float(np.max(diff, initial=0.0)),
            int(np.sum(held > MAXIMISE_TIGHT)))


def plain_device_spread(args, rows):
    """The maximise plain version on the CPU against the same on the card
    (one code, two summation orders), on the rows of the bool mask
    ``rows``: (max abs difference, rows beyond MAXIMISE_TIGHT)."""
    from thrifty_tpu_torch.dsp import xcorr

    card = xcorr.maximise_reference(*args).cpu().numpy()
    cpu = xcorr.maximise_reference(*(a.cpu() if isinstance(
        a, torch.Tensor) else a for a in args)).numpy()
    diff = np.where(rows, np.abs(card - cpu), 0.0)
    return float(diff.max()), int(np.sum(diff > MAXIMISE_TIGHT))


def carrier_rows(rows, rng, points=7, block_len=16384, carrier_len=4914):
    """[rows, points] float32 carrier magnitudes |A*D(x - delta)| with 2%
    noise (the CPU tests' rows), then an all-zero row (a gate's filler),
    a flat row and one-sided ramps that drive delta onto the +-1
    clamp."""
    half = points // 2
    u = np.arange(-half, half + 1)[None, :] - rng.uniform(
        -0.5, 0.5, (rows, 1))
    a = np.pi / block_len
    d = np.where(u == 0, 1.0, np.sin(a * carrier_len * u) / (
        carrier_len * np.where(u == 0, 1.0, np.sin(a * u))))
    amp = rng.uniform(10.0, 1000.0, (rows, 1))
    y = np.abs(amp * np.abs(d) + rng.normal(scale=0.02, size=d.shape) * amp)
    y[0], y[1] = 0.0, 5.0
    y[2] = 3.0 ** np.arange(points)
    y[3] = y[2][::-1]
    return y.astype(np.float32)


def noise_row_spread(dev):
    """The Dirichlet fit on 64 noise-dominated rows (|N(0, 1)| plus a
    one-bin peak, unlike a carrier's shape), where 12 Gauss-Newton steps
    need not converge and amplify float32 rounding: the largest
    |kernel - plain| on the card beside the largest |plain on the CPU -
    plain on the card|.  Printed, not held to FIT_TOLS."""
    from thrifty_tpu_torch.dsp import dirichlet

    rng = np.random.default_rng(7)
    y = np.abs(rng.normal(size=(64, 7))).astype(np.float32) + np.array(
        [0, 1, 3, 9, 3, 1, 0], np.float32)
    yd = torch.from_numpy(y).to(dev)
    got = dirichlet.dirichlet_fit(yd, 16384, 4914).cpu().numpy()
    ref = dirichlet.dirichlet_fit_reference(yd, 16384, 4914).cpu().numpy()
    cpu = dirichlet.dirichlet_fit_reference(torch.from_numpy(y), 16384,
                                            4914).numpy()
    return float(np.max(np.abs(got - ref))), float(np.max(np.abs(cpu - ref)))


def fit_edge_cases(dev, template):
    """{kernel: [(label, args)]}: rows the detect path rarely gives --
    all-zero rows (a gate's filler), flat rows, one-sided ramps that
    drive an offset onto its clamp, ties (all-zero spectra: fc > fd
    never holds), a non-power-of-two n, n = 65536 (the row does not fit
    in shared memory: the scratch row), int64 peaks beyond n."""
    from thrifty_tpu_torch.dsp import xcorr

    rng = np.random.default_rng(7)
    y = carrier_rows(64, rng)
    cases = {"dirichlet_fit": [
        ("edges [64, 7]", (torch.from_numpy(y).to(dev), 16384, 4914)),
        ("edges [64, 5]", (torch.from_numpy(y[:, 1:6].copy()).to(dev),
                           16384, 4914))]}
    table, dtable = (torch.from_numpy(t).to(dev)
                     for t in xcorr.autocorr_tables(template))
    ya = np.abs(rng.normal(size=(64, 5))).astype(np.float32) + np.array(
        [1, 3, 9, 3, 1], np.float32)
    ya[:4] = y[:4, 1:6]
    ya[4] = [0, 0, 0, 1, 1e3]        # far right: the offset clamps at clip
    cases["autocorr_fit"] = [("edges [64, 5]", (
        torch.from_numpy(ya).to(dev), table, dtable))]
    cases["maximise"] = []
    for n, rows, dtype in ((16384, 8, torch.int32), (6000, 8, torch.int64),
                           (65536, 4, torch.int64)):
        k = np.fft.fftfreq(n) * n
        idx = np.linspace(0, n - 1, rows).astype(np.int64)
        frac = rng.uniform(-0.5, 0.5, rows)
        spec = (64 * np.exp(-2j * np.pi * k * (idx + frac)[:, None] / n)
                + rng.normal(size=(rows, n))).astype(np.complex64)
        spec[0] = 0.0
        idx = idx + n * (np.arange(rows) - 1)   # wraps: -n .. beyond n
        cases["maximise"].append(("edges [{}, {}] {}".format(
            rows, n, str(dtype).split(".")[-1]), (
                torch.from_numpy(spec).to(dev),
                torch.from_numpy(idx).to(dev).to(dtype))))
    return cases


def fits_phase(card, cap, template, probe):
    """The three fit kernels on each detect program that selects them:
    each program runs one 256-block batch with the launch counts set to 0
    just before and read just after (each fit must launch once per stage
    call), the inputs each fit gets are captured and the kernel is held
    against its plain version on them and on edge rows; then each kernel
    is timed at the main path's shapes against its plain version and the
    empty launch.  Returns {kernel: its JSON entry} (``launches`` is set
    by the caller from the main path's runs)."""
    phase("fit kernels vs plain")
    from thrifty_tpu_torch.dsp import dirichlet, iq, xcorr
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = torch.device("cuda")
    rows = torch.from_numpy(iq.iq_to_raw(cap.blocks[:BATCH])).to(dev)
    new = torch.from_numpy(iq.iq_to_raw(
        cap.blocks[:BATCH, 4920:].reshape(-1))).to(dev)
    bank = code_bank()
    bank_rows = torch.from_numpy(iq.iq_to_raw(bank_capture(bank))).to(dev)

    def run(tmpl=template, src=rows, stream=False, **kw):
        det = BatchDetector(tmpl, DetectorConfig(
            carrier_window=(7, 110), **kw), device=dev)
        return lambda: (det.submit_raw_stream(src) if stream
                        else det.submit_raw(src)).result()

    n, half = 16384, BATCH // 2
    d7 = [(BATCH, 7)]
    # program: (run, {kernel: the input shape of each launch}).
    programs = {
        "detect": (run(), {"dirichlet_fit": d7}),
        "detect_gated": (run(gate_capacity=half), {"dirichlet_fit": d7}),
        "detect_gate_overflow": (run(gate_capacity=8),
                                 {"dirichlet_fit": d7}),
        "detect_device_unfold": (run(src=new, stream=True),
                                 {"dirichlet_fit": d7}),
        "detect_preshift": (run(sync_mode="preshift"),
                            {"dirichlet_fit": d7}),
        "detect_stats": (run(carrier_thresh=STDDEV_THRESH,
                             corr_thresh=CORR_STDDEV_THRESH),
                         {"dirichlet_fit": d7}),
        "detect_peak_filter": (run(peak_filter_len=-1),
                               {"dirichlet_fit": d7}),
        "detect_matmul": (run(fft_impl="matmul"), {"dirichlet_fit": d7}),
        "detect_integer": (run(sync_mode="integer"), {}),
        "bank": (run(bank, bank_rows), {"dirichlet_fit": d7}),
        "bank_preshift": (run(bank, bank_rows, sync_mode="preshift"),
                          {"dirichlet_fit": d7}),
        "autocorr": (run(corr_interp="autocorr"), {
            "dirichlet_fit": d7, "autocorr_fit": [(BATCH, 5)]}),
        "autocorr_gated": (run(corr_interp="autocorr", gate_capacity=half), {
            "dirichlet_fit": d7, "autocorr_fit": [(half, 5)]}),
        "autocorr_gate_overflow": (run(corr_interp="autocorr",
                                       gate_capacity=8), {
            "dirichlet_fit": d7, "autocorr_fit": [(8, 5), (BATCH, 5)]}),
        "autocorr_bank": (run(bank, bank_rows, corr_interp="autocorr"), {
            "dirichlet_fit": d7, "autocorr_fit": [(BATCH, 3, 5)]}),
        "autocorr_integer": (run(corr_interp="autocorr",
                                 sync_mode="integer"),
                             {"autocorr_fit": [(BATCH, 5)]}),
        "maximise": (run(corr_interp="maximise"), {
            "dirichlet_fit": d7, "maximise": [(BATCH, n)]}),
        "maximise_gated": (run(corr_interp="maximise", gate_capacity=half), {
            "dirichlet_fit": d7, "maximise": [(half, n)]}),
        "maximise_bank": (run(bank, bank_rows, corr_interp="maximise"), {
            "dirichlet_fit": d7, "maximise": [(BATCH, 3, n)]}),
    }
    originals = {"dirichlet_fit": (dirichlet, "dirichlet_fit"),
                 "autocorr_fit": (xcorr, "autocorr_fit"),
                 "maximise": (xcorr, "maximise_search")}
    captured = {name: [] for name in FITS}
    # p_det of each correlation stage call: the rows whose offset the
    # detector reports (_finish_outputs zeroes the others).
    stage_detected = []
    corr_stage = BatchDetector._corr_stage

    def stage_spy(self, *args):
        out = corr_stage(self, *args)
        stage_detected.append(out[2].cpu().numpy())
        return out

    def spy(name, orig):
        def wrapper(*args):
            captured[name].append(tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args))
            return orig(*args)
        return wrapper

    inputs = {name: [] for name in FITS}   # (label, args, rows) to hold
    timed = {name: {} for name in FITS}    # input shape -> args to time
    per_batch = {name: {} for name in FITS}
    for program, (fn, want) in programs.items():
        for v in captured.values():
            v.clear()
        stage_detected.clear()
        saved = {k: getattr(mod, attr) for k, (mod, attr) in
                 originals.items()}
        for k, (mod, attr) in originals.items():
            setattr(mod, attr, spy(k, saved[k]))
        BatchDetector._corr_stage = stage_spy
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            for k, (mod, attr) in originals.items():
                setattr(mod, attr, saved[k])
            BatchDetector._corr_stage = corr_stage
        for name in FITS:
            shapes = [tuple(args[0].shape) for args in captured[name]]
            expect = want.get(name, [])
            check(shapes == expect and counts[name] == len(expect),
                  "{}: {} launched {} times on {}, expected {}".format(
                      program, name, counts[name], shapes, expect))
            if expect:
                per_batch[name][program] = counts[name]
            for k, args in enumerate(captured[name]):
                # maximise is held on the rows its stage call detects;
                # each stage call launches it once.
                rows = stage_detected[k] if name == "maximise" else None
                inputs[name].append(("{} launch {} {}".format(
                    program, k, shapes[k]), args, rows))
                if program in FIT_TIMED:
                    timed[name].setdefault(shapes[k], args)
        print("{}: one {}-block batch, launches {}".format(program, BATCH,
                                                           counts))

    edges = fit_edge_cases(dev, template)
    max_err = {}
    for name in FITS:
        errs, all_rows, beyond, held_rows = [], [], 0, 0
        for label, args, rows in inputs[name] + [
                (label, args, None) for label, args in edges[name]]:
            got, err, err_all, n_beyond = fit_held(
                name, args, "{} {}".format(name, label), rows)
            errs.append(err)
            all_rows.append(err_all)
            beyond += n_beyond
            held_rows += got.size if rows is None else int(rows.sum())
            again = fit_functions()[name][0](*args).cpu().numpy()
            check(np.array_equal(got, again, equal_nan=True),
                  "{} {}: two launches differ".format(name, label))
        max_err[name] = max(errs)
        print("{}: kernel = plain within {:.3g} (limit {:g}) on {} held rows "
              "of {} inputs from the programs above and {} edge cases, and "
              "bit-equal between two launches".format(
                  name, max_err[name], FIT_TOLS[name], held_rows,
                  len(inputs[name]), len(edges[name])))
        if name == "maximise":
            label, args, rows = inputs[name][0]
            spread, n_spread = plain_device_spread(args, rows)
            print("maximise: {} held rows beyond {:g}; on every row, the "
                  "undetected ones included (not held: the detector reports "
                  "0 there), max |kernel - plain| {:.3g}; the plain version "
                  "on the CPU against the card on {} ({} detected rows): "
                  "max {:.3g}, {} rows beyond {:g}".format(
                      beyond, MAXIMISE_TIGHT, max(all_rows), label,
                      int(rows.sum()), spread, n_spread, MAXIMISE_TIGHT))

    kernel_err, plain_err = noise_row_spread(dev)
    print("dirichlet_fit on 64 noise-dominated rows (not held): max |kernel "
          "- plain| {:.3g} on the card, max |plain on the CPU - plain on the "
          "card| {:.3g}".format(kernel_err, plain_err))
    empty = empty_launcher(probe)
    scrub = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    entries = {}
    for name in FITS:
        kernel, plain = fit_functions()[name]
        results = {}
        for shape, args in sorted(timed[name].items()):
            r = int(np.prod(shape[:-1]))
            ctas = r if name == "maximise" else -(-r // 128)
            t = {"kernel " + mode: median_ms(lambda: kernel(*args), mode,
                                             scrub)
                 for mode in ("cold", "warm", "call")}
            t["plain cold"] = median_ms(lambda: plain(*args), "cold", scrub,
                                        reps=5, warmup=2)
            t["empty launch cold"] = median_ms(lambda: empty(ctas, 1),
                                               "cold", scrub)
            bound, by, nbytes, flops = fit_bound(name, args)
            results[shape] = (t, bound, by)
            print("{} {}: {}; bound {:.3g} ms by {} ({} bytes, {} float32 "
                  "operations; sin/cos not counted); {} CTAs; library "
                  "call: none; {}".format(
                      name, list(shape), ", ".join(
                          "{} {:.4f} ms".format(k, v) for k, v in t.items()),
                      bound, by, nbytes, flops, ctas, card))
        main = {"dirichlet_fit": (BATCH, 7), "autocorr_fit": (BATCH, 5),
                "maximise": (BATCH, n)}[name]
        t, bound, by = results[main]
        entries[name] = {
            "name": name, "route": "cuda", "source": FIT_SOURCE,
            "replaces": FIT_REPLACES[name], "max_abs_err": max_err[name],
            "ms": t["kernel cold"], "plain_ms": t["plain cold"],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "floor_ms": t["empty launch cold"], "shape": list(main),
            "launches_per_batch": per_batch[name]}
    del scrub
    return entries


def fit_cli_phase(card_name, tmp, cap, tpl_path):
    """This slice's own paths at full width: ``detect --corr-interp
    autocorr`` and ``maximise`` on the 512-block capture through the CLI,
    every count set to 0 just before and read just after: 2 power_peak,
    1 Dirichlet and 1 of the named fit's launches per batch, every burst
    within 0.05 samples.  Returns {kernel: (launches, per batch)}."""
    phase("fit paths through the CLI")
    n = len(cap.indices)
    batches = math.ceil(n / BATCH)
    card_path = os.path.join(tmp, "full.card")
    out = {}
    for interp, kernel in (("autocorr", "autocorr_fit"),
                           ("maximise", "maximise")):
        toad = os.path.join(tmp, "full_{}.toad".format(interp))
        seconds, _ = run_cli("detect", [card_path, "-o", toad]
                             + common_args("cuda", tpl_path)
                             + ["--corr-interp", interp], n, 2,
                             {"dirichlet_fit": 1, kernel: 1})
        got = load_toad(toad)
        check_bursts(got, cap, "--corr-interp " + interp)
        out[kernel] = (batches, 1.0)
        print("detect --corr-interp {}: {} detections, every burst within "
              "0.05 samples; per batch 2 power_peak, 1 dirichlet_fit, 1 {} "
              "launches ({} batches); CLI {:.4g} IQ samples/s; {}".format(
                  interp, len(got), kernel, batches, n * NEW_LEN / seconds,
                  card_name))
    return out


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
    # An overflowing batch: the gated correlation, then the full one; a
    # replayed one re-runs from its bytes, the carrier stage included.
    for name, capacity, first, launches in (
            ("detect_gated", BATCH // 2, 2, 2),
            ("detect_gate_overflow", 8, 3, 4)):
        out = os.path.join(tmp, name + ".toad")
        seconds, per_batch[name] = run_cli("detect", raw_args(
            raw_path, out, tpl_path, ["--gate-capacity", str(capacity)]),
            n, launches, first=first)
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
          "TOAD_TOLS, 2 power/peak runs per batch; --gate-capacity 8 "
          "overflows every batch and re-runs it in full (3 runs on the "
          "eager first batch, 4 on a replayed one, whose re-run does the "
          "carrier stage again) and writes the ungated .toad byte for "
          "byte".format(BATCH // 2))
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
    # Timed without a profiler; `capture` replays no CUDA graph.  (Under
    # device_kernels() at this point of the script the profiler held
    # none of its kernels, where a fresh process holds them all.)
    for _ in range(2):
        seconds, _ = run_cli("capture", [
            "--raw-in", raw_path, "-o", os.path.join(tmp, "cap.card"),
            "--quiet", "--carrier-window", "7-110", "--batch-size",
            str(BATCH), "--device", "cuda"], n, 1, traced=False)
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
    fit_paths = {}
    for name, (extra, spec) in INTERP_CASES.items():
        out = os.path.join(tmp, name + ".toad")
        # Dirichlet unless a carrier interpolator is named; the
        # correlation's fit when it is named.
        fits = {"dirichlet_fit": int("--carrier-interp" not in extra),
                "autocorr_fit": int(name == "corr_autocorr"),
                "maximise": int(name == "corr_maximise")}
        _, per_batch["detect_" + name] = run_cli(
            "detect", [src, "-o", out] + common + extra, blocks, 2, fits)
        for kernel, n in fits.items():
            if n:
                fit_paths.setdefault(kernel, {})["detect_" + name] = n
        err = compare_interp(load_toad(out), load_toad(os.path.join(
            INTERP, "rx0_{}.toad".format(name))), spec, name)
        print("{}: matches rx0_{}.toad (max |corr_offset - golden| "
              "{:.2e}); 2 power_peak launches per batch, fits {}".format(
                  name, name, err, fits))
    return per_batch, fit_paths


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
    """ms and device kernels per 256-block batch of every detect program
    of PERF.md section 5 (CUDA events around 10 batches queued back to
    back; the gated program's batches are queued, not resolved)."""
    phase("program timings")
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = torch.device("cuda")
    bank = code_bank()
    rows = torch.from_numpy(iq.iq_to_raw(bank_capture(bank))).to(dev)
    out = {}
    for name, tmpl, kw in (
            ("fractional", template, {}),
            ("fractional_gated", template, dict(gate_capacity=BATCH // 2)),
            ("integer", template, dict(sync_mode="integer")),
            ("bank", bank, {}),
            ("preshift", template, dict(sync_mode="preshift")),
            ("bank_preshift", bank, dict(sync_mode="preshift")),
            ("autocorr", template, dict(corr_interp="autocorr")),
            ("maximise", template, dict(corr_interp="maximise")),
            ("stats", template, dict(carrier_thresh=STDDEV_THRESH,
                                     corr_thresh=CORR_STDDEV_THRESH)),
            ("peak_filter", template, dict(peak_filter_len=-1)),
            ("matmul", template, dict(fft_impl="matmul")),
            ("matmul3", template, dict(fft_impl="matmul3")),
            ("matmul_high", template, dict(fft_impl="matmul",
                                           fft_precision="high"))):
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


# -- the transform family (dsp/mxu_fft.py) ---------------------------------
#
# Peak rates of one H100 SXM by the matmul precision (NVIDIA's data sheet,
# dense): float32 outside the tensor cores, TF32, bf16.
PEAK_FLOPS = {"highest": 67e12, "high": 495e12, "default": 989e12}
FFT_PEAK = 67e12  # torch.fft: float32 butterflies
# Bounds against the float64 oracle, relative to the largest output:
# JAX's tests/test_mxu_fft.py at 'highest' (the transforms and the window
# 2e-5, the separable ramp 2e-6 and 4e-6 as matmul3, the full ramp of the
# fallback sizes 1e-5); 2e-3 for TF32 and 1e-2 for bf16.
PREC_BOUND = {"high": 2e-3, "default": 1e-2}
TRANSFORM_NS = (16384, 1024, 6000)  # four-step, dense DFT, no factorization
TRANSFORM_ROWS = BATCH


def transform_inputs(n, seed=0):
    """[256, n] complex64 blocks, per-row shifts in bins, the head length,
    the carrier window with the Dirichlet fit's 3-bin margin (W = 110 at
    16384) and a wrapped window; the float64 oracles of each transform."""
    rng = np.random.default_rng(seed + n)
    x = (rng.normal(size=(TRANSFORM_ROWS, n))
         + 1j * rng.normal(size=(TRANSFORM_ROWS, n))).astype(np.complex64)
    # Carrier shifts of the detect window; the full ramp of the fallback
    # sizes at JAX's test span (its 1e-5 bound grows with the phase).
    span = 110 if n == 16384 else 20
    shifts = rng.uniform(-span, span, TRANSFORM_ROWS).astype(np.float32)
    x64 = x.astype(np.complex128)
    spec = np.fft.fft(x64)
    head = n - 4914 + 1 if n == 16384 else n * 7 // 10
    window = np.arange(4, 114) if n == 16384 else np.arange(3, 40)
    wrapped = np.arange(-55, 55) % n if n == 16384 else np.arange(-10, 11) % n
    pos = np.arange(n) / n - 0.5
    ramped = np.fft.fft(x64 * np.exp(2j * np.pi * shifts.astype(
        np.float64)[:, None] * pos))
    oracle = {"fft": spec, "ifft": np.fft.ifft(x64),
              "ifft_head": np.fft.ifft(x64)[:, :head],
              "windowed": spec[:, window], "windowed_wrapped": spec[:, wrapped],
              "fft_ramped": ramped}
    return x, shifts, head, window, wrapped, oracle


def transform_calls(x, s, head, window, wrapped):
    """{case: fn(impl, precision)} of the module's transforms on the card."""
    from thrifty_tpu_torch.dsp import mxu_fft as mf

    return {
        "fft": lambda i, p: mf.fft(x, i, p),
        "ifft": lambda i, p: mf.ifft(x, i, p),
        "ifft_head": lambda i, p: mf.ifft_head(x, head, i, p),
        "windowed": lambda i, p: mf.windowed_dft(x, window, i, p),
        "windowed_wrapped": lambda i, p: mf.windowed_dft(x, wrapped, i, p),
        "fft_ramped": lambda i, p: mf.fft_ramped(x, s, i, p),
    }


def highest_bound(case, n, impl):
    from thrifty_tpu_torch.dsp import mxu_fft as mf

    if case != "fft_ramped":
        return 2e-5
    if mf._split(n) is None:
        return 1e-5  # the full ramp
    return 4e-6 if impl == "matmul3" else 2e-6


def transform_work(case, n, impl, head, width):
    """(real flops, bytes) that one call at [256, n] must do: the data read
    once and written once; under 'auto' the FFT's 5 n log2 n flops a row,
    on the matmul path 8 real flops per complex multiply-add (matmul3's
    Karatsuba 6) and the constants read once."""
    from thrifty_tpu_torch.dsp import mxu_fft as mf

    rows = TRANSFORM_ROWS
    flops_per_mac = 6 if impl == "matmul3" else 8
    split = mf._split(n)
    out_cols = {"ifft_head": head, "windowed": width,
                "windowed_wrapped": width}.get(case, n)
    nbytes = rows * n * 8 + rows * out_cols * 8
    if case == "fft_ramped":
        nbytes += rows * 4
    if impl == "auto":
        return rows * 5 * n * math.log2(n), nbytes
    if case.startswith("windowed"):
        macs = rows * n * width
        nbytes += n * width * 8
    elif split is None:
        macs = rows * n * out_cols
        nbytes += n * out_cols * 8
    else:
        n1, n2 = split
        macs = rows * n1 * n1 * n2 + rows * n1 * n2 * -(-out_cols // n1)
        nbytes += (2 * n1 * n1 + 2 * n1 * n2) * 8
    return macs * flops_per_mac, nbytes


def transforms_phase(card_name):
    """The matmul transforms against the float64 oracle at [256, 16384],
    the dense n = 1024 and the unfactorable n = 6000, for matmul and
    matmul3 at each precision ('highest' within JAX's bounds, 'high'
    coarser than it and within 2e-3, 'default' within 1e-2, TF32 off after
    every call), then their cold-L2 times at [256, 16384] beside
    torch.fft and each one's bound."""
    phase("transforms")
    from thrifty_tpu_torch.dsp import mxu_fft as mf

    dev = torch.device("cuda")
    precs = ("highest", "high", "default")
    worst = {}
    for n in TRANSFORM_NS:
        x, s, head, window, wrapped, oracle = transform_inputs(n)
        calls = transform_calls(torch.from_numpy(x).to(dev),
                                torch.from_numpy(s).to(dev), head, window,
                                wrapped)
        for impl in ("matmul", "matmul3"):
            for case, fn in calls.items():
                errs = {}
                for prec in precs:
                    got = fn(impl, prec).cpu().numpy()
                    check(torch.backends.cuda.matmul.allow_tf32 is False,
                          "TF32 left on after {} {}".format(case, prec))
                    ref = oracle[case]
                    errs[prec] = float(np.max(np.abs(got - ref))
                                       / np.max(np.abs(ref)))
                bound = highest_bound(case, n, impl)
                what = "{} n={} {}".format(case, n, impl)
                check(errs["highest"] < bound, "{}: highest err {:.3g} >= "
                      "{:g}".format(what, errs["highest"], bound))
                for prec, lim in PREC_BOUND.items():
                    check(errs[prec] < lim, "{}: {} err {:.3g} >= {:g}".format(
                        what, prec, errs[prec], lim))
                matmul_path = mf._split(n) is not None or n <= mf._DFT_MAX
                if matmul_path:
                    check(errs["high"] > errs["highest"],
                          "{}: 'high' no coarser than 'highest' ({:.3g} vs "
                          "{:.3g})".format(what, errs["high"],
                                           errs["highest"]))
                for prec, e in errs.items():
                    key = (prec, matmul_path)
                    worst[key] = max(worst.get(key, 0.0), e)
                print("{}: max rel err highest {:.3g} (bound {:g}), high "
                      "{:.3g}, default {:.3g}".format(
                          what, errs["highest"], bound, errs["high"],
                          errs["default"]))
    print("worst on the matmul paths: highest {:.3g}, high (TF32) {:.3g}, "
          "default (bf16) {:.3g}; TF32 off after every call; {}".format(
              worst["highest", True], worst["high", True],
              worst["default", True], card_name))

    # Cold-L2 device time at the main path's shape.
    n = 16384
    x, s, head, window, wrapped, _ = transform_inputs(n, seed=1)
    xd, sd = torch.from_numpy(x).to(dev), torch.from_numpy(s).to(dev)
    calls = transform_calls(xd, sd, head, window, wrapped)
    scrub = torch.empty(64 * 1024 * 1024, device=dev)  # 256 MB > the L2
    timings = {}
    for case in ("fft", "ifft_head", "windowed", "fft_ramped"):
        fn = calls[case]
        base_ms = median_ms(lambda: fn("auto", "highest"), "cold", scrub)
        flops, nbytes = transform_work(case, n, "auto", head, len(window))
        base_bound = max(flops / FFT_PEAK, nbytes / HBM_BYTES_PER_S) * 1e3
        print("{} [{}, {}] torch.fft (cuFFT): cold {:.4f} ms, bound {:.4f} "
              "ms (bytes: {:.3g} MB); {}".format(
                  case, TRANSFORM_ROWS, n, base_ms, base_bound, nbytes / 1e6,
                  card_name))
        for impl in ("matmul", "matmul3"):
            for prec in precs:
                ms = median_ms(lambda: fn(impl, prec), "cold", scrub)
                flops, nbytes = transform_work(case, n, impl, head,
                                               len(window))
                t_ops = flops / PEAK_FLOPS[prec] * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(t_ops, t_bytes)
                by = "operations" if t_ops >= t_bytes else "bytes"
                timings[case, impl, prec] = (ms, bound, by)
                print("{} [{}, {}] {} {}: cold {:.4f} ms, bound {:.4f} ms "
                      "({}: {:.3g} GFLOP, {:.3g} MB), torch.fft {:.4f} ms; "
                      "{}".format(case, TRANSFORM_ROWS, n, impl, prec, ms,
                                  bound, by,
                                  flops / 1e9, nbytes / 1e6, base_ms,
                                  card_name))
        timings[case, "auto", "highest"] = (base_ms, base_bound, "bytes")
    del scrub
    return timings


# TF32 in every transform (--fft-precision high): carrier_energy rtol
# 2e-3 and carrier_offset atol 5e-3, JAX's tolerances for TF32 in the
# carrier transform (tests/test_mxu_fft.py:498-512).  The correlation's
# GEMM stages round their operands to TF32 (unit roundoff 2^-11), and the
# Gaussian fit turns that into corr_offset (and SoA) differences from the
# float32 run.  scripts/tf32_drift_torch.py over 32 captures like this
# one on an H100 read at most 6.46e-3 samples (median 1.21e-3; this
# capture 1.62e-3, PERF.md section 6), so these two columns are held at
# 1e-2, that reading with about 1.5x headroom, and the rest as the
# .toad's.
TF32_TOLS = dict(TOAD_TOLS)
TF32_TOLS.update({10: dict(rtol=2e-3, atol=1e-3), 9: dict(atol=5e-3),
                  5: dict(atol=1e-2), 3: dict(atol=1e-2)})
# The stddev threshold terms of options_phase's detect_stats run.  The
# carrier's variance term (2d) needs every bin's magnitude, so under
# --fft-impl matmul the carrier stage takes the full four-step FFT and its
# own power/peak launch instead of the windowed DFT: 2 launches a batch,
# as the torch.fft run with the same terms.
STATS_FLAGS = ["--carrier-threshold", "15s+2d", "--corr-threshold", "15s+2d"]
# detect through the CLI on the full-size capture, one run per transform
# configuration: (name, flags the reference run shares, transform flags,
# power/peak launches per batch, tolerances against the reference: the
# default run's .toad, or a torch.fft run with the shared flags).
TRANSFORM_RUNS = (
    ("detect_matmul", [], ["--fft-impl", "matmul"], 1, TOAD_TOLS),
    ("detect_matmul_stats", STATS_FLAGS, ["--fft-impl", "matmul"], 2,
     TOAD_TOLS),
    ("detect_matmul3", [], ["--fft-impl", "matmul3"], 1, TOAD_TOLS),
    ("detect_matmul_high", [], ["--fft-impl", "matmul", "--fft-precision",
                                "high"], 1, TF32_TOLS),
)


def compare_toads_tols(got, ref, what, tols):
    check(got.shape == ref.shape, "{}: {} vs {} detections".format(
        what, got.shape[0], ref.shape[0]))
    for col in TOAD_INT_COLS:
        check(np.array_equal(got[:, col], ref[:, col]),
              "{}: toad column {} differs".format(what, col))
    for col, tol in tols.items():
        err = float(np.max(np.abs(got[:, col] - ref[:, col]), initial=0.0))
        check(np.allclose(got[:, col], ref[:, col], **tol),
              "{}: toad column {} beyond {} (max |diff| {:.3g})".format(
                  what, col, tol, err))


def refuse_pallas_off(tmp, card_path, tpl_path, template):
    """The card has no plain reduction path: ``detect --pallas off`` is a
    usage error there and a CUDA detector refuses ``use_pallas='off'``,
    both before any launch."""
    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    out = os.path.join(tmp, "pallas_off.toad")
    pp.launches = 0
    try:
        code = main(["detect", card_path, "-o", out, "--pallas", "off"]
                    + common_args("cuda", tpl_path))
    except SystemExit as exc:
        code = exc.code
    check(code == 2 and not os.path.exists(out),
          "detect --pallas off --device cuda: exit {}, expected the usage "
          "error (2) and no .toad".format(code))
    try:
        BatchDetector(template, DetectorConfig(use_pallas="off"),
                      device="cuda")
        refused = False
    except ValueError:
        refused = True
    check(refused, "BatchDetector(use_pallas='off', device='cuda') ran")
    check(pp.launches == 0, "--pallas off launched the kernel")
    print("--pallas off on the card: the CLI's usage error and the "
          "detector's ValueError, 0 launches")


def transform_detect_phase(card_name, tmp, cap, tpl_path):
    """detect through the CLI under each transform configuration on the
    full-size capture (512 blocks, batch 256) against the default run's
    .toad and the ground truth; --pallas off refused; the golden cards
    under --fft-impl matmul; capture --fft-impl matmul against fastcard's
    gated.card."""
    phase("transforms through the CLI")
    from thrifty_tpu_torch.io import card

    n = len(cap.indices)
    card_path = os.path.join(tmp, "full.card")
    default = load_toad(os.path.join(tmp, "full_gpu.toad"))
    per_batch = {}
    for name, shared, flags, launches, tols in TRANSFORM_RUNS:
        ref = default
        if shared:
            ref_out = os.path.join(tmp, name + "_fft.toad")
            run_cli("detect", [card_path, "-o", ref_out]
                    + common_args("cuda", tpl_path) + shared, n, launches)
            ref = load_toad(ref_out)
        extra = shared + flags
        out = os.path.join(tmp, name + ".toad")
        seconds, per_batch[name] = run_cli(
            "detect", [card_path, "-o", out] + common_args("cuda", tpl_path)
            + extra, n, launches)
        check(torch.backends.cuda.matmul.allow_tf32 is False,
              name + ": TF32 left on")
        got = load_toad(out)
        compare_toads_tols(got, ref, name, tols)
        check_bursts(got, cap, name)
        diffs = {col: float(np.max(np.abs(got[:, col] - ref[:, col])))
                 for col in (3, 5, 9, 10)}
        print("{} ({}): {} detections = the reference run's, every burst "
              "within 0.05 samples; max |diff| soa {:.3g}, corr_offset {:.3g}, "
              "carrier_offset {:.3g}, carrier_energy {:.3g}; {} power/peak "
              "launches per batch; CLI {:.4g} IQ samples/s; {}".format(
                  name, " ".join(extra), len(got), diffs[3], diffs[5],
                  diffs[9], diffs[10], launches, n * NEW_LEN / seconds,
                  card_name))
    refuse_pallas_off(tmp, card_path, tpl_path, cap.template)
    golden_tpl = os.path.join(INPUT, "template.npy")
    for rxid in (0, 1, 2):
        src = os.path.join(INPUT, "rx{}.card".format(rxid))
        out = os.path.join(tmp, "rx{}_matmul.toad".format(rxid))
        _, per_batch["detect_golden_matmul"] = run_cli(
            "detect", [src, "-o", out, "--fft-impl", "matmul"]
            + common_args("cuda", golden_tpl, rxid),
            len(card.read_card(src)[0]), 1)
        compare_toads(load_toad(out), load_toad(os.path.join(
            GOLDEN, "rx{}.toad".format(rxid))), "rx{} matmul".format(rxid))
    print("rx0/rx1/rx2 under --fft-impl matmul match the reference goldens; "
          "1 power/peak launch per batch")
    out = os.path.join(tmp, "capture_matmul.card")
    run_cli("capture", ["--raw-in", RAW0, "-o", out, "--t0", "0", "--quiet",
                        "--carrier-window", "7-110", "--device", "cuda",
                        "--fft-impl", "matmul"], 40, 0)
    check(card_lines(out) == card_lines(os.path.join(FASTDET, "gated.card")),
          "capture --fft-impl matmul: archive differs from the default run's")
    print("capture --fft-impl matmul: the default run's blocks and payloads "
          "(fastcard's gated.card); 0 power/peak launches (windowed gate)")
    return {k: v for k, v in per_batch.items() if v}


# The live server's mix: bench.py's bench_serve (5 receivers with
# drifting clocks on an 8000 m circle, a beacon a second and a mobile
# transmitting at the rate that gives the detection count over 600 s,
# fed in 5 s chunks).
SERVE_RX = {i: np.array([np.cos(1.7 * i) * 8000.0, np.sin(1.7 * i) * 8000.0])
            for i in range(5)}
SERVE_BEACON = {9: np.array([100.0, 200.0])}
SERVE_MOBILE = np.array([3000.0, 1000.0])
SERVE_FREQMAP = {r: {9: (25.0, 35.0), 3: (65.0, 75.0)} for r in SERVE_RX}
SERVE_STEP_S = 5.0


def serve_mix(num_detections, duration=600.0):
    """Detections of bench_serve's traffic, sorted by timestamp."""
    from thrifty_tpu_torch import sim

    n_tx = num_detections / len(SERVE_RX)
    mobile_dt = duration / max(n_tx - duration, 1.0)
    schedule = [(9, t) for t in np.arange(0.5, duration, 1.0)]
    schedule += [(3, t) for t in np.arange(0.7, duration, mobile_dt)]
    det = sim.synth_network(
        SERVE_RX, {**SERVE_BEACON, 3: SERVE_MOBILE}, schedule, 2.4e6,
        clock_offsets={1: 777.0, 2: -4000.0},
        clock_drifts={1: 2e-6, 2: -1e-6}, soa_noise=0.01)
    det["carrier_bin"] = np.where(det["txid"] == 9, 30, 70)
    return det[np.argsort(det["timestamp"], kind="stable")]


def run_serve(det, device, count_kernels=False):
    """Feed ``det`` to the port's PositioningServer in 5 s chunks,
    stepping after each, as a live deployment's tailer does.  Returns
    (fixes, seconds, [ms per step], solver seconds, and with
    ``count_kernels`` (device kernels, their summed device seconds) from
    torch.profiler)."""
    from thrifty_tpu_torch.pipeline import server

    srv = server.PositioningServer(
        SERVE_RX, SERVE_BEACON, freqmap=SERVE_FREQMAP, match_window=0.05,
        window_s=30.0, settle_s=1.0, solver="auto", device=device)
    edges = np.searchsorted(det["timestamp"], np.arange(
        det["timestamp"][0], det["timestamp"][-1] + SERVE_STEP_S,
        SERVE_STEP_S))
    solve = server.pos_mod.solve_batched
    solver_s = [0.0]

    def timed_solve(*args, **kwargs):
        t0 = time.perf_counter()
        out = solve(*args, **kwargs)   # ends in a copy to the host
        solver_s[0] += time.perf_counter() - t0
        return out

    fixes, steps = [], []
    prof = None
    if count_kernels:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    server.pos_mod.solve_batched = timed_solve
    try:
        t_run = time.perf_counter()
        for a, b in zip(edges[:-1], edges[1:]):
            t0 = time.perf_counter()
            srv.feed(det[a:b])
            fixes.append(srv.step())
            steps.append((time.perf_counter() - t0) * 1e3)
        seconds = time.perf_counter() - t_run
    finally:
        server.pos_mod.solve_batched = solve
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
    kernels = None
    if prof is not None:
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = (len(device),
                   sum(e.time_range.elapsed_us() for e in device) / 1e6)
    return np.concatenate(fixes), seconds, steps, solver_s[0], kernels


def sorted_fixes(fixes):
    return fixes[np.lexsort((fixes["tx"], fixes["timestamp"]))]


def compare_fixes(got, ref, what, xy_atol):
    """(timestamp, tx) sets equal, x/y within ``xy_atol`` m; returns the
    largest distance and the count beyond 1e-6 m."""
    got, ref = sorted_fixes(got), sorted_fixes(ref)
    check(len(got) == len(ref), "{}: {} vs {} fixes".format(
        what, len(got), len(ref)))
    check(np.array_equal(got["timestamp"], ref["timestamp"])
          and np.array_equal(got["tx"], ref["tx"]),
          what + ": (timestamp, tx) sets differ")
    dist = np.hypot(got["x"] - ref["x"], got["y"] - ref["y"])
    worst = float(dist.max()) if len(dist) else 0.0
    check(worst <= xy_atol, "{}: fixes {:.3g} m apart (limit {:g})".format(
        what, worst, xy_atol))
    return worst, int((dist > 1e-6).sum())


def serve_report(card_name, label, det, fixes, seconds, steps, solver_s,
                 kernels=None):
    print("serve {}: {} detections -> {} fixes in {} steps, {:.4g} s: "
          "{:.6g} fixes/s, {:.6g} detections/s; ms per step median "
          "{:.3f}, p90 {:.3f}, max {:.3f}; solver {:.4g} s ({:.1%} of the "
          "run); {}".format(
              label, len(det), len(fixes), len(steps), seconds,
              len(fixes) / seconds, len(det) / seconds,
              float(np.median(steps)), float(np.percentile(steps, 90)),
              max(steps), solver_s, solver_s / seconds, card_name))


def serve_kernels(card_name, label, det, seconds):
    """Device kernels per step and the card's busy share of the run
    (kernel time summed by torch.profiler over a second, profiled run,
    against the unprofiled run's ``seconds``)."""
    _, _, steps, _, (kernels, busy) = run_serve(det, torch.device("cuda"),
                                                count_kernels=True)
    print("serve {}: {:.1f} device kernels per step ({} over {} steps), "
          "{:.4g} s of kernel time: busy share {:.4f}, idle share {:.4f} "
          "of the {:.4g} s run (torch.profiler); {}".format(
              label, kernels / len(steps), kernels, len(steps), busy,
              busy / seconds, 1 - busy / seconds, seconds, card_name))


def serve_phase(card_name):
    """The live server on bench_serve's mix: 20k detections on the card
    and on the CPU (the same fixes), 100k (the 10x density) on the card
    and on the CPU; host clock, set-up excluded."""
    phase("serve")
    from thrifty_tpu_torch.dsp import power_peak as pp

    dev = torch.device("cuda")
    det = serve_mix(20000)
    run_serve(det[det["timestamp"] < 60.0], dev)   # warm-up, 12 steps
    pp.launches = 0
    fixes, seconds, steps, solver_s, _ = run_serve(det, dev)
    check(pp.launches == 0, "serve launched the power/peak kernel")
    serve_report(card_name, "20k cuda", det, fixes, seconds, steps,
                 solver_s)
    serve_kernels(card_name, "20k cuda", det, seconds)
    ref, *cpu = run_serve(det, "cpu")
    serve_report(card_name, "20k cpu", det, ref, *cpu)
    worst, beyond = compare_fixes(fixes, ref, "serve 20k cuda vs cpu", 1e-4)
    mobile = fixes[fixes["tx"] == 3]
    err = np.hypot(mobile["x"] - SERVE_MOBILE[0],
                   mobile["y"] - SERVE_MOBILE[1])
    check(len(mobile) > 0 and err.max() < 15.0,
          "a mobile fix {:.3g} m from the transmitter".format(err.max()))
    print("serve 20k: cuda and cpu give the same {} fixes (timestamp, tx); "
          "x/y max {:.3g} m apart, {} beyond 1e-6 m; {} mobile fixes, all "
          "within {:.3g} m of the transmitter (limit 15 m)".format(
              len(fixes), worst, beyond, len(mobile), err.max()))
    det = serve_mix(100000)
    out = {}
    for name in ("cuda", "cpu"):
        out[name] = run_serve(det, dev if name == "cuda" else "cpu")
        serve_report(card_name, "100k " + name, det, *out[name])
    serve_kernels(card_name, "100k cuda", det, out["cuda"][1])
    worst, beyond = compare_fixes(out["cuda"][0], out["cpu"][0],
                                  "serve 100k cuda vs cpu", math.inf)
    print("serve 100k: the same (timestamp, tx) sets on cuda and cpu; x/y "
          "max {:.3g} m apart, {} beyond 1e-6 m".format(worst, beyond))


def serve_cli_phase(card_name, tmp):
    """``serve --once --track`` through the port's CLI on .toad files
    written by the port's io.toad (bench_serve's 20k mix, the window
    widened to hold all of it), against the same server run in process
    on what a ToadTailer reads from those files."""
    phase("serve CLI")
    import contextlib
    import io

    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.pipeline import identify, pos, server, tdoa, \
        track

    det = serve_mix(20000)
    d = os.path.join(tmp, "serve")
    os.makedirs(d)
    paths = []
    for rxid in SERVE_RX:
        paths.append(os.path.join(d, "rx{}.toad".format(rxid)))
        toad.save(paths[-1], det[det["rxid"] == rxid])
    cfg = {name: os.path.join(d, name) for name in (
        "pos-rx.cfg", "pos-beacon.cfg", "freq-map.cfg")}
    for name, table in (("pos-rx.cfg", SERVE_RX),
                        ("pos-beacon.cfg", SERVE_BEACON)):
        with open(cfg[name], "w") as f:
            f.writelines("{}: {!r} {!r}\n".format(k, float(p[0]), float(p[1]))
                         for k, p in table.items())
    with open(cfg["freq-map.cfg"], "w") as f:
        f.write("9: 25 - 35\n3: 65 - 75\n" + "".join(
            "@{}: 0\n".format(r) for r in SERVE_RX))
    out, trk = os.path.join(d, "live.pos"), os.path.join(d, "live.track")
    log = io.StringIO()   # one "fix:" line per fix
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = main(["serve"] + paths + [
            "-o", out, "--track", trk, "-r", cfg["pos-rx.cfg"], "-b",
            cfg["pos-beacon.cfg"], "-m", cfg["freq-map.cfg"],
            "--match-window", "0.05", "--history", "700", "--once",
            "--device", "cuda"])
    seconds = time.perf_counter() - t0
    check(rc == 0, "serve --once failed: " + log.getvalue()[-2000:])
    with open(cfg["freq-map.cfg"]) as f:
        freqmap = identify.load_freqmap(f)
    srv = server.PositioningServer(
        tdoa.load_pos_config(cfg["pos-rx.cfg"]),
        tdoa.load_pos_config(cfg["pos-beacon.cfg"]), freqmap=freqmap,
        match_window=0.05, window_s=700.0, settle_s=0.0, device="cuda")
    srv.feed(server.ToadTailer(paths).poll())
    ref = srv.step()
    got = pos.load_positions(out)
    worst, _ = compare_fixes(got, ref, "serve --once vs in process", 1e-6)
    check(log.getvalue().count("fix: ") == len(got),
          "serve printed another count of fixes")
    lines = list(track.live_update({}, ref))
    with open(trk) as f:
        written = f.read().splitlines()
    check(len(written) == len(lines) and np.allclose(
        np.array([ln.split() for ln in written], float),
        np.array([ln.split() for ln in lines], float), rtol=0, atol=2e-3),
        "serve --track differs from the in-process tracks")
    print("serve --once --track --device cuda on 5 tailed .toad files ({} "
          "detections): {} fixes and {} track lines, as the in-process "
          "server (x/y within {:.3g} m); {:.3f} s, set-up included; "
          "{}".format(len(det), len(got), len(written), worst, seconds,
                      card_name))


def template_extract_phase(card_name, tmp):
    """``template_extract`` on the card against the CPU, on the full-size
    capture and on tests/golden/input/rx0.card: the same block, the
    template within 1e-5 relative, two power/peak launches per batch."""
    phase("template_extract")
    import contextlib
    import io

    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.io import card

    per_batch = None
    for name, path, tpl in (
            ("full", os.path.join(tmp, "full.card"),
             os.path.join(tmp, "template.npy")),
            ("rx0", os.path.join(INPUT, "rx0.card"),
             os.path.join(INPUT, "template.npy"))):
        batches = math.ceil(len(card.read_card(path)[0]) / BATCH)
        runs = {}
        for dev in ("cuda", "cpu"):
            npy = os.path.join(tmp, "tpl_{}_{}.npy".format(name, dev))
            buf = io.StringIO()
            pp.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main(["template_extract", path, "-o", npy, "-c",
                           os.path.join(INPUT, "detector.cfg"),
                           "--template", tpl, "--batch-size", str(BATCH),
                           "--device", dev])
            seconds = time.perf_counter() - t0
            check(rc == 0, "template_extract {} {} failed: {}".format(
                name, dev, buf.getvalue()))
            line = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("Captured")]
            check(len(line) == 1, "template_extract printed no block")
            runs[dev] = (line[0].split("#")[1].split()[0], np.load(npy),
                         seconds, pp.launches)
        block, got, seconds, launches = runs["cuda"]
        check(launches == 2 * batches, "template_extract {}: {} launches for "
              "{} batches".format(name, launches, batches))
        check(block == runs["cpu"][0], "template_extract {}: block {} on the "
              "card, {} on the cpu".format(name, block, runs["cpu"][0]))
        ref = runs["cpu"][1]
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(got.shape == ref.shape and rel <= 1e-5,
              "template_extract {}: template off by {:.3g} relative".format(
                  name, rel))
        if name == "rx0":
            golden = np.load(os.path.join(GOLDEN, "tools",
                                          "template_extracted.npy"))
            check(np.max(np.abs(got - golden)) <= 1e-5 * np.max(
                np.abs(golden)), "rx0: template off the reference golden")
        per_batch = launches / batches
        print("template_extract {}: block #{} on cuda and cpu, template "
              "within {:.3g} relative; {} power/peak launches in {} batches; "
              "cuda {:.3f} s, cpu {:.3f} s (CLI, set-up included); {}".format(
                  name, block, rel, launches, batches, seconds,
                  runs["cpu"][2], card_name))
    return {"template_extract": per_batch}


# doctor --selfcheck's power/peak launches: the detector check (one
# batch), the pipeline check (one batch of the detect CLI), the selfcheck's
# kernel against plain in two layouts, and its detector on the card.
DOCTOR_BATCHES = 4


def doctor_phase(card_name):
    phase("doctor")
    import contextlib
    import io

    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.dsp import power_peak as pp

    buf = io.StringIO()
    pp.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["doctor", "--selfcheck", "--batch", str(BATCH), "--json"])
    seconds = time.perf_counter() - t0
    launches = pp.launches
    data = json.loads(buf.getvalue().strip().splitlines()[-1])
    for d in data:
        print("doctor {}: {} ({})".format(d["check"], "ok" if d["ok"] else
                                          "FAIL", d["detail"]))
    check(rc == 0 and all(d["ok"] for d in data), "doctor failed")
    check([d["check"] for d in data] == [
        "versions", "devices", "native", "kernel-build", "detector",
        "pipeline", "selfcheck"], "doctor ran other checks")
    check(launches == 2 * DOCTOR_BATCHES,
          "doctor: {} power/peak launches".format(launches))
    print("doctor --selfcheck --batch {}: every check ok, rc 0, {} power/peak "
          "launches ({} batches), {:.2f} s; {}".format(
              BATCH, launches, DOCTOR_BATCHES, seconds, card_name))
    return {"doctor": launches / DOCTOR_BATCHES}


# The bench phase: programs of `python -m thrifty_tpu_torch.cli bench` at
# the deployment's geometry (block 16384, history 4920, the 4914-sample
# template, bins 7-110, batch 256, a burst every 4 blocks, gate batch//2),
# each run in this process through the CLI, as a user runs them.
BENCH_RUNS = (
    ("batch", ["--repeats", "3", "--scan-k", "8", "--sweep", "64,128,256"]),
    ("batch c64 integer", ["--input", "c64", "--sync-mode", "integer",
                           "--sweep", "none"]),
    ("selfcheck wide", ["--program", "selfcheck", "--wide"]),
    ("abcheck", ["--program", "abcheck", "--ab", "fft_impl=matmul"]),
    ("abcheck knee gate", ["--program", "abcheck", "--ab-knee", "--ab",
                           "gate_capacity=64"]),
    ("e2e raw", ["--program", "e2e", "--input", "raw", "--e2e-bytes",
                 "2e8"]),
    ("e2e raw device-unfold", ["--program", "e2e", "--input", "raw",
                               "--e2e-bytes", "2e8", "--device-unfold"]),
    ("e2e card", ["--program", "e2e", "--input", "card", "--e2e-bytes",
                  "5e7"]),
    ("serve", ["--program", "serve"]),
)
# `--program stream` runs in a child process, a NCCL world of one, so no
# process group outlives it here; the child counts as the phase does.
BENCH_STREAM = r"""
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from thrifty_tpu_torch.cli import main
from thrifty_tpu_torch.dsp import power_peak as pp
with chip_smoke.counted_batches() as seen:
    pp.launches = 0
    rc = main(["bench", "--program", "stream"])
    launches = pp.launches
print(json.dumps({{"rc": rc, "launches": launches,
                  "expected": chip_smoke.expected_launches(seen),
                  "batches": chip_smoke.program_runs(seen)}}))
"""


@contextlib.contextmanager
def counted_batches():
    """Every run of a ``BatchDetector``'s detect program while the block
    runs (eager or captured), as (detector, PendingBatch), read off the
    detector's one entry to it, and every run of a gated batch's
    re-run program from its raw bytes, as (detector, None)."""
    from thrifty_tpu_torch.dsp.detector import BatchDetector

    seen = []
    original = BatchDetector._detect_batch, BatchDetector._redo_program

    def counted(self, blocks):
        pending = original[0](self, blocks)
        seen.append((self, pending))
        return pending

    def counted_redo(self, raw):
        seen.append((self, None))
        return original[1](self, raw)

    BatchDetector._detect_batch = counted
    BatchDetector._redo_program = counted_redo
    try:
        yield seen
    finally:
        BatchDetector._detect_batch, BatchDetector._redo_program = original


def expected_launches(seen):
    """The power/peak launches of the program runs ``seen``: on the card
    2 a run (carrier and correlation), 1 where the carrier stage runs
    without the kernel (the windowed carrier DFT, the peak filter), plus
    1 for each eager gated batch that overflowed and re-ran its
    correlation; a re-run from raw bytes does the carrier stage again.
    None on the CPU."""
    total = 0
    for det, pending in seen:
        if det.device.type == "cuda":
            plain_carrier = det._carrier_win is not None \
                or det._peak_filter is not None
            total += (1 if plain_carrier else 2) + bool(
                pending is not None and pending.overflowed)
    return total


def overflows(seen):
    """The overflow re-runs of the detectors of ``seen``, every kind."""
    return sum({id(det): det.gate_overflows for det, _ in seen}.values())


def program_runs(seen):
    """The detect program's runs on the card in ``seen`` (not the
    re-runs)."""
    return sum(det.device.type == "cuda" and pending is not None
               for det, pending in seen)


def bench_contract(data, label):
    """The last JSON line's contract, as tests/test_bench.py checks the
    JAX bench's, plus a positive value and a pass where one is graded."""
    metric = data.get("metric")
    check({"metric", "value", "unit", "vs_baseline"} <= set(data),
          "bench {}: keys {}".format(label, sorted(data)))
    check(data["value"] > 0 and data["vs_baseline"] > 0,
          "bench {}: value {}".format(label, data["value"]))
    if metric == "detect_throughput":
        check(data["unit"] == "IQ_samples/s/chip", label + ": unit")
        check(data["relay_degraded"] in (False, True)
              and data["anomalously_fast"] in (False, True), label)
        check(len(data["runs_sec_per_batch"]) >= 1 and all(
            math.isfinite(r) for r in data["runs_sec_per_batch"]), label)
        check({"batch", "iters", "sync_mode", "pallas", "input"}
              <= set(data), label + ": diagnostic keys")
        check(data["headline_batch"] == BATCH, label + ": headline batch")
        check(data["device"].startswith("cuda:"), label + ": device")
        if data["program"] == "batch":
            check(data["method"] == "event_slope" and data["scan_k"] >= 1
                  and data["clock"] == "cuda_events"
                  and data["dispatch_chain_sec_per_batch"] > 0
                  and data["scan_dispatch_times"]["t_k_s"]
                  and data["scan_dispatch_times"]["t_2k_s"],
                  label + ": method")
        else:
            check(data["program"] == "stream"
                  and data["method"] == "wallclock_chain"
                  and data["clock"] == "host", label + ": method")
    elif metric.startswith("e2e_throughput_"):
        check(data["unit"] == "IQ_samples/s" and data["blocks"] > 0
              and data["drain"] == "host", label + ": e2e keys")
    elif metric == "serve_throughput":
        check(data["unit"] == "fixes/s", label + ": unit")
    else:
        check(metric in ("pallas_xla_selfcheck", "config_abcheck",
                         "config_abcheck_knee")
              and data["unit"] == "pass" and data["value"] == 1.0,
              "bench {}: {} did not pass: {}".format(label, metric, data))
    if metric == "pallas_xla_selfcheck":
        check(data["devices"]["on"].startswith("cuda:")
              and data["devices"]["off"] == "cpu" and data["wide"],
              label + ": devices")


def bench_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def bench_phase(card_name):
    """The port's ``bench`` programs on the card: each rc 0 with its JSON
    contract, the graded ones passing, and the power/peak launches of
    its batches (2 a batch, 1 on the windowed carrier path, +1 per gate
    overflow)."""
    phase("bench")
    import io

    from thrifty_tpu_torch.cli import main
    from thrifty_tpu_torch.dsp import power_peak as pp

    t_phase = time.perf_counter()
    launches = batches = 0
    for label, args in BENCH_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with counted_batches() as seen, contextlib.redirect_stdout(buf):
            pp.launches = 0
            rc = main(["bench"] + args)
            got = pp.launches
        seconds = time.perf_counter() - t0
        check(rc == 0, "bench {}: rc {}".format(label, rc))
        data = bench_line(buf.getvalue())
        bench_contract(data, label)
        want = expected_launches(seen)
        runs, redone = program_runs(seen), overflows(seen)
        check(got == want, "bench {}: {} power/peak launches, want {} ({} "
              "program runs, {} overflows)".format(label, got, want, runs,
                                                   redone))
        check(len(seen) > 0 or data["metric"] == "serve_throughput",
              "bench {}: no detector batch".format(label))
        launches += got
        batches += runs
        print("bench {} ({:.1f} s; {} power/peak launches in {} program "
              "runs, {} overflows; {}): {}".format(
                  label, seconds, got, runs, redone, card_name,
                  json.dumps(data)), flush=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_STREAM.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, "bench stream: rc {}: {}".format(
        proc.returncode, proc.stderr[-3000:]))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    counts, data = json.loads(lines[-1]), json.loads(lines[-2])
    check(counts["rc"] == 0, "bench stream: rc {}".format(counts["rc"]))
    bench_contract(data, "stream")
    check(data["program"] == "stream", "bench stream: program")
    check(counts["launches"] == counts["expected"] and counts["batches"] > 0,
          "bench stream: {}".format(counts))
    launches += counts["launches"]
    batches += counts["batches"]
    print("bench stream, NCCL world of one ({:.1f} s; {} power/peak launches "
          "in {} batches; {}): {}".format(seconds, counts["launches"],
                                          counts["batches"], card_name,
                                          json.dumps(data)), flush=True)
    print("bench phase: {} programs, {} power/peak launches in {} card "
          "batches, {:.1f} s; {}".format(len(BENCH_RUNS) + 1, launches,
                                        batches,
                                        time.perf_counter() - t_phase,
                                        card_name))
    return {"bench": launches / batches}


# The multi-rank stream phase: __graft_entry__.py's dryrun_multichip on
# the card, through thrifty_tpu_torch.parallel.  A gloo world of 4 ranks
# on an (rx=2, time=2) mesh, every rank computing on the one card (NCCL
# refuses two ranks on one card), then a world of 1 over NCCL.
MR_MESH = (2, 2)
MR_TIMEOUT_S = 300        # per world, the ranks' start-up included
MR_TINY_PER = 3           # blocks per rank at the tiny geometry: the
                          # halo burst's carrier then also lies in the
                          # last block of time rank 0, which then holds two
                          # carrier blocks (over a gate capacity of 1)
MR_FULL_PER = 64          # blocks per rank at the full geometry
MR_TIMING_REPS = 5
TINY = dict(block_len=256, history_len=64, carrier_window=(4, 60),
            gn_iters=4)
FULL = dict(carrier_window=(7, 110))
# scripts/network_demo_torch.py's network (scripts/network_demo.py's).
NET_RX = {0: np.array([0.0, 0.0]), 1: np.array([9000.0, 500.0]),
          2: np.array([4000.0, 8000.0]), 3: np.array([-2000.0, 5000.0])}
NET_BEACON = {9: np.array([4500.0, 3000.0])}
NET_MOBILE = np.array([6000.0, 2500.0])
NET_BLOCKS = 80
FIX_BAR_M = 15.0          # PERF.md section 2 (the JAX demo's worst: 0.93 m)
MR_EXACT = ("detected", "carrier_detect", "carrier_bin", "corr_sample",
            "template_idx", "block_idx")


def planted_streams(num_rx, total_blocks, halo_block, block_len, history,
                    template, carrier_bin, amplitude, noise_std, bank=None,
                    seed=7):
    """Per-RX streams with one mid-window burst and one HALO burst
    (__graft_entry__._planted_streams on the port's sim and xcorr).

    The mid burst sits in the middle of block 1's unique correlation
    window.  The halo burst is placed at the START of ``halo_block``'s
    unique window, so its code span lies almost entirely in the history
    region: samples that, in the rank program, arrive from the PREVIOUS
    time rank through the halo exchange.

    Returns (streams [R, L] complex64, truth list of (rx, block,
    expected_soa, template_idx)).
    """
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import xcorr

    tlen = (bank.shape[1] if bank is not None else len(template))
    new_len = block_len - history
    length = total_blocks * new_len
    win_lo, _ = xcorr.corr_window(block_len, history, tlen)
    mid_lag = history + (block_len - tlen - history) // 2
    halo_lag = win_lo + 8

    rng = np.random.default_rng(seed)
    streams, truth = [], []
    for r in range(num_rx):
        plan = [(1 if total_blocks > 1 else 0, mid_lag, 0)]
        if halo_block not in (p[0] for p in plan):
            plan.append((halo_block, halo_lag, 1))
        bursts = []
        for b, lag, code in plan:
            pos = b * new_len - history + lag
            if pos < 0 or pos + tlen > length:
                continue
            spec = {
                "position": pos,
                "carrier_bin": carrier_bin + float(rng.uniform(-0.3, 0.3)),
                "amplitude": amplitude,
                "phase": float(rng.uniform(0, 2 * np.pi)),
            }
            tidx = 0
            if bank is not None:
                tidx = code % len(bank)
                spec["template"] = bank[tidx]
            bursts.append(spec)
            truth.append((r, b, float(pos + history), tidx))
        streams.append(sim.synth_stream(
            length, bursts, template if bank is None else bank[0],
            block_len, noise_std, seed=seed + 100 + r))
    return np.stack(streams).astype(np.complex64), truth


def assert_bursts(detector, out, truth, num_rx, total_blocks, tag,
                  check_template=False):
    """Planted bursts detected at their ground-truth SoAs (within 0.05
    samples), no detection away from them (__graft_entry__.
    _assert_bursts).  Returns the largest SoA error."""
    det = np.asarray(out["detected"])
    check(det.shape == (num_rx, total_blocks), "{}: table {}".format(
        tag, det.shape))
    planted, worst = set(), 0.0
    for r, b, exp_soa, tidx in truth:
        check(det[r, b], "{}: missed the burst of rx {} block {}".format(
            tag, r, b))
        soa = detector.soa(out["block_idx"][r, b], out["corr_sample"][r, b],
                           out["corr_offset"][r, b])
        worst = max(worst, abs(float(soa) - exp_soa))
        check(abs(float(soa) - exp_soa) < 0.05, "{}: SoA off at rx {} block "
              "{}: {} vs {}".format(tag, r, b, float(soa), exp_soa))
        if check_template:
            got = int(out["template_idx"][r, b])
            check(got == tidx, "{}: template {} at rx {} block {}, not "
                  "{}".format(tag, got, r, b, tidx))
        planted.add((r, b))
    # Blocks next to a planted burst may fire on a code-correlation
    # sidelobe when the burst straddles the block boundary (the halo
    # burst does, by design); the reference dedups those downstream.
    allowed = planted | {(r, b + d) for r, b in planted for d in (-1, 1)}
    for r in range(num_rx):
        for b in range(total_blocks):
            check((r, b) in allowed or not det[r, b],
                  "{}: false positive at rx {} block {}".format(tag, r, b))
    return worst


def network_captures(num_blocks=NET_BLOCKS):
    """scripts/network_demo_torch.py's captures (seed 11)."""
    from thrifty_tpu_torch import sim

    schedule = [(9, t) for t in np.arange(0.02, 0.36, 0.05)]
    schedule += [(3, t) for t in (0.085, 0.185, 0.285)]
    return sim.synth_rx_captures(
        NET_RX, {**NET_BEACON, 3: NET_MOBILE}, {9: 30, 3: 70}, schedule,
        template=sim.make_template(), num_blocks=num_blocks, amplitude=0.6,
        noise_std=0.04, clock_offsets={1: 777.25, 2: -123.5, 3: 2001.75},
        clock_drifts={1: 3e-6, 2: -2e-6, 3: 1e-6}, seed=11)


def multirank_inputs(d):
    """Write the worlds' inputs (``inputs.npz``) and runs (``gloo.json``,
    ``nccl.json``) into ``d``.  Returns (inputs, truths, network
    captures)."""
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import template as template_mod

    num_rx, num_time = MR_MESH
    tiny_tpl = template_mod.generate(5, 0, 2.0)  # 62 samples
    tiny_bank = np.stack([template_mod.generate(5, i, 2.0) for i in (0, 1)])
    full_tpl = sim.make_template()
    full_bank = template_mod.generate_bank(11, (0, 1), 2.4e6 / CHIP_RATE)
    tiny_total, full_total = MR_TINY_PER * num_time, MR_FULL_PER * num_time
    planted = dict(num_rx=num_rx, template=tiny_tpl, block_len=256,
                   history=64, carrier_bin=40.25, amplitude=0.8,
                   noise_std=0.05)
    inputs, truths = {"tiny_tpl": tiny_tpl, "tiny_bank": tiny_bank,
                      "full_tpl": full_tpl, "full_bank": full_bank}, {}
    for name, kw in (("tiny", {}), ("tiny_bank", dict(bank=tiny_bank))):
        inputs[name + "_streams"], truths[name] = planted_streams(
            total_blocks=tiny_total,
            halo_block=(num_time - 1) * MR_TINY_PER,
            **planted, **kw)
    planted.update(template=full_tpl, block_len=16384, history=4920,
                   amplitude=0.5)
    for name, kw in (("full", {}), ("full_bank", dict(bank=full_bank))):
        inputs[name + "_streams"], truths[name] = planted_streams(
            total_blocks=full_total,
            halo_block=(num_time - 1) * MR_FULL_PER, **planted, **kw)
    caps = network_captures()
    inputs["net_streams"] = np.stack([
        caps[r].blocks[:, 4920:].reshape(-1)
        for r in sorted(caps)]).astype(np.complex64)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)

    def run(name, template, streams, config, per, program="stream",
            mesh=MR_MESH):
        return dict(name=name, template=template, input=streams,
                    config=config, per_shard=per, program=program,
                    mesh=list(mesh))

    gloo = [run("tiny", "tiny_tpl", "tiny_streams", TINY, MR_TINY_PER),
            run("tiny_gated", "tiny_tpl", "tiny_streams",
                dict(TINY, gate_capacity=1), MR_TINY_PER),
            run("tiny_twin", "tiny_tpl", "tiny_streams", TINY, MR_TINY_PER,
                "gspmd"),
            run("tiny_bank", "tiny_bank", "tiny_bank_streams", TINY,
                MR_TINY_PER),
            run("full", "full_tpl", "full_streams", FULL, MR_FULL_PER),
            run("full_twin", "full_tpl", "full_streams", FULL, MR_FULL_PER,
                "gspmd"),
            run("full_bank", "full_bank", "full_bank_streams", FULL,
                MR_FULL_PER),
            run("edge", "full_tpl", "net_streams", FULL,
                NET_BLOCKS // num_time)]
    nccl = [run("nccl_full", "full_tpl", "full_streams", FULL, full_total,
                mesh=(1, 1)),
            run("nccl_batch", "full_tpl", "full_streams", FULL, 0, "batch",
                mesh=(1, 1))]
    for name, runs in (("gloo", gloo), ("nccl", nccl)):
        with open(os.path.join(d, name + ".json"), "w") as f:
            json.dump(dict(runs=runs, timed="full" if name == "gloo"
                           else "nccl_full"), f)
    return inputs, truths, caps


def multirank_rank(rank, world, backend, d, device):
    """One rank of a world of the multi-rank phase (a spawned process):
    every run of ``<backend>.json`` through the port's entry points, the
    power/peak launches of each counted from 0, then the timed run split
    into halo exchange, detect and gather; saves ``<backend>_<rank>.npz``.
    """
    import torch.distributed as dist

    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.parallel import distributed, mesh as mesh_mod, \
        sharded

    distributed.initialize(
        init_method="file://" + os.path.join(d, backend + ".store"),
        num_processes=world, process_id=rank, backend=backend,
        device=device)
    with open(os.path.join(d, backend + ".json")) as f:
        spec = json.load(f)
    inputs = np.load(os.path.join(d, "inputs.npz"))
    meshes, saved, timed = {}, {}, None
    for run in spec["runs"]:
        key = tuple(run["mesh"])
        if key not in meshes:  # every rank makes the same groups in order
            meshes[key] = mesh_mod.make_mesh(*key, device=device)
        m = meshes[key]
        config = dict(run["config"], carrier_window=tuple(
            run["config"]["carrier_window"]))
        det = BatchDetector(inputs[run["template"]],
                            DetectorConfig(**config), device=device)
        streams = inputs[run["input"]]
        if run["program"] == "batch":
            # Blocks that carry their halo: receiver 0's first 64.
            fn = sharded.batch_detect_sharded(det, m)
            data = sim.stream_to_blocks(streams[0], 16384, 4920)[:64]
            saved[run["name"] + "/input"] = data
        else:
            total = run["per_shard"] * key[1]
            fn = sharded.make_stream_detector_gspmd(det, total, m) \
                if run["program"] == "gspmd" else \
                sharded.make_stream_detector(det, key[0], run["per_shard"],
                                             m, gather=True)
            data = sharded.shard_stream(streams, m)
        if device == "cuda":
            torch.cuda.synchronize()
        pp.launches = 0
        out = fn(data)
        launches = pp.launches
        for k, v in out.items():
            saved[run["name"] + "/" + k] = v.cpu().numpy()
        saved[run["name"] + "/launches"] = np.array(launches)
        saved[run["name"] + "/overflows"] = np.array(det.gate_overflows)
        if run["name"] == spec["timed"]:
            timed = (det, fn, data, m, run["per_shard"])
    det, fn, chunk, m, per = timed
    t = m.coords()[1]
    history = det.config.history_len
    split = {k: [] for k in ("halo", "detect", "gather", "call")}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for _ in range(MR_TIMING_REPS):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        halo = sharded._exchange_halo(chunk[:, chunk.shape[1] - history:], m)
        sync()
        t1 = time.perf_counter()
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = sharded._local_detect(det, chunk, halo, t, per)
        if device == "cuda":
            end.record()
            end.synchronize()
        t2 = time.perf_counter()
        sharded._gather_table(out, m)
        sync()
        t3 = time.perf_counter()
        dist.barrier()
        sync()
        t4 = time.perf_counter()
        fn(chunk)
        sync()
        t5 = time.perf_counter()
        split["halo"].append((t1 - t0) * 1e3)
        split["detect"].append(start.elapsed_time(end) if device == "cuda"
                               else (t2 - t1) * 1e3)
        split["gather"].append((t3 - t2) * 1e3)
        split["call"].append((t5 - t4) * 1e3)
    for k, v in split.items():
        saved["timing/" + k] = np.array(v)
    saved["timing/rows"] = np.array(chunk.shape[0] * per)
    np.savez(os.path.join(d, "{}_{}.npz".format(backend, rank)), **saved)
    dist.barrier()
    dist.destroy_process_group()


def run_world(world, backend, d, device):
    """Spawn the ranks of one world, wait for them (``MR_TIMEOUT_S`` in
    all), stop any still running and fail unless every rank exited 0.
    Returns each rank's saved outputs."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=multirank_rank,
                         args=(rank, world, backend, d, device))
             for rank in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MR_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), "{} world of {}: rank exit codes {} "
          "(None: still running after {} s)".format(backend, world, codes,
                                                    MR_TIMEOUT_S))
    print("{} world of {} ranks on {}: every rank exited 0 in {:.1f} s, "
          "start-up included".format(backend, world, device,
                                     time.perf_counter() - t0))
    return [dict(np.load(os.path.join(d, "{}_{}.npz".format(backend, k))))
            for k in range(world)]


def rank_result(ranks, name, rank=0):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in ranks[rank].items()
            if k.startswith(pre) and k[len(pre):] not in (
                "launches", "overflows", "input")}


def stitched(ranks, name, mesh=MR_MESH):
    """The [R, total] table of a gather=False run from the ranks'
    slices (rank r*T + t holds rows of rx row r, blocks of time t)."""
    parts = [rank_result(ranks, name, k) for k in range(len(ranks))]
    num_rx, num_time = mesh
    return {f: np.concatenate([np.concatenate(
        [parts[r * num_time + t][f] for t in range(num_time)], axis=1)
        for r in range(num_rx)]) for f in parts[0]}


def compare_tables(got, ref, what):
    """Integer fields exact, float fields within 2e-4 (absolute and
    relative: tests/test_sharded.py's tolerance); returns the largest
    float difference."""
    worst = 0.0
    for k, r in ref.items():
        g = got[k]
        check(g.shape == r.shape, "{}: {} shape {} vs {}".format(
            what, k, g.shape, r.shape))
        if k in MR_EXACT:
            check(np.array_equal(g, r), "{}: {} differs".format(what, k))
        else:
            check(np.allclose(g, r, rtol=2e-4, atol=2e-4),
                  "{}: {} beyond 2e-4".format(what, k))
            worst = max(worst, float(np.max(np.abs(g - r), initial=0.0)))
    return worst


def edge_fixes(table, caps, detector, device):
    """The gathered table -> detection records -> identify -> match ->
    tdoa -> the batched solver on ``device`` (the JAX demo's chain)."""
    import functools

    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.pipeline import kitchen_sink, pos

    parts = []
    for ri, rxid in enumerate(sorted(caps)):
        soa = detector.soa(table["block_idx"][ri], table["corr_sample"][ri],
                           table["corr_offset"][ri])
        parts.append(toad.from_detector_output(
            caps[rxid].timestamps, table["block_idx"][ri], soa,
            {k: v[ri] for k, v in table.items() if k != "block_idx"},
            rxid=rxid))
    settings = kitchen_sink.PostdetectSettings(
        freqmap={r: {9: (25.0, 35.0), 3: (65.0, 75.0)} for r in NET_RX},
        match_window=0.02, tdoa_est_window=8.0, rx_pos=NET_RX,
        beacon_pos=NET_BEACON, sample_rate=2.4e6)
    return kitchen_sink.postdetect(
        np.concatenate(parts), settings, pos_estimator=functools.partial(
            pos.solve_batched, device=device, verbose=False)).pos


def multirank_phase(card_name, device="cuda"):
    """The multi-rank streaming program (``thrifty_tpu_torch.parallel``)
    on the card, as ``__graft_entry__.dryrun_multichip`` runs JAX's on a
    mesh: a gloo world of 4 ranks, mesh (rx=2, time=2), at the tiny
    geometry (plain, gated at capacity 1, the GSPMD twin, a 2-code bank)
    and the full one (16384/4920/4914, 64 blocks a rank, the twin, a
    2-code bank), planted bursts across the rank boundary; the network
    demo's scenario through identify -> match -> tdoa -> pos; then a
    world of 1 over NCCL.  ``device="cpu"`` rehearses it on the CPU
    (gloo only)."""
    phase("multi-rank stream")
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    d = tempfile.mkdtemp(prefix="multirank_")
    try:
        t0 = time.perf_counter()
        inputs, truths, caps = multirank_inputs(d)
        print("inputs synthesised in {:.1f} s".format(
            time.perf_counter() - t0))
        ranks = run_world(4, "gloo", d, device)
        nccl = run_world(1, "nccl", d, device) if device == "cuda" else None

        def detector(template, config):
            return BatchDetector(inputs[template], DetectorConfig(**config),
                                 device=device)

        tiny_det = detector("tiny_tpl", TINY)
        num_rx, num_time = MR_MESH
        tiny = rank_result(ranks, "tiny")
        for k in range(1, len(ranks)):
            other = rank_result(ranks, "tiny", k)
            check(all(np.array_equal(other[f], tiny[f]) for f in tiny),
                  "rank {} holds another gathered table".format(k))
        tiny_total = MR_TINY_PER * num_time
        worst = assert_bursts(tiny_det, tiny, truths["tiny"], num_rx,
                              tiny_total, "tiny")
        gated = rank_result(ranks, "tiny_gated")
        assert_bursts(tiny_det, gated, truths["tiny"], num_rx, tiny_total,
                      "tiny-gated")
        check(np.array_equal(gated["detected"], tiny["detected"]),
              "tiny-gated: decisions differ from ungated")
        over = [int(r["tiny_gated/overflows"]) for r in ranks]
        check(0 in over and max(over) > 0, "tiny-gated: overflows per rank "
              "{}: want some ranks over capacity 1 and one not".format(over))
        twin = stitched(ranks, "tiny_twin")
        check(all(np.array_equal(twin[f], tiny[f]) for f in tiny),
              "tiny: the GSPMD twin differs from the gathered table")
        assert_bursts(tiny_det, rank_result(ranks, "tiny_bank"),
                      truths["tiny_bank"], num_rx, tiny_total, "tiny-bank",
                      check_template=True)
        print("tiny (256/64, 5-bit code, mesh 2x2): every planted burst "
              "found (halo burst included) within {:.3g} samples, no false "
              "positive, the same table on every rank; gated at capacity 1 "
              "(overflow re-runs per rank {}) = ungated; GSPMD twin = "
              "gathered table; 2-code bank right".format(worst, over))

        full_det = detector("full_tpl", FULL)
        total = MR_FULL_PER * num_time
        full = rank_result(ranks, "full")
        worst = assert_bursts(full_det, full, truths["full"], num_rx, total,
                              "full")
        refs = []
        for r in range(num_rx):
            blocks = sim.stream_to_blocks(inputs["full_streams"][r], 16384,
                                          4920)
            ref = {k: v.cpu().numpy() for k, v in full_det(blocks).items()}
            ref["block_idx"] = np.arange(total, dtype=np.int32)
            refs.append(ref)
        ref = {k: np.stack([x[k] for x in refs]) for k in refs[0]}
        diff = compare_tables(full, ref, "full vs one process")
        twin = stitched(ranks, "full_twin")
        check(all(np.array_equal(twin[f], full[f]) for f in full),
              "full: the GSPMD twin differs from the gathered table")
        bank_det = detector("full_bank", FULL)
        assert_bursts(bank_det, rank_result(ranks, "full_bank"),
                      truths["full_bank"], num_rx, total, "full-bank",
                      check_template=True)
        print("full (16384/4920/4914, mesh 2x2, [{}, 16384] a rank): every "
              "planted burst found within {:.3g} samples (halo burst "
              "included); table = the single-process detector on the "
              "host-unfolded blocks (integers exact, floats within {:.3g}); "
              "GSPMD twin = gathered; 2-code full bank right".format(
                  MR_FULL_PER, worst, diff))

        net_det = detector("full_tpl", FULL)
        fixes = edge_fixes(rank_result(ranks, "edge"), caps, net_det,
                           device)
        mobile = fixes[fixes["tx"] == 3]
        err = np.hypot(mobile["x"] - NET_MOBILE[0],
                       mobile["y"] - NET_MOBILE[1])
        check(len(mobile) == 3 and err.max() < FIX_BAR_M,
              "server edge: mobile fixes {} m from the transmitter".format(
                  err.tolist()))
        cpu_det = BatchDetector(inputs["full_tpl"], DetectorConfig(**FULL),
                                device="cpu")
        t0 = time.perf_counter()
        cpu = {}
        for r in range(len(caps)):
            blocks = sim.stream_to_blocks(inputs["net_streams"][r], 16384,
                                          4920)
            for k, v in cpu_det(blocks).items():
                cpu.setdefault(k, []).append(v.numpy())
        cpu = {k: np.stack(v) for k, v in cpu.items()}
        cpu["block_idx"] = np.broadcast_to(
            np.arange(NET_BLOCKS, dtype=np.int32), cpu["detected"].shape)
        ref_fixes = edge_fixes(cpu, caps, cpu_det, "cpu")
        cpu_s = time.perf_counter() - t0
        worst, beyond = compare_fixes(fixes, ref_fixes,
                                      "server edge vs one CPU process", 1e-4)
        print("server edge (4 receivers x {} blocks, mesh 2x2, [{}, 16384] "
              "a rank): {} fixes, mobile {} m from (6000, 2500) (limit {} "
              "m); equal to the chain in one CPU process: (timestamp, tx) "
              "exact, x/y within {:.3g} m, {} beyond 1e-6 m (CPU chain {:.1f} "
              "s)".format(NET_BLOCKS, 2 * NET_BLOCKS // num_time, len(fixes),
                          np.round(err, 3).tolist(), FIX_BAR_M, worst, beyond,
                          cpu_s))

        launches = {name: [int(r[name + "/launches"]) for r in ranks]
                    for name in ("tiny", "tiny_gated", "tiny_twin",
                                 "tiny_bank", "full", "full_twin",
                                 "full_bank", "edge")}
        for name, counts in launches.items():
            over = [int(r[name + "/overflows"]) for r in ranks]
            want = [2 + o for o in over] if device == "cuda" else [0] * 4
            check(counts == want, "{}: power/peak launches per rank {}, "
                  "want {}".format(name, counts, want))
        print("power/peak launches per rank-local batch (ranks 0-3): {}; "
              "{}".format("; ".join("{} {}".format(k, v)
                                    for k, v in launches.items()),
                          card_name))
        report_split("gloo world of 4, full geometry", ranks, card_name)
        if nccl is not None:
            got = rank_result(nccl, "nccl_full")
            diff = compare_tables(got, ref, "nccl world of 1 vs one process")
            batch = rank_result(nccl, "nccl_batch")
            one = {k: v.cpu().numpy() for k, v in full_det(
                nccl[0]["nccl_batch/input"]).items()}
            compare_tables(batch, one, "nccl batch_detect_sharded")
            counts = [int(nccl[0][n + "/launches"])
                      for n in ("nccl_full", "nccl_batch")]
            check(counts == [2, 2], "nccl: launches {}".format(counts))
            print("nccl world of 1 (mesh 1x1, [{}, 16384]): the gathered "
                  "table = the single-process detector (floats within "
                  "{:.3g}); batch_detect_sharded = the detector; 2 "
                  "power/peak launches a call".format(2 * total, diff))
            report_split("nccl world of 1, full geometry", nccl, card_name)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"stream (rank)": float(np.mean(launches["full"]))}


# The tools phase: the port's counterparts of the JAX package's tool
# scripts, each run as a user runs it, in a child process on the card.
# Every child (and every process it spawns) gets this sitecustomize on
# PYTHONPATH: it wraps BatchDetector._detect_batch and _redo_program as
# counted_batches() does and, at exit, writes the process's
# power_peak.launches beside expected_launches() of the runs it saw.
COUNTING_HOOK = r'''
import atexit, json, os, sys
from importlib.machinery import PathFinder

_SEEN = []


class _CountBatches:
    def find_spec(self, name, path=None, target=None):
        if name != "thrifty_tpu_torch.dsp.detector":
            return None
        spec = PathFinder.find_spec(name, path)
        load = spec.loader.exec_module

        def exec_module(module):
            load(module)
            detector = module.BatchDetector
            original = detector._detect_batch, detector._redo_program

            def counted(self, blocks):
                pending = original[0](self, blocks)
                _SEEN.append((self, pending))
                return pending

            def counted_redo(self, raw):
                _SEEN.append((self, None))
                return original[1](self, raw)

            detector._detect_batch = counted
            detector._redo_program = counted_redo

        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, _CountBatches())


@atexit.register
def _report():
    pp = sys.modules.get("thrifty_tpu_torch.dsp.power_peak")
    if pp is None:
        return
    sys.path.insert(0, os.environ["CHIP_SMOKE_ROOT"])
    import chip_smoke
    path = os.path.join(os.environ["CHIP_SMOKE_COUNTS"],
                        "%d.json" % os.getpid())
    with open(path + ".part", "w") as f:
        json.dump({"launches": pp.launches,
                   "expected": chip_smoke.expected_launches(_SEEN),
                   "batches": chip_smoke.program_runs(_SEEN),
                   "overflows": chip_smoke.overflows(_SEEN)}, f)
    os.replace(path + ".part", path)  # a reader sees whole files only
'''
TOOL_TIMEOUT_S = 300
DEPLOY_BLOCKS = 64        # 4 batches of 16 through the supervisor's FIFO
DEPLOY_BATCH = 16
SWEEP_TRIALS = 20


class Tool:
    """One tool script run in a child process with the counting hook, in
    a session of its own (so :meth:`stop` reaches every process it
    starts); its output goes to files in the phase's directory."""

    def __init__(self, name, argv, d, device, cwd=None, env=None):
        self.name = name
        self.dir = os.path.join(d, name)
        self.counts = os.path.join(self.dir, "counts")
        os.makedirs(self.counts)
        self.env = dict(os.environ, CHIP_SMOKE_ROOT=ROOT,
                        CHIP_SMOKE_COUNTS=self.counts,
                        PYTHONPATH=os.path.join(d, "hook") + os.pathsep
                        + ROOT, **(env or {}))
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            argv, cwd=cwd or self.dir, env=self.env, stdout=self.out,
            stderr=self.err, start_new_session=True)
        self.device = device

    def stop(self):
        """Kill whatever of the child's session still runs."""
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def finish(self, want_rc=0):
        """Wait for the child; fail unless it exited ``want_rc`` and every
        process of it that loaded the kernel's wrapper launched it exactly
        as its batches predict.  Returns (stdout, seconds, launches,
        card batches, overflows)."""
        try:
            rc = self.proc.wait(TOOL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = "timed out after {} s".format(TOOL_TIMEOUT_S)
        self.stop()
        seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        stdout, stderr = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        check(rc == want_rc, "{}: rc {}: {}".format(self.name, rc,
                                                    stderr[-3000:]))
        launches, batches, overflows = self.read_counts()
        return stdout, seconds, launches, batches, overflows

    def read_counts(self):
        counts = [json.load(open(os.path.join(self.counts, f)))
                  for f in sorted(os.listdir(self.counts))
                  if f.endswith(".json")]
        for c in counts:
            check(c["launches"] == c["expected"],
                  "{}: {} power/peak launches in a process, want {} ({} card "
                  "batches, {} overflows)".format(
                      self.name, c["launches"], c["expected"], c["batches"],
                      c["overflows"]))
        total = [sum(c[k] for c in counts)
                 for k in ("launches", "batches", "overflows")]
        if self.device == "cuda" and self.name != "chip_rate_search":
            check(total[0] > 0 and total[1] > 0,
                  "{}: no power/peak launch on the card".format(self.name))
        return total


def tool_argv(script, *args):
    return [sys.executable, os.path.join(ROOT, "scripts", script)] \
        + list(args)


def start_deploy(d, cap, device):
    """deploy/detect_torch.sh in its own session (its `kill 0` must not
    reach this process) on the first DEPLOY_BLOCKS blocks of the
    full-size capture as a raw stream, then zero-signal bytes, as a live
    radio keeps streaming: the reader fills 256 KiB chunks and a batch is
    written once the next one is queued, so the tail covers a chunk and
    two batches.  The feeder then idles."""
    from thrifty_tpu_torch.dsp import iq

    work = os.path.join(d, "deploy_run")
    os.makedirs(work)
    raw = os.path.join(work, "capture.raw")
    tail = np.full((1 << 18) + 2 * DEPLOY_BATCH * 2 * NEW_LEN, 128,
                   np.uint8)
    np.concatenate([iq.iq_to_raw(cap.blocks[:DEPLOY_BLOCKS, 4920:]
                                 .reshape(-1)), tail]).tofile(raw)
    tpl = os.path.join(work, "template.npy")
    np.save(tpl, cap.template)
    cfg = os.path.join(work, "detector.cfg")
    with open(cfg, "w") as f:
        f.write("block_size: 16384\nblock_history: 4920\ncarrier_window: 7 "
                "- 110\nbatch_size: {}\ntemplate: {}\n".format(
                    DEPLOY_BATCH, tpl))
    feed = os.path.join(work, "feed.sh")
    with open(feed, "w") as f:
        f.write("cat '{}'\nexec sleep 300\n".format(raw))
    env = dict(CONFIG=cfg, OUTPUT=os.path.join(work, "rx.toad"),
               FIFO=os.path.join(work, "capture.fifo"),
               CAPTURE_CMD="/bin/sh " + feed, DEVICE=device,
               PYTHON=sys.executable)
    return Tool("detect_torch.sh",
                ["/bin/bash", os.path.join(ROOT, "deploy", "detect_torch.sh")],
                d, device, cwd=work, env=env)


def finish_deploy(tool, cap, card_name):
    """Wait until every planted burst of the streamed blocks is in the
    .toad, SIGTERM the supervisor: it must stop within 20 s, remove its
    FIFO, and its .toad hold the planted bursts within 0.05 samples."""
    import signal
    import types

    planted = types.SimpleNamespace(bursts=[
        b for b in cap.bursts if b.block_idx < DEPLOY_BLOCKS])
    want = {b.block_idx for b in planted.bursts}

    def toad_rows():
        if not os.path.exists(tool.env["OUTPUT"]):
            return np.zeros((0, 12))
        with open(tool.env["OUTPUT"]) as f:
            text = f.read()
        text = text[:text.rfind("\n") + 1]  # whole lines only
        return np.loadtxt(text.splitlines(), ndmin=2) if text.strip() \
            else np.zeros((0, 12))

    deadline = time.monotonic() + TOOL_TIMEOUT_S
    while not want <= set(toad_rows()[:, 2].astype(int).tolist()):
        if tool.proc.poll() is not None or time.monotonic() > deadline:
            tool.stop()
            tool.err.seek(0)
            check(False, "detect_torch.sh: stopped or stalled before the "
                  "planted bursts reached the .toad: " + tool.err.read())
        time.sleep(0.2)
    written = time.perf_counter() - tool.t0
    os.kill(tool.proc.pid, signal.SIGTERM)
    t_term = time.perf_counter()
    try:
        tool.proc.wait(20)
    except subprocess.TimeoutExpired:
        tool.stop()
        check(False, "detect_torch.sh did not stop within 20 s of SIGTERM")
    stop_s = time.perf_counter() - t_term
    # detect drains its queued batch and writes its counts after the
    # shell has gone (finish() then stops what is left of the session).
    deadline = time.monotonic() + 30
    while not any(f.endswith(".json") for f in os.listdir(tool.counts)) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    # 143 = 128 + SIGTERM: the interrupted `wait -n` under `set -e`.
    _, _, launches, batches, _ = tool.finish(want_rc=143)
    check(not os.path.exists(tool.env["FIFO"]), "detect_torch.sh: FIFO left")
    rows = toad_rows()
    check_bursts(rows, planted, "detect_torch.sh")
    print("deploy/detect_torch.sh (DEVICE={}, CAPTURE_CMD = cat of a {}-block "
          "raw stream, batch {}): the {} planted bursts in the .toad after "
          "{:.1f} s, within 0.05 samples; stopped {:.2f} s after SIGTERM, "
          "FIFO removed; {} power/peak launches in {} card batches; "
          "{}".format(tool.env["DEVICE"], DEPLOY_BLOCKS, DEPLOY_BATCH,
                      len(want), written, stop_s, launches, batches,
                      card_name), flush=True)
    return launches, batches


def tools_phase(card_name, cap, device="cuda"):
    """The port's tool scripts on the card, each in a child process, rc 0:
    the validation sweep (20 trials, every suite clean), the golden check
    at --tol-scale 1 plain and gated, the chip-rate search and the deploy
    supervisor side by side; then, alone, the paired A/B timer and the
    rank scaling sweep.  Each child's power/peak launches are held to its
    batches.  ``device="cpu"`` rehearses it on the CPU."""
    phase("tools")
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="tools_")
    started = []

    def launch(*args, **kwargs):
        started.append(Tool(*args, **kwargs))
        return started[-1]

    try:
        os.makedirs(os.path.join(d, "hook"))
        with open(os.path.join(d, "hook", "sitecustomize.py"), "w") as f:
            f.write(COUNTING_HOOK)
        dev = ["--device", device]
        tpl_gate = ["--detect-arg=--gate-capacity", "--detect-arg=8"]
        # These four and the supervisor run side by side; their seconds
        # run from the common start to each one's end.
        side_by_side = [
            launch("validation_sweep", tool_argv(
                "validation_sweep_torch.py", "--trials", str(SWEEP_TRIALS),
                "--seed", "0", *dev), d, device),
            launch("card_golden_check", tool_argv(
                "card_golden_check_torch.py", "--tol-scale", "1", *dev),
                d, device),
            launch("card_golden_check_gated", tool_argv(
                "card_golden_check_torch.py", "--tol-scale", "1", *dev,
                *tpl_gate), d, device),
            launch("chip_rate_search", tool_argv(
                "chip_rate_search_torch.py", os.path.join(INPUT,
                                                          "rx0.card")),
                d, device),
        ]
        deploy = start_deploy(d, cap, device)
        started.append(deploy)
        paths = {}

        def record(name, launches, batches):
            if device == "cuda":
                paths[name] = launches / batches

        out, seconds, launches, batches, overflows = \
            side_by_side[0].finish()
        suites = {s["suite"]: s for s in map(json.loads, (
            ln for ln in out.splitlines() if ln.startswith("{")))}
        check(sorted(suites) == ["detector", "matchmaker", "pos", "tdoa"]
              and all(s["ok"] for s in suites.values())
              and all(s.get("divergences", 0) == 0
                      for s in suites.values())
              and suites["pos"]["gn_worse_100m_wellposed"] == 0,
              "validation sweep: {}".format(out))
        det, pos = suites["detector"], suites["pos"]
        print("validation_sweep_torch.py --device {} --trials {} --seed 0 "
              "({:.1f} s): detector {} trials, {} blocks compared, 0 "
              "divergences, worst SoA diff {:.3e} samples ({} off-bin "
              "skipped, {} oracle failures); pos {} comparisons, "
              "gn_worse_100m_wellposed {}, gn_better_100m {}, ambiguous {}; "
              "matchmaker {} trials, tdoa {} comparisons, 0 divergences; "
              "{} power/peak launches in {} card batches ({} overflows); "
              "{}".format(device, SWEEP_TRIALS, seconds, det["trials"],
                          det["blocks"], det["worst_soa_diff"],
                          det["skipped_offbin"], det["oracle_failed"],
                          pos["comparisons"], pos["gn_worse_100m_wellposed"],
                          pos["gn_better_100m"],
                          pos["equal_residual_ambiguous"],
                          suites["matchmaker"]["trials"],
                          suites["tdoa"]["comparisons"], launches, batches,
                          overflows, card_name), flush=True)
        record("validation_sweep", launches, batches)

        for tool in side_by_side[1:3]:
            out, seconds, launches, batches, overflows = tool.finish()
            lines = [json.loads(ln) for ln in out.splitlines()
                     if ln.startswith("{")]
            check(lines[-1]["metric"] == "card_golden_check"
                  and lines[-1]["value"] == 1.0
                  and lines[-1]["backend"] == device,
                  "{}: {}".format(tool.name, out))
            worst = max(ln.get("max_err_in_cpu_tols", 0.0)
                        for ln in lines[:-1])
            print("card_golden_check_torch.py --tol-scale 1{} ({:.1f} s): "
                  "pass; worst float column {:.3f} of its CPU tolerance, "
                  "fixes within {} m of data.pos; {} power/peak launches in "
                  "{} card batches ({} overflows); {}".format(
                      " (gate 8)" if "gated" in tool.name else "", seconds,
                      worst, lines[-2]["max_position_err_m"], launches,
                      batches, overflows, card_name), flush=True)
            record(tool.name, launches, batches)

        out, seconds, _, _, _ = side_by_side[3].finish()
        best = [ln for ln in out.splitlines()
                if ln.startswith("best chip rate:")]
        check(len(best) == 1, "chip_rate_search: " + out[-2000:])
        print("chip_rate_search_torch.py rx0.card ({:.1f} s, host numpy, no "
              "device): {}".format(seconds, best[0]), flush=True)

        record("detect_torch.sh", *finish_deploy(deploy, cap, card_name))

        ab = launch("card_ab_time", tool_argv(
            "card_ab_time_torch.py", "--ab", "fft_impl=matmul", "--rounds",
            "3", *dev), d, device)
        out, seconds, launches, batches, _ = ab.finish()
        data = json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1])
        check(data["metric"] == "config_ab_time"
              and data["verdict"] != "unresolved", "card_ab_time: " + out)
        print("card_ab_time_torch.py --ab fft_impl=matmul --rounds 3 "
              "({:.1f} s): verdict {}, paired ratio b/a {} (median), a "
              "{:.3f} ms / b {:.3f} ms a batch (medians), rounds b/a {}; "
              "{} power/peak launches in {} card batches; {}".format(
                  seconds, data["verdict"], data["value"],
                  1e3 * data["a_sec_per_batch_median"],
                  1e3 * data["b_sec_per_batch_median"],
                  [r["ratio_b_over_a"] for r in data["rounds"]], launches,
                  batches, card_name), flush=True)
        record("card_ab_time", launches, batches)

        for geometry, shapes in (("tiny", "1x1,1x2,2x2"), ("full", "1x1")):
            name = "scaling_sweep_" + geometry
            sweep = launch(name, tool_argv(
                "scaling_sweep_torch.py", "--geometry", geometry,
                "--shapes", shapes, "--json", os.path.join(d, name + ".json"),
                *dev), d, device)
            _, seconds, launches, batches, _ = sweep.finish()
            rows = json.load(open(os.path.join(d, name + ".json")))["results"]
            check([r["mesh"] for r in rows] == shapes.split(",")
                  and all(r["samples_per_s"] > 0 for r in rows),
                  "{}: {}".format(name, rows))
            print("scaling_sweep_torch.py --geometry {} --shapes {} ({:.1f} "
                  "s; ranks share the one card): {}; {} power/peak launches "
                  "in {} card batches; {}".format(
                      geometry, shapes, seconds, json.dumps(rows), launches,
                      batches, card_name), flush=True)
            record(name, launches, batches)
    finally:
        for tool in started:
            tool.stop()
        shutil.rmtree(d, ignore_errors=True)
    print("tools phase: {} paths, {:.1f} s; {}".format(
        len(paths), time.perf_counter() - t_phase, card_name), flush=True)
    return paths


def report_split(label, ranks, card_name):
    """Median ms per rank call of the timed run, split into halo exchange
    (host clock), detect (CUDA events), gather (host clock) and the whole
    call (host clock)."""
    for k, r in enumerate(ranks):
        med = {s: float(np.median(r["timing/" + s]))
               for s in ("halo", "detect", "gather", "call")}
        print("{}, rank {} ([{}, 16384] a call, median of {}): halo exchange "
              "{:.3f} ms, detect {:.3f} ms, gather {:.3f} ms; whole call "
              "{:.3f} ms; {}".format(label, k, int(r["timing/rows"]),
                                     MR_TIMING_REPS, med["halo"],
                                     med["detect"], med["gather"],
                                     med["call"], card_name))


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
        fits = fits_phase(card_name, cap, template, probe)
        golden_phase(tmp)
        # The main path: detect on a .card, launches counted from 0.
        batches = math.ceil(len(cap.indices) / BATCH)
        counts = full_size_phase(card_name, tmp, cap)
        kernel["launches"] = counts["power_peak"]
        fits["dirichlet_fit"]["launches"] = counts["dirichlet_fit"]
        paths = {"detect": kernel["launches"] / batches}
        fit_paths = {"dirichlet_fit": {"detect (CLI)": 1.0}}
        tpl_path = os.path.join(tmp, "template.npy")
        # This slice's own paths, each counted from 0.
        for name, (launches, per_batch) in fit_cli_phase(
                card_name, tmp, cap, tpl_path).items():
            fits[name]["launches"] = launches
            fit_paths.setdefault(name, {})[
                "detect --corr-interp (CLI)"] = per_batch
        transforms_phase(card_name)
        paths.update(transform_detect_phase(card_name, tmp, cap, tpl_path))
        raw_path = os.path.join(tmp, "full.raw")
        iq.iq_to_raw(cap.blocks[:, 4920:].reshape(-1)).tofile(raw_path)
        paths.update(fastdet_phase(tmp))
        paths.update(capture_phase(tmp))
        paths.update(device_unfold_phase(card_name, tmp, cap, raw_path,
                                         tpl_path))
        paths.update(gate_phase(card_name, tmp, cap, template, raw_path,
                                tpl_path))
        paths.update(options_phase(card_name, tmp, cap, tpl_path, raw_path))
        golden_paths, golden_fits = interp_golden_phase(tmp)
        paths.update(golden_paths)
        for name, per_batch in golden_fits.items():
            fit_paths.setdefault(name, {}).update(per_batch)
        paths.update(code_division_phase())
        chain_phase(tmp)
        solver_phase(card_name)
        serve_phase(card_name)
        serve_cli_phase(card_name, tmp)
        paths.update(template_extract_phase(card_name, tmp))
        paths.update(doctor_phase(card_name))
        paths.update(bench_phase(card_name))
        paths.update(multirank_phase(card_name))
        paths.update(tools_phase(card_name, cap))
        timing_phase(card_name, tmp, cap, template, raw_path)
        program_timings(card_name, template)
        kernel["paths"] = sorted(paths)
        kernel["launches_per_batch"] = paths
        for name, entry in fits.items():
            entry["launches_per_batch"].update(fit_paths.get(name, {}))
            entry["paths"] = sorted(entry["launches_per_batch"])
            check(entry["launches"] > 0, "{}: no launch on its main path"
                  .format(name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                    ("jax", "jaxlib", "thrifty_tpu"))
    check(not loaded, "imported {}".format(loaded))
    print(json.dumps({"kernels": [kernel] + [fits[k] for k in FITS]}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
