"""``python -m thrifty_tpu_torch.cli doctor``: deployment-environment
selfcheck of the PyTorch + CUDA port.

The counterpart of ``thrifty_tpu.pipeline.doctor`` for an NVIDIA node:
one command an operator runs on a fresh node to confirm every layer
under the pipeline works -- Python stack and CUDA toolkit, the card,
the native host library, the kernel build, the detector on ``--device``
and the detect CLI -- and, with ``--selfcheck``, that on this card the
hand-written power/peak kernel agrees with its plain version and the
detector agrees with its CPU run.

Each check prints one ``ok``/``FAIL`` line; exit code 0 iff all pass.
``--device cuda`` (the default) never falls back to the CPU: without a
card the device checks fail.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from thrifty_tpu_torch.device import DEVICES, resolve_device

# The .toad comparison of the detector's card run against its CPU run:
# decisions and integer fields exact, floats within these (the golden
# tolerances of the reference .toad files, by detector output field).
FIELD_TOLS = {"corr_offset": dict(atol=1e-3),
              "corr_energy": dict(rtol=1e-3, atol=1e-3),
              "corr_noise": dict(rtol=1e-2, atol=1e-3),
              "carrier_offset": dict(atol=2e-3),
              "carrier_energy": dict(rtol=1e-3, atol=1e-3),
              "carrier_noise": dict(rtol=1e-2, atol=1e-3)}
SUM_RTOL = 1e-5  # kernel vs plain sums: float32 reassociation


def _check(results, name, fn):
    try:
        detail = fn()
        results.append((name, True, detail or ""))
    except Exception as e:  # noqa: BLE001 -- each check is a probe
        results.append((name, False, "{}: {}".format(type(e).__name__, e)))


def _versions():
    import numpy
    import torch

    from thrifty_tpu_torch import _build

    try:
        nvcc = _build.find_nvcc()
    except RuntimeError:
        nvcc_version = "not found"
    else:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
        nvcc_version = [ln for ln in out.splitlines() if ln.strip()][-1]
    return "python {}.{}.{}, numpy {}, torch {}, torch cuda {}, nvcc " \
        "{}".format(*sys.version_info[:3], numpy.__version__,
                    torch.__version__, torch.version.cuda, nvcc_version)


def _devices(device="cuda"):
    import torch

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu ({} threads)".format(torch.get_num_threads())
    props = torch.cuda.get_device_properties(dev)
    return "cuda devices={} ({}, compute capability {}.{}, {} SMs, " \
        "{:.0f} GiB)".format(torch.cuda.device_count(), props.name,
                             props.major, props.minor,
                             props.multi_processor_count,
                             props.total_memory / 2 ** 30)


def _native():
    import numpy as np

    from thrifty_tpu_torch import native

    # base64 round-trip through the SWAR/AVX2 codec
    data = np.arange(96, dtype=np.uint8)
    enc = native.b64encode(data)
    dec = native.b64decode_batch([enc])
    assert dec.shape == (1, 96) and (dec[0] == data).all(), "b64 mismatch"
    # ring write/read
    ring = native.RingBuffer(256)
    ring.write(data)
    ring.close()
    assert (ring.read(96) == data).all(), "ring mismatch"
    # unfold + parallel row gather
    out = native.unfold(data, 8, 2, 4)
    assert out.shape == (4, 8), "unfold shape"
    rows = np.empty((2, 16), np.uint8)
    native.copy_rows(data, 0, rows, 16)
    assert (rows[1] == data[16:32]).all(), "copy_rows mismatch"
    return "lib loaded, b64/ring/unfold/copy_rows ok, {} threads".format(
        native.num_threads())


def _kernel_build(device="cuda"):
    """The build directory is writable; on the card, the kernels build
    for sm_90a and the card is one they run on."""
    import torch

    from thrifty_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    probe = os.path.join(_build.BUILD_DIR,
                         ".doctor-probe.{}".format(os.getpid()))
    with open(probe, "w") as f:
        f.write("ok")
    os.remove(probe)
    detail = "{} writable".format(_build.BUILD_DIR)
    if resolve_device(device).type == "cuda":
        capability = torch.cuda.get_device_capability()
        if capability != (9, 0):
            raise RuntimeError("the kernels are built for sm_90a (Hopper); "
                               "this card is sm_{}{}".format(*capability))
        for name in _build.sources():
            path, seconds, _ = _build.build(name)
            _build.load(name)
            detail += "; {}.cu built for sm_90a and loaded ({}, {:.1f} s)" \
                .format(name, os.path.basename(path), seconds)
    return detail


def _synthetic_batch(batch):
    import numpy as np

    from thrifty_tpu_torch import sim

    tpl = sim.make_template()
    cap = sim.synth_capture(num_blocks=batch, bursts_every=2,
                            template=tpl, seed=1)
    return tpl, np.asarray(cap.blocks, dtype=np.complex64)


def _detector(batch, device="cuda"):
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    tpl, blocks = _synthetic_batch(batch)
    det = BatchDetector(tpl, DetectorConfig(carrier_window=(7, 110)),
                        device=resolve_device(device))
    detected = det(blocks)["detected"].cpu().numpy()
    assert detected.any(), "no synthetic burst detected"
    return "ran on {}, {}/{} blocks detected".format(
        det.device, int(detected.sum()), batch)


def _pipeline(device="cuda"):
    """File-format round trip through detect -> .toad on a temp dir."""
    import numpy as np

    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.io import card, toad
    from thrifty_tpu_torch.pipeline import detect as detect_cli

    tpl = sim.make_template()
    cap = sim.synth_capture(num_blocks=6, bursts_every=2, template=tpl,
                            seed=2)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "tpl.npy"), tpl)
        card.write_card(os.path.join(d, "rx.card"), cap.timestamps,
                        cap.indices, iq.iq_to_raw(cap.blocks))
        # Hermetic: an explicit empty config, or detect would pick up
        # any ambient ./detector.cfg and the probe would depend on the
        # operator's cwd.
        cfg = os.path.join(d, "detector.cfg")
        with open(cfg, "w"):
            pass
        rc = detect_cli._main(
            [os.path.join(d, "rx.card"), "-o", os.path.join(d, "rx.toad"),
             "-c", cfg,
             "--template", os.path.join(d, "tpl.npy"), "--quiet",
             "--carrier-window", "7-110", "--device", device])
        assert rc in (0, None), "detect CLI rc={}".format(rc)
        recs = toad.load_toad(os.path.join(d, "rx.toad"))
        assert len(recs) > 0, "empty .toad"
    return "card -> detect -> toad ok on {} ({} detections)".format(
        device, len(recs))


def _selfcheck(batch, device="cuda"):
    """On the card: the power/peak kernel in both layouts against its
    plain version on a batch's spectra, and the detector against its CPU
    run on the same batch."""
    import numpy as np
    import torch

    from thrifty_tpu_torch.dsp import power_peak as pp
    from thrifty_tpu_torch.dsp.carrier import window_mask
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the selfcheck holds the card's kernel against "
                           "its plain version: run it with --device cuda")
    tpl, blocks = _synthetic_batch(batch)
    n = blocks.shape[1]
    spec = torch.fft.fft(torch.from_numpy(blocks).to(dev))
    mask = pp.Mask(window_mask((7, 110), n), dev)
    stats = pp.Mask(np.arange(n) < n - len(tpl) + 1, dev)
    ref = [r.cpu().numpy() for r in pp.fused_power_peak_reference(
        spec.real, spec.imag, mask.bool, stats.bool)]
    worst = 0.0
    for layout in pp.LAYOUTS:
        got = [g.cpu().numpy() for g in pp.fused_power_peak(
            spec, mask, stats, layout=layout)]
        assert np.array_equal(got[0], ref[0]), layout + ": idx differs"
        assert np.array_equal(got[1].view(np.uint32),
                              ref[1].view(np.uint32)), \
            layout + ": peak not bit-equal"
        for g, r in zip(got[2:], ref[2:]):
            rel = float(np.max(np.abs(g - r) / np.abs(r)))
            assert rel <= SUM_RTOL, "{}: sums off by rel {:.3g}".format(
                layout, rel)
            worst = max(worst, rel)

    cfg = DetectorConfig(carrier_window=(7, 110))
    card_out, cpu_out = [
        {k: v.cpu().numpy() for k, v in BatchDetector(
            tpl, cfg, device=d)(blocks).items()}
        for d in (dev, torch.device("cpu"))]
    for k in ("detected", "carrier_detect"):
        assert np.array_equal(card_out[k], cpu_out[k]), k + " differs"
    pos = cpu_out["carrier_detect"]
    det = cpu_out["detected"]
    assert np.array_equal(card_out["carrier_bin"][pos],
                          cpu_out["carrier_bin"][pos]), "carrier_bin differs"
    assert np.array_equal(card_out["corr_sample"][det],
                          cpu_out["corr_sample"][det]), "corr_sample differs"
    for k, tol in FIELD_TOLS.items():
        rows = det if k.startswith("corr") else pos
        assert np.allclose(card_out[k][rows], cpu_out[k][rows], **tol), \
            "{} beyond {}".format(k, tol)
    return "power_peak = plain at [{}, {}] in both layouts (idx/peak " \
        "bit-equal, sums within {:.2g} rel); detector on {} = cpu on {} " \
        "blocks ({} detected)".format(batch, n, worst, dev, batch,
                                      int(det.sum()))


def _main(argv=None):
    parser = argparse.ArgumentParser(
        prog="thrifty-tpu-torch doctor",
        description="Check this node can run the full pipeline.")
    parser.add_argument("--batch", type=int, default=8,
                        help="blocks for the detector probe [8]")
    parser.add_argument("--selfcheck", action="store_true",
                        help="also hold the card's power/peak kernel "
                             "against its plain version and the "
                             "detector against its CPU run (needs "
                             "--device cuda)")
    parser.add_argument("--no-device", action="store_true",
                        help="host-only checks (skip detector/pipeline)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=list(DEVICES),
                        help="the device the checks run on; 'cuda' fails "
                             "when no card is available [default: cuda]")
    args = parser.parse_args(argv)

    results = []
    _check(results, "versions", _versions)
    _check(results, "devices", lambda: _devices(args.device))
    _check(results, "native", _native)
    _check(results, "kernel-build", lambda: _kernel_build(args.device))
    if not args.no_device:
        _check(results, "detector", lambda: _detector(args.batch,
                                                      args.device))
        _check(results, "pipeline", lambda: _pipeline(args.device))
    if args.selfcheck:
        _check(results, "selfcheck", lambda: _selfcheck(args.batch,
                                                        args.device))

    if args.json:
        print(json.dumps([{"check": n, "ok": ok, "detail": d}
                          for n, ok, d in results]))
    else:
        for name, ok, detail in results:
            print("{:14s} {}  {}".format(
                name, "ok  " if ok else "FAIL", detail))
    failed = [n for n, ok, _ in results if not ok]
    if failed and not args.json:
        print("doctor: FAILED: {}".format(", ".join(failed)),
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(_main())
