#!/usr/bin/env python
"""Golden cross-validation of the PyTorch + CUDA port ON THE CARD (the
port's counterpart of scripts/tpu_golden_check.py).

The committed golden tests run the port on the CPU; on the card the FFT
is cuFFT and both reductions are the power/peak kernel.  This script
drives the port's CLI (``thrifty_tpu_torch.cli.main``) in process with
``--device`` on every ``detect`` and on ``pos``:

- ``detect --sync-mode integer`` on the committed inputs, compared to
  the compiled C reference's .toad (fastdet, tests/golden/fastdet/);
- then the Python-reference chain detect -> identify -> match -> tdoa
  -> pos, compared to tests/golden/rx*.toad and data.pos.  ``pos``
  runs the batched solver on ``--device`` (``pos --batched``); fixes
  must land within 5 cm x --tol-scale of the reference's.

Prints one JSON line per receiver and stage plus a summary line:
    {"metric": "card_golden_check", "value": 1.0, "backend": "cuda", ...}
Exit 0 iff every detection decision, block index, peak sample and
template choice is identical and float columns are within tolerance.

Usage:  python scripts/card_golden_check_torch.py [--tol-scale 10]
            [--device cuda|cpu] [--fft-impl matmul]
            [--detect-arg=--gate-capacity --detect-arg=8]

The float tolerances default to 10x the CPU goldens'; decisions must
match exactly regardless.  ``--device cuda`` (the default) without a
card raises.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "golden")
INPUT = os.path.join(GOLDEN, "input")
FASTDET = os.path.join(GOLDEN, "fastdet")

# Same column map as tests/test_golden_fastdet.py: exact integers
# (col 0 rxid, col 2 block index, col 4 corr peak sample, col 8
# carrier bin -- toad.format_line order) and toleranced floats
# (SoA, offsets, energies, noises).
INT_COLS = (0, 2, 4, 8)
FLOAT_TOLS = {3: dict(atol=1e-4), 5: dict(atol=1e-4),
              6: dict(rtol=1e-4), 7: dict(rtol=1e-4),
              9: dict(atol=1e-4), 10: dict(rtol=1e-4),
              11: dict(rtol=1e-4)}
# Python-semantics chain (tests/test_golden_reference.py tolerances).
PY_FLOAT_TOLS = {3: dict(atol=1e-3), 5: dict(atol=1e-3),
                 6: dict(rtol=1e-3, atol=1e-3),
                 7: dict(rtol=1e-2, atol=1e-3),
                 9: dict(atol=2e-3), 10: dict(rtol=1e-3, atol=1e-3),
                 11: dict(rtol=1e-2, atol=1e-3)}


def _compare_toad(got, ref, float_tols, tol_scale, report):
    ok = got.shape == ref.shape
    if not ok:
        return False
    for col in INT_COLS:
        n_bad = int((got[:, col] != ref[:, col]).sum())
        ok = ok and n_bad == 0
        if n_bad:
            report["int_col%d_mismatches" % col] = n_bad
    errs = {}
    for col, tol in float_tols.items():
        scale = (tol.get("atol", 0)
                 + tol.get("rtol", 0) * np.abs(ref[:, col]))
        err = float(np.max(np.abs(got[:, col] - ref[:, col])
                           / np.maximum(scale, 1e-30)))
        errs["col%d" % col] = round(err, 3)
        ok = ok and err <= tol_scale
    report["max_err_in_cpu_tols"] = max(errs.values())
    report["per_col"] = errs
    return ok


def check_python_chain(cli_main, d, tol_scale, device, detect_extra=()):
    """Full detect -> identify -> match -> tdoa -> pos: detect and the
    batched solver on ``device``, identify/match/tdoa on the host over
    the device's detections, compared to the Python-reference goldens;
    final positions must land within 5 cm x ``tol_scale`` of the
    reference's fixes (tests/test_golden_reference.py uses 5 cm)."""
    common = ["--carrier-window", "7-110",
              "--template", os.path.join(INPUT, "template.npy"),
              "--device", device]
    common += list(detect_extra)
    results = []
    toads = []
    for rxid in (0, 1, 2):
        out = os.path.join(d, "py_rx%d.toad" % rxid)
        toads.append(out)
        rc = cli_main(["detect", os.path.join(INPUT, "rx%d.card" % rxid),
                       "-o", out, "--quiet", "--rxid", str(rxid)]
                      + common)
        report = {"stage": "detect", "rx": rxid}
        if rc not in (0, None):
            report.update(ok=False, error="rc=%s" % rc)
            results.append(report)
            continue
        got = np.atleast_2d(np.loadtxt(out))
        ref = np.atleast_2d(np.loadtxt(
            os.path.join(GOLDEN, "rx%d.toad" % rxid)))
        report["detections"] = int(got.shape[0])
        report["ok"] = bool(_compare_toad(got, ref, PY_FLOAT_TOLS,
                                          tol_scale, report))
        results.append(report)

    toads_f = os.path.join(d, "py_rx.toads")
    match_f = os.path.join(d, "py_rx.match")
    tdoa_f = os.path.join(d, "py_data.tdoa")
    pos_f = os.path.join(d, "py_data.pos")
    ok = (cli_main(["identify"] + toads + [
              "-o", toads_f, "-m", os.path.join(INPUT, "freq-map.cfg")])
          in (0, None)
          and cli_main(["match", toads_f, "-o", match_f, "-w", "0.02"])
          in (0, None)
          and cli_main(["tdoa", toads_f, match_f, "-o", tdoa_f,
                        "-r", os.path.join(INPUT, "pos-rx.cfg"),
                        "-b", os.path.join(INPUT, "pos-beacon.cfg")])
          in (0, None)
          and cli_main(["pos", tdoa_f, "-o", pos_f,
                        "-r", os.path.join(INPUT, "pos-rx.cfg"),
                        "--batched", "--device", device])
          in (0, None))
    report = {"stage": "positions"}
    if ok:
        ref = np.atleast_2d(np.loadtxt(os.path.join(GOLDEN, "data.pos")))
        got = np.atleast_2d(np.loadtxt(pos_f))
        ok = got.shape == ref.shape and \
            bool((got[:, (0, 2)] == ref[:, (0, 2)]).all())
        if ok:
            pos_err = float(np.max(np.abs(got[:, 5:] - ref[:, 5:])))
            report["fixes"] = int(got.shape[0])
            report["max_position_err_m"] = round(pos_err, 6)
            ok = pos_err <= 0.05 * tol_scale
        else:
            report["error"] = "fix set differs"
    else:
        report["error"] = "pipeline stage failed"
    report["ok"] = bool(ok)
    results.append(report)
    return results


def main(argv=None):
    from thrifty_tpu_torch.device import DEVICES, resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--tol-scale", type=float, default=10.0,
                        help="multiply the CPU-golden float tolerances "
                             "by this for the card's FFT [10]")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where detect and the batched solver run; "
                             "'cuda' fails without a card [default: cuda]")
    parser.add_argument("--fft-impl", type=str, default=None,
                        choices=["auto", "matmul", "matmul3", "xla"],
                        help="forward to every detect invocation "
                             "(certify a transform implementation against "
                             "the goldens on this device)")
    parser.add_argument("--fft-precision", type=str, default=None,
                        choices=["highest", "high", "default"],
                        help="forward to every detect invocation "
                             "(certify a GEMM precision against the "
                             "goldens)")
    parser.add_argument("--detect-arg", action="append", default=[],
                        metavar="ARG",
                        help="extra flag forwarded verbatim to every "
                             "detect invocation (repeatable), e.g. "
                             "--detect-arg=--gate-capacity "
                             "--detect-arg=8 to certify the "
                             "carrier-gated path against the goldens")
    args = parser.parse_args(argv)
    backend = resolve_device(args.device).type
    detect_extra = list(args.detect_arg)
    if args.fft_impl:
        detect_extra += ["--fft-impl", args.fft_impl]
    if args.fft_precision:
        detect_extra += ["--fft-precision", args.fft_precision]

    from thrifty_tpu_torch.cli import main as cli_main

    all_ok = True
    with tempfile.TemporaryDirectory() as d:
        # fastdet numerics (sync-mode integer) vs the compiled C goldens
        for rxid in (0, 1, 2):
            out = os.path.join(d, "rx%d.toad" % rxid)
            rc = cli_main([
                "detect", os.path.join(INPUT, "rx%d.card" % rxid),
                "-o", out, "--rxid", str(rxid), "--quiet",
                "--sync-mode", "integer", "--carrier-window", "7-110",
                "--template", os.path.join(INPUT, "template.npy"),
                "--device", args.device] + detect_extra)
            report = {"stage": "detect-integer", "rx": rxid}
            if rc not in (0, None):
                report.update(ok=False, error="detect rc=%s" % rc)
            else:
                ref = np.atleast_2d(np.loadtxt(
                    os.path.join(FASTDET, "rx%d_fastdet.toad" % rxid)))
                got = np.atleast_2d(np.loadtxt(out))
                report["detections"] = int(got.shape[0])
                report["ok"] = bool(_compare_toad(
                    got, ref, FLOAT_TOLS, args.tol_scale, report))
            print(json.dumps(report))
            all_ok = all_ok and report["ok"]

        # Python-reference semantics, full chain through positions
        for report in check_python_chain(cli_main, d, args.tol_scale,
                                         args.device, detect_extra):
            print(json.dumps(report))
            all_ok = all_ok and report["ok"]

    print(json.dumps({
        "metric": "card_golden_check",
        "value": 1.0 if all_ok else 0.0,
        "unit": "pass",
        "vs_baseline": 1.0 if all_ok else 0.0,
        "backend": backend,
        "tol_scale": args.tol_scale,
        "fft_impl": args.fft_impl or "auto",
        "fft_precision": args.fft_precision or "highest",
        "detect_args": args.detect_arg,
    }))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
