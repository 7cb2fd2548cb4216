#!/usr/bin/env python
"""Randomized differential validation sweep of the PyTorch + CUDA port
(the port's counterpart of scripts/validation_sweep.py).

Runs the JAX sweep's offline campaigns on ``thrifty_tpu_torch``, with
the same suites, trial counts, seeds and ``np.random.default_rng`` draw
order, so one seed visits the JAX sweep's geometries:

  detector    the port's float32 batched detector on ``--device`` vs
              the port's float64 oracle at random (template, block,
              history) geometries, signed/wrapped carrier windows, both
              oracle-covered sync modes, filter on/off, the gate at
              capacity nb-1 and the transform impl drawn from ('xla',
              'matmul'); 'xla' is cuFFT through torch.fft.  On the card
              every batch launches the power/peak kernel.
  matchmaker  batched greedy matcher vs the sequential scan (the port's
              host copy of pipeline/matchmaker.py).
  tdoa        sequential vs batched TDOA for all four clock models (the
              port's host copy of pipeline/tdoa.py).
  pos         scipy trust-region vs the port's batched multi-start
              solver on ``--device``; reports quality gaps, not just
              disagreements (mirror-ambiguous geometries disagree
              legitimately).
  fastdet     (opt-in) integer-sync detector on ``--device`` vs the
              compiled fastdet binaries near the detection knee; needs
              the reference tree at $THRIFTY_REFERENCE (default
              /root/reference) and scripts/build_fastdet_shim.sh, else
              prints a "skipped" line.

Each suite prints one JSON line; exit code 1 if any suite reports
divergences (pos: quality regressions vs scipy on well-posed in-array
cases).  ``--device cuda`` (the default) without a card raises.

Usage:
  python scripts/validation_sweep_torch.py --trials 50
  python scripts/validation_sweep_torch.py --device cpu --suite tdoa \\
      --trials 200
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def sweep_detector(trials, rng, device):
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import dirichlet
    from thrifty_tpu_torch.dsp import template as template_mod, xcorr
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.oracle.numpy_ref import (FastdetOracleDetector,
                                                    OracleDetector)

    stats = dict(trials=0, blocks=0, skipped_offbin=0, oracle_failed=0,
                 divergences=0)
    worst = 0.0
    examples = []
    while stats["trials"] < trials:
        bits = int(rng.integers(5, 8))
        tpl = template_mod.generate(bits, int(rng.integers(0, 3)),
                                    float(rng.uniform(1.6, 2.6)))
        tlen = len(tpl)
        block = int(2 ** rng.integers(9, 13))
        if tlen + 1 >= block // 2:
            continue
        stats["trials"] += 1
        t = stats["trials"]
        hist = int(rng.integers(tlen + 1, block // 2))
        new = block - hist
        nb = int(rng.integers(4, 8))
        wstart, wstop = xcorr.corr_window(block, hist, tlen)
        half = block // 20
        kind = ("pos", "neg", "wrap")[t % 3]
        if kind == "pos":
            window, cbin = (3, half), int(rng.integers(5, half - 1))
        elif kind == "neg":
            window, cbin = (-half, -3), -int(rng.integers(5, half - 1))
        else:
            window = (-half, half)
            cbin = int(rng.integers(3, half - 1)) * \
                (1 if rng.integers(2) else -1)
        sync = ("fractional", "integer")[int(rng.integers(2))]
        # 'matmul' runs the GEMM transforms, including the windowed
        # carrier DFT (fractional trials without a peak filter, an odd
        # window width: the kernel's scalar path) and the head-trimmed
        # inverse.
        impl = ("xla", "matmul")[int(rng.integers(2))]
        flen = int(rng.choice([0, 0, 5, 7]))
        # Capacity nb-1 keeps the gated branch active (planted carriers
        # = nb-2 <= cap < nb blocks); a noise false alarm triggers the
        # exact full-batch re-run, so either way the oracle comparison
        # stands.  Planted blocks are carrier-positive, hence always
        # gathered and fully comparable.
        gate = int(rng.choice([0, 0, nb - 1]))
        bursts, planted = [], []
        for b in range(1, nb - 1):
            lag = int(rng.integers(wstart, wstop))
            bursts.append({"position": b * new + lag - hist,
                           "carrier_bin": cbin, "amplitude": 0.7,
                           "phase": float(rng.uniform(0, 6.28))})
            planted.append((b, lag))
        stream = sim.synth_stream(nb * new, bursts, tpl, block,
                                  noise_std=0.02, seed=t)
        blocks = sim.stream_to_blocks(stream, block, hist)
        det = BatchDetector(tpl, DetectorConfig(
            block_len=block, history_len=hist, carrier_window=window,
            sync_mode=sync, peak_filter_len=flen, fft_impl=impl,
            gate_capacity=gate), device=device)
        # The detector takes complex64 (as JAX's casts); the oracle reads
        # the stream's own precision.
        out = _host(det(blocks.astype(np.complex64)))
        weights = dirichlet.dirichlet_weights(flen, block, tlen) \
            if flen else None
        ocls = OracleDetector if sync == "fractional" \
            else FastdetOracleDetector
        oracle = ocls(tpl, block_len=block, history_len=hist,
                      carrier_window=window, peak_filter=weights)
        geom = ("t%d bits=%d blk=%d h=%d win=%s sync=%s flen=%d imp=%s"
                " gate=%d") % (t, bits, block, hist, window, sync, flen,
                               impl, gate)
        for b, lag in planted:
            stats["blocks"] += 1
            try:
                ref = oracle.detect_block(blocks[b])
            except RuntimeError:
                # The reference's own unbounded curve_fit can fail to
                # converge at degenerate geometries; no oracle to
                # compare against, but the detector must still have
                # found the planted lag.
                stats["oracle_failed"] += 1
                if bool(out["detected"][b]) \
                        and int(out["corr_sample"][b]) != lag:
                    stats["divergences"] += 1
                    if len(examples) < 5:
                        examples.append(("planted_lag", geom, b))
                continue
            bad = None
            if bool(out["carrier_detect"][b]) != ref.carrier_detect:
                bad = "carrier_verdict"
            elif not ref.carrier_detect:
                continue
            elif int(out["carrier_bin"][b]) != ref.carrier_bin:
                bad = "carrier_bin"
            elif bool(out["detected"][b]) \
                    and int(out["corr_sample"][b]) != lag:
                bad = "planted_lag"
            elif abs(ref.carrier_offset) > 1.0:
                stats["skipped_offbin"] += 1
                continue
            elif bool(out["detected"][b]) != ref.detected:
                bad = "corr_verdict"
            elif ref.detected:
                if int(out["corr_sample"][b]) != ref.corr_sample:
                    bad = "corr_sample"
                else:
                    d = abs(float(out["corr_sample"][b]
                                  + out["corr_offset"][b])
                            - (ref.corr_sample + ref.corr_offset))
                    worst = max(worst, d)
                    if d > 1e-2:
                        bad = "soa"
            if bad:
                stats["divergences"] += 1
                if len(examples) < 5:
                    examples.append((bad, geom, b))
    stats["worst_soa_diff"] = worst
    stats["examples"] = examples
    return stats


def sweep_matchmaker(trials, rng, device):
    """Host code: ``device`` is unused."""
    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.pipeline.matchmaker import (
        match_detections, match_detections_batched)

    stats = dict(trials=0, divergences=0, examples=[])
    for t in range(trials):
        stats["trials"] += 1
        n = int(rng.integers(50, 2500))
        d = toad.empty(n)
        d["txid"] = rng.integers(0, int(rng.integers(1, 4)), n)
        d["rxid"] = rng.integers(0, int(rng.integers(1, 4)), n)
        quantize = bool(rng.integers(2))
        ts = rng.uniform(0, float(rng.choice([2.0, 30.0, 500.0])), n)
        d["timestamp"] = np.sort(np.round(ts, 2) if quantize else ts)
        d["energy"] = (rng.integers(0, 5, n).astype(np.float64)
                       if quantize else rng.random(n))
        w = float(rng.choice([0.0, 0.05, 0.5, 5.0]))
        mm = int(rng.integers(1, 4))
        a = match_detections(d, w, mm)
        b = match_detections_batched(d, w, mm)
        same = (a[0] == b[0] and a[1] == b[1]
                and [(int(x), int(y)) for x, y in a[2]]
                == [(int(x), int(y)) for x, y in b[2]])
        if not same:
            stats["divergences"] += 1
            if len(stats["examples"]) < 5:
                stats["examples"].append(("mismatch", t, n, w, mm))
    return stats


def sweep_tdoa(trials, rng, device):
    """Host code: ``device`` is unused."""
    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.pipeline import matchmaker, tdoa

    models = [tdoa.build_model_poly, tdoa.build_model_nearest,
              tdoa.build_model_weighted_poly, tdoa.build_model_linear]
    stats = dict(trials=0, comparisons=0, divergences=0, examples=[])
    for trial in range(trials):
        stats["trials"] += 1
        n_rx = int(rng.integers(2, 6))
        rx_pos = {i: rng.uniform(-1e4, 1e4, 2) for i in range(n_rx)}
        beacon_pos = {9: rng.uniform(-5e3, 5e3, 2)}
        mobile_pos = {3: rng.uniform(-5e3, 5e3, 2)}
        duration = float(rng.uniform(10, 40))
        be = float(rng.choice([0.25, 1.0, 3.0]))
        schedule = [(9, t) for t in np.arange(0.5, duration, be)]
        schedule += [(3, float(t)) for t in
                     rng.uniform(1, duration - 1, int(rng.integers(1, 6)))]
        if rng.integers(2):
            schedule += [(9, 0.5 + be * int(rng.integers(0, 3)))]
        det = sim.synth_network(
            rx_pos, {**beacon_pos, **mobile_pos}, schedule, 2.4e6,
            clock_offsets={i: float(rng.normal(0, 5e3))
                           for i in range(1, n_rx)},
            clock_drifts={i: float(rng.normal(0, 3e-6))
                          for i in range(1, n_rx)},
            soa_noise=float(rng.choice([0.0, 0.01, 0.1])), seed=trial)
        if rng.integers(2):
            det["timestamp"] = np.round(det["timestamp"], 1)
        if rng.integers(3) == 0 and len(det) > 4:
            det["soa"][int(rng.integers(0, len(det)))] = np.nan
        matches, _, _ = matchmaker.match_detections(det)
        w = float(rng.choice([2.0, 8.0, 20.0]))
        for mb in models:
            stats["comparisons"] += 1
            bad = None
            try:
                seq, sf = tdoa.estimate_tdoas(
                    det, matches, w, beacon_pos, rx_pos, 2.4e6,
                    model_builder=mb, batched=False)
                bat, bf = tdoa.estimate_tdoas(
                    det, matches, w, beacon_pos, rx_pos, 2.4e6,
                    model_builder=mb, batched=True)
            except Exception as e:  # noqa: BLE001 -- reported
                bad = "exception: " + repr(e)[:60]
            else:
                if len(seq) != len(bat):
                    bad = "group_count"
                elif sorted(map(tuple, sf)) != sorted(map(tuple, bf)):
                    bad = "failures"
                else:
                    for a, b in zip(seq, bat):
                        if len(a.tdoas) != len(b.tdoas):
                            bad = "row_count"
                            break
                        if len(a.tdoas) and not np.all(
                                np.abs(a.tdoas["tdoa"]
                                       - b.tdoas["tdoa"]) < 1e-11):
                            bad = "tdoa_diff"
                            break
                        if np.any(~np.isfinite(a.tdoas["tdoa"])):
                            bad = "nonfinite"
                            break
            if bad:
                stats["divergences"] += 1
                if len(stats["examples"]) < 5:
                    stats["examples"].append((bad, trial, mb.__name__))
    return stats


def sweep_pos(trials, rng, device):
    from thrifty_tpu_torch.pipeline import pos
    from thrifty_tpu_torch.pipeline import tdoa as tdoa_mod

    C = tdoa_mod.SPEED_OF_LIGHT
    stats = dict(trials=0, comparisons=0, gn_worse_100m_wellposed=0,
                 gn_better_100m=0, equal_residual_ambiguous=0,
                 examples=[])
    for trial in range(trials):
        stats["trials"] += 1
        dims = 3 if trial % 4 == 3 else 2
        n_rx = int(rng.integers(dims + 1, 7))
        spread = float(rng.choice([2e3, 1e4, 3e4]))
        rx = {i: rng.uniform(-spread, spread, dims)
              for i in range(n_rx)}
        if dims == 3:
            # Realistic near-coplanar deployment: tiny altitude spread
            # (the 3-D analog of the collinear mirror ambiguity).
            for i in rx:
                rx[i][2] *= 1e-2
        if rng.integers(4) == 0:  # near-collinear array
            base = rng.uniform(-spread, spread, dims)
            d = rng.uniform(-1, 1, dims)
            d /= np.linalg.norm(d)
            rx = {i: base + d * (i * spread / n_rx)
                  + rng.normal(0, spread * 1e-3, dims)
                  for i in range(n_rx)}
        inside = bool(rng.integers(2))
        tx = rng.uniform(-spread, spread, dims) if inside \
            else rng.uniform(-3 * spread, 3 * spread, dims)
        if dims == 3:
            tx[2] = float(rng.uniform(0, spread * 0.1))
        noise_ns = float(rng.choice([0.0, 5.0, 50.0]))
        rows = []
        for i in range(n_rx):
            for j in range(i + 1, n_rx):
                t = (np.linalg.norm(tx - rx[i])
                     - np.linalg.norm(tx - rx[j])) / C
                rows.append((i, j, t + rng.normal(0, noise_ns * 1e-9),
                             1e4, 1.0, 0, 0))
        g = tdoa_mod.TdoaGroup(
            group_id=trial, timestamp=0.0, tx=3,
            tdoas=np.array(rows, dtype=tdoa_mod.TDOA_DTYPE))
        ref = pos.solve([g], rx)
        got = pos.solve_batched([g], rx, device=device)
        if len(ref) == 0 or len(got) == 0:
            continue
        stats["comparisons"] += 1
        # Full-dimensional error: grading 3-D trials by horizontal
        # error only would let a z-axis solver regression pass silently.
        names = ("x", "y", "z")[:dims]

        def pos_err(row):
            return float(np.linalg.norm(
                [row[c][0] - tx[d] for d, c in enumerate(names)]))

        err_ref, err_got = pos_err(ref), pos_err(got)
        # Well-posed = transmitter inside the array spread AND scipy
        # solved it well; a >100 m regression there is a solver defect
        # ONLY if the batched fit is also genuinely worse.  Mirror
        # ambiguity can put two minima at the SAME residual far apart
        # in space (a near-coplanar 3-D array cannot tell +-altitude
        # apart): there the data supports both answers and which one a
        # solver lands in is start-point luck, for scipy as much as for
        # the batched solver.
        rxp = np.array([rx[i] for i in range(n_rx)])

        def resid_norm(row):
            p = np.array([row[c][0] for c in names])
            r = [np.linalg.norm(p - rxp[i]) - np.linalg.norm(p - rxp[j])
                 - t * C for (i, j, t, *_) in rows]
            return float(np.linalg.norm(r))

        # Residual slack scaled to the trial's own noise floor: with
        # noise_ns=0 both solvers should reach ~machine-level residuals.
        # 3-sigma over the row count covers the expected residual-norm
        # fluctuation between two minima fit to the same noisy rows.
        slack = max(0.01, 3.0 * noise_ns * 1e-9 * C * np.sqrt(len(rows)))
        if inside and err_ref < 50.0 and err_got - err_ref > 100.0:
            res_ref, res_got = resid_norm(ref), resid_norm(got)
            if res_got > res_ref * 1.01 + slack:
                stats["gn_worse_100m_wellposed"] += 1
                if len(stats["examples"]) < 5:
                    stats["examples"].append(
                        ("gn_worse", trial, err_ref, err_got))
            else:
                stats["equal_residual_ambiguous"] += 1
                if len(stats["examples"]) < 5:
                    stats["examples"].append(
                        ("ambiguous", trial, err_ref, err_got,
                         res_ref, res_got))
        # Symmetric grading: the batched solver only gets credit for a
        # >100 m win when its residual is also genuinely better --
        # equal-residual mirror-basin coin-flips are ambiguous, not
        # wins, exactly as they are not losses above.
        if err_ref - err_got > 100.0:
            res_ref, res_got = resid_norm(ref), resid_norm(got)
            if res_got < res_ref * 0.99 - slack:
                stats["gn_better_100m"] += 1
            else:
                stats["equal_residual_ambiguous"] += 1
    return stats


def sweep_fastdet(trials, rng, device):
    """Near-threshold differential campaign vs the COMPILED fastdet.

    Sweeps burst amplitudes through the detection knee -- the
    float32-vs-double decision-boundary risk region of the corr/carrier
    thresholds (reference fastdet/corr_detector.cpp:157-165) -- and
    compares per-block decisions and SoAs of the port's integer-sync
    detector on ``device`` against the reference C/C++ binaries (built
    by scripts/build_fastdet_shim.sh, the same build that produced the
    committed goldens).

    A decision flip whose deciding gate margin |energy/threshold - 1|
    exceeds ``BAND`` would mean the two implementations disagree
    beyond numerical noise; flips inside the band are expected physics
    (both backends round differently at the boundary).  Counts
    out-of-band flips and large SoA disagreements as divergences.
    """
    import shutil
    import subprocess
    import tempfile

    from thrifty_tpu_torch import sim
    from thrifty_tpu_torch.dsp import iq
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.io import card, tpl

    BAND = 1e-3          # relative decision margin of an in-band flip
    SOA_TOL = 1e-4       # samples (the golden-test tolerance)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_dir = os.environ.get("THRIFTY_REFERENCE", "/root/reference")
    stats = dict(trials=0, blocks=0, both_detected=0, decision_flips=0,
                 flips_out_of_band=0, max_inband_flip_margin=0.0,
                 worst_soa_diff=0.0, divergences=0, examples=[])
    if not os.path.isdir(ref_dir):
        stats["skipped"] = "reference tree not available"
        return stats

    work = tempfile.mkdtemp(prefix="fastdet_sweep.")
    try:
        subprocess.run(
            [os.path.join(repo, "scripts", "build_fastdet_shim.sh"),
             ref_dir, work],
            check=True, capture_output=True, text=True)
        fastdet = os.path.join(work, "bin", "fastdet")

        template = sim.make_template()
        tpl_tpl = os.path.join(work, "template.tpl")
        tpl.save_tpl(tpl_tpl, template)

        det = BatchDetector(template, DetectorConfig(
            carrier_window=(7, 110), sync_mode="integer"), device=device)
        s = np.sqrt(15.0)  # thresholds are 15s (sqrt(c + s*noise^2))

        for trial in range(trials):
            # Log-uniform amplitudes across the detection knee (100% at
            # ~0.012, 0% at ~0.008 with noise_std 0.05) plus margins
            # either side.
            amp = float(10 ** rng.uniform(np.log10(0.006),
                                          np.log10(0.03)))
            cap = sim.synth_capture(
                num_blocks=24, bursts_every=2, template=template,
                amplitude=amp, noise_std=0.05, seed=1000 + trial,
                quantize=True, frac_jitter=True)
            card_path = os.path.join(work, "trial.card")
            toad_path = os.path.join(work, "trial.toad")
            card.write_card(card_path, cap.timestamps, cap.indices,
                            iq.iq_to_raw(cap.blocks))
            subprocess.run(
                [fastdet, "--card", "-i", card_path, "-b", "16384",
                 "-h", "4920", "-w", "7-110", "-t", "15s", "-u", "15s",
                 "-z", tpl_tpl, "-r", "0", "-o", toad_path, "-q"],
                check=True, capture_output=True)
            with open(toad_path) as f:
                text = f.read().strip()
            ref = (np.atleast_2d(np.loadtxt(io.StringIO(text)))
                   if text else np.zeros((0, 12)))
            ref_by_block = {int(r[2]): r for r in ref}

            out = _host(det(cap.blocks))
            soa = det.soa(cap.indices, out["corr_sample"],
                          out["corr_offset"])
            corr_margin = out["corr_energy"] / np.maximum(
                s * out["corr_noise"], 1e-30)
            carrier_margin = out["carrier_energy"] / np.maximum(
                s * out["carrier_noise"], 1e-30)

            stats["trials"] += 1
            for b in range(len(cap.blocks)):
                stats["blocks"] += 1
                ours = bool(out["detected"][b])
                refs = b in ref_by_block
                if ours and refs:
                    stats["both_detected"] += 1
                    diff = abs(float(soa[b]) - float(ref_by_block[b][3]))
                    stats["worst_soa_diff"] = max(
                        stats["worst_soa_diff"], diff)
                    if diff > SOA_TOL:
                        stats["divergences"] += 1
                        if len(stats["examples"]) < 5:
                            stats["examples"].append(
                                ("soa", trial, b, diff))
                elif ours != refs:
                    stats["decision_flips"] += 1
                    # The flip's deciding gate sat at its threshold:
                    # distance of the closest gate from 1.0.
                    margin = min(abs(float(corr_margin[b]) - 1.0),
                                 abs(float(carrier_margin[b]) - 1.0))
                    if margin > BAND:
                        stats["flips_out_of_band"] += 1
                        stats["divergences"] += 1
                        if len(stats["examples"]) < 5:
                            stats["examples"].append(
                                ("flip", trial, b, margin,
                                 "ours" if ours else "ref"))
                    else:
                        stats["max_inband_flip_margin"] = max(
                            stats["max_inband_flip_margin"], margin)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return stats


SUITES = {"detector": sweep_detector, "matchmaker": sweep_matchmaker,
          "tdoa": sweep_tdoa, "pos": sweep_pos,
          "fastdet": sweep_fastdet}


def main(argv=None):
    from thrifty_tpu_torch.device import DEVICES, resolve_device

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--suite", choices=sorted(SUITES) + ["all"],
                        default="all")
    parser.add_argument("--trials", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where the detector and the batched solver "
                             "run; 'cuda' fails without a card "
                             "[default: cuda]")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    failed = False
    # 'all' covers the self-contained suites; 'fastdet' (which builds
    # the reference C tree against the shim backend) is opt-in.
    names = (sorted(k for k in SUITES if k != "fastdet")
             if args.suite == "all" else [args.suite])
    for name in names:
        rng = np.random.default_rng(args.seed)
        stats = SUITES[name](args.trials, rng, device)
        key = ("gn_worse_100m_wellposed" if name == "pos"
               else "divergences")
        bad = stats.get(key, 0)
        failed |= bad > 0
        print(json.dumps({"suite": name, "ok": bad == 0, **stats}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
