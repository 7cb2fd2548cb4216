"""Random-geometry fuzz of the port's detector on the CPU: the three
classes of tests/test_fuzz.py (the differential against the float64
oracle, template banks by planted identity, planted SoA), on the port's
own ``sim``, templates and oracle.

The geometries are drawn from the same seeds as tests/test_fuzz.py, so
the port visits the JAX fuzz's geometries.  Where the block length
allows the matmul transforms (n <= 2048: the dense DFT; n >= 16384: the
four-step), ``fft_impl`` is drawn from ('auto', 'matmul') by a second
generator, which leaves the geometry draws unchanged.  Bounds are
tests/test_fuzz.py's: decisions, bins and planted lags exact, SoA within
1e-2 samples of the oracle and 0.3 of the planted truth.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet  # noqa: E402
from thrifty_tpu_torch.dsp import template as template_mod  # noqa: E402
from thrifty_tpu_torch.dsp import xcorr  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.oracle.numpy_ref import FastdetOracleDetector, \
    OracleDetector  # noqa: E402


def draw_impl(impl_rng, block):
    """'auto' or 'matmul' where n has a matmul path, else 'auto'."""
    if block <= 2048 or block >= 16384:
        return ("auto", "matmul")[int(impl_rng.integers(2))]
    return "auto"


def detect(tpl, blocks, **kw):
    det = BatchDetector(tpl, DetectorConfig(**kw), device="cpu")
    return det, {k: v.numpy() for k, v in det(blocks).items()}


class TestRandomGeometryDifferential:
    """The float32 batched detector against the float64 oracle on the
    same blocks, at random geometries, signed and wrap-crossing carrier
    windows, both reference sync modes and peak filters."""

    def test_differential_random_geometries(self):
        rng = np.random.default_rng(20260818)
        impl_rng = np.random.default_rng(6)
        impls = set()
        trials = 0
        while trials < 6:
            bits = int(rng.integers(5, 8))
            tpl = template_mod.generate(bits, 0, float(rng.uniform(1.6, 2.6)))
            tlen = len(tpl)
            block = int(2 ** rng.integers(9, 13))
            lo, hi = tlen + 1, block // 2
            if lo >= hi:
                continue
            trials += 1
            hist = int(rng.integers(lo, hi))
            new = block - hist
            num_blocks = int(rng.integers(4, 8))
            wstart, wstop = xcorr.corr_window(block, hist, tlen)
            half = block // 20
            kind = ("pos", "neg", "wrap")[trials % 3]
            if kind == "pos":
                window = (3, half)
                cbin = int(rng.integers(5, half - 1))
            elif kind == "neg":
                window = (-half, -3)
                cbin = -int(rng.integers(5, half - 1))
            else:
                window = (-half, half)
                cbin = int(rng.integers(3, half - 1)) * \
                    (1 if rng.integers(2) else -1)
            sync_mode = ["fractional", "integer"][trials % 2]
            flen = int(rng.choice([0, 5]))
            bursts, planted = [], []
            for b in range(1, num_blocks - 1):
                lag = int(rng.integers(wstart, wstop))
                bursts.append({"position": b * new + lag - hist,
                               "carrier_bin": cbin,
                               "amplitude": 0.7,
                               "phase": float(rng.uniform(0, 6.28))})
                planted.append((b, lag))
            stream = sim.synth_stream(num_blocks * new, bursts, tpl,
                                      block, noise_std=0.02, seed=trials)
            blocks = sim.stream_to_blocks(stream, block, hist).astype(
                np.complex64)
            impl = draw_impl(impl_rng, block)
            impls.add(impl)
            _, out = detect(tpl, blocks, block_len=block, history_len=hist,
                            carrier_window=window, sync_mode=sync_mode,
                            peak_filter_len=flen, fft_impl=impl)

            weights = dirichlet.dirichlet_weights(flen, block, tlen) \
                if flen else None
            oracle_cls = (OracleDetector if sync_mode == "fractional"
                          else FastdetOracleDetector)
            oracle = oracle_cls(tpl, block_len=block, history_len=hist,
                                carrier_window=window,
                                peak_filter=weights)
            geom = "trial=%d bits=%d block=%d hist=%d win=%s sync=%s " \
                "flen=%d cbin=%d impl=%s" % (trials, bits, block, hist,
                                             window, sync_mode, flen, cbin,
                                             impl)
            for b, lag in planted:
                ref = oracle.detect_block(blocks[b])
                # Both paths make the same decisions (a marginal geometry
                # may legitimately not detect: then both agree on that).
                assert bool(out["carrier_detect"][b]) \
                    == ref.carrier_detect, geom
                if not ref.carrier_detect:
                    continue
                assert int(out["carrier_bin"][b]) == ref.carrier_bin, geom
                # When detected, the PLANTED lag exactly.
                if bool(out["detected"][b]):
                    assert int(out["corr_sample"][b]) == lag, geom
                if abs(ref.carrier_offset) > 1.0:
                    # The oracle's unbounded curve_fit left its own bin
                    # (tiny template -> wide carrier lobe); the GN fit
                    # clamps to +-1 by design.  No oracle to compare.
                    continue
                assert bool(out["detected"][b]) == ref.detected, geom
                if not ref.detected:
                    continue
                assert int(out["corr_sample"][b]) == ref.corr_sample, geom
                soa_dev = float(out["corr_sample"][b]
                                + out["corr_offset"][b])
                soa_ref = ref.corr_sample + ref.corr_offset
                # float32 interpolation noise grows as templates shrink
                # (31-chip codes ~5e-3); wrap/shift/window bugs give
                # O(0.1+) errors or bin/verdict mismatches.
                assert abs(soa_dev - soa_ref) < 1e-2, \
                    "%s: SoA diff %.2e" % (geom, soa_dev - soa_ref)
        assert impls == {"auto", "matmul"}


class TestRandomGeometryBank:
    """Bursts planted with a random code of a 3-code Gold bank on one
    carrier: detected in the right block with the right template_idx
    and the planted lag, in all three sync modes (bank classification
    has no float64 oracle, so the truth is the planted identity)."""

    def test_bank_random_geometries(self):
        rng = np.random.default_rng(20260819)
        impl_rng = np.random.default_rng(6)
        trials = 0
        while trials < 6:
            bits = int(rng.integers(5, 8))
            bank = template_mod.generate_bank(
                bits, [0, 1, 2], float(rng.uniform(1.8, 2.4)))
            tlen = bank.shape[1]
            block = int(2 ** rng.integers(9, 13))
            lo, hi = tlen + 1, block // 2
            if lo >= hi:
                continue
            trials += 1
            hist = int(rng.integers(lo, hi))
            new = block - hist
            num_blocks = int(rng.integers(4, 8))
            wstart, wstop = xcorr.corr_window(block, hist, tlen)
            cbin = int(rng.integers(7, block // 40))
            sync = ("fractional", "integer", "preshift")[trials % 3]
            bursts, planted = [], []
            for b in range(1, num_blocks - 1):
                lag = int(rng.integers(wstart, wstop))
                code = int(rng.integers(0, 3))
                bursts.append({"position": b * new + lag - hist,
                               "carrier_bin": cbin,
                               "amplitude": 0.7,
                               "phase": float(rng.uniform(0, 6.28)),
                               "template": bank[code]})
                planted.append((b, lag, code))
            stream = sim.synth_stream(num_blocks * new, bursts, bank[0],
                                      block, noise_std=0.02, seed=trials)
            blocks = sim.stream_to_blocks(stream, block, hist).astype(
                np.complex64)
            impl = draw_impl(impl_rng, block)
            _, out = detect(bank, blocks, block_len=block, history_len=hist,
                            sync_mode=sync, carrier_window=(3, block // 20),
                            fft_impl=impl)
            geom = "trial=%d bits=%d block=%d hist=%d sync=%s impl=%s" % (
                trials, bits, block, hist, sync, impl)
            for b, lag, code in planted:
                assert bool(out["detected"][b]), "%s block=%d" % (geom, b)
                assert int(out["template_idx"][b]) == code, \
                    "%s block=%d: idx %d != planted %d" % (
                        geom, b, int(out["template_idx"][b]), code)
                assert int(out["corr_sample"][b]) == lag, \
                    "%s block=%d" % (geom, b)


class TestRandomGeometry:
    """For any valid overlap-save geometry a burst planted at a known
    position is detected in the predicted block with sub-sample SoA."""

    def test_random_geometries_detect_planted_burst(self):
        rng = np.random.default_rng(20260817)
        impl_rng = np.random.default_rng(0)
        for trial in range(6):
            bits = int(rng.integers(5, 8))  # template 31..127 chips
            tpl = template_mod.generate(bits, 0, 2.0)
            tlen = len(tpl)
            block = int(2 ** rng.integers(9, 13))  # 512..4096
            lo, hi = tlen + 1, block // 2
            if lo >= hi:
                continue
            hist = int(rng.integers(lo, hi))
            new = block - hist
            num_blocks = int(rng.integers(4, 10))
            wstart, wstop = xcorr.corr_window(block, hist, tlen)
            # One burst per block in its unique window, all on one
            # carrier (one TX, the reference's model).
            cbin = int(rng.integers(7, block // 40))
            bursts, expect = [], []
            for b in range(1, num_blocks - 1):
                lag = int(rng.integers(wstart, wstop))
                soa = b * new + lag
                bursts.append({"position": soa - hist,
                               "carrier_bin": cbin,
                               "amplitude": 0.7,
                               "phase": float(rng.uniform(0, 6.28))})
                expect.append((b, float(soa)))
            stream = sim.synth_stream(
                num_blocks * new, bursts, tpl, block,
                noise_std=0.02, seed=trial)
            blocks = sim.stream_to_blocks(stream, block, hist).astype(
                np.complex64)
            impl = draw_impl(impl_rng, block)
            det, out = detect(tpl, blocks, block_len=block, history_len=hist,
                              carrier_window=(3, block // 20), fft_impl=impl)
            soa = det.soa(np.arange(num_blocks),
                          out["corr_sample"], out["corr_offset"])
            geom = "bits=%d block=%d hist=%d impl=%s" % (bits, block, hist,
                                                         impl)
            for b, want in expect:
                assert out["detected"][b], \
                    "%s: no detection in block %d" % (geom, b)
                err = abs(float(soa[b]) - want)
                assert err < 0.3, \
                    "%s: SoA err %.3f in block %d" % (geom, err, b)
