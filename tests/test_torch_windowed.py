"""The port's transform knobs in the detector and the capture gate, on
the CPU, against the JAX package on the same captures.

- The windowed carrier stage (``fft_impl='matmul'``) against JAX's
  XLA program (``use_pallas='off'``, the program that has it): every
  carrier interpolator at the deployment geometry (block 16384, the
  4914-sample template), a wrapped window, the odd geometries of
  tests/test_mxu_fft.py and the gate.
- The full-FFT matmul paths against JAX's kernel program
  (``use_pallas='on'``): integer, preshift and a bank.
- ``use_pallas`` 'on'/'off', the state's window (``carrier_win``) and
  the capture gate's windowed form.

Tolerances are tests/test_torch_detector.py's (JAX's own .toad bar):
decisions, bins, lags and template indices exact; carrier_offset atol
2e-3 bins, corr_offset atol 1e-3 samples, magnitudes and noise rtol
1e-4.  The gate's floats rtol 1e-4 (tests/test_torch_capture.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bank import BANK, jax_state  # noqa: E402
from test_torch_capture import assert_gate_match  # noqa: E402
from test_torch_detector import BLOCK, HISTORY, TPL, \
    assert_outputs_match  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu.pipeline import capture as jcapture  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.pipeline import capture  # noqa: E402

FULL_TPL = sim.make_template()
MATMUL = dict(carrier_window=(7, 110), fft_impl="matmul")


@pytest.fixture(scope="module")
def full_cap():
    return sim.synth_capture(num_blocks=8, bursts_every=3,
                             template=FULL_TPL, seed=17, quantize=True)


def both(template, blocks, use_pallas="off", **kw):
    """(port on the CPU, JAX) outputs of one configuration; the port is
    built from JAX's constants (``from_numpy_state``, its
    ``_carrier_win`` included)."""
    jdet = JaxDetector(template, JaxConfig(use_pallas=use_pallas, **kw))
    state = jax_state(jdet)
    if jdet._carrier_win is not None:
        state["carrier_win"] = jdet._carrier_win
    tdet = BatchDetector.from_numpy_state(template, DetectorConfig(**kw),
                                          state, device="cpu")
    assert (tdet._carrier_win is None) == (jdet._carrier_win is None)
    return tdet(blocks), jdet._detect_batch(np.asarray(blocks))


@pytest.mark.parametrize("interp", ["dirichlet", "parabolic", "gaussian",
                                    "cosine", "polyfit", "none"])
def test_windowed_carrier_per_interp(full_cap, interp):
    got, ref = both(FULL_TPL, full_cap.blocks, carrier_interp=interp,
                    **MATMUL)
    assert_outputs_match(got, ref)
    assert got["detected"].numpy()[[b.block_idx
                                    for b in full_cap.bursts]].all()


def test_wrapped_window():
    cap = sim.synth_capture(num_blocks=6, bursts_every=3, template=FULL_TPL,
                            seed=23, quantize=True, carrier_bin=-20)
    got, ref = both(FULL_TPL, cap.blocks, carrier_window=(-60, -5),
                    fft_impl="matmul")
    assert_outputs_match(got, ref)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("block_len,hist,win", [
    (2048, 64, (4, 60)),      # small geometry
    (2048, 64, (-30, 30)),    # window wrapping DC
    (4096, 128, (-120, -4)),  # all-negative bins
    (2048, 64, (1, 8)),       # window narrower than the interp margin
])
def test_odd_geometries(block_len, hist, win, impl):
    cap = sim.synth_capture(num_blocks=8, bursts_every=3, template=TPL,
                            block_len=block_len, history_len=hist,
                            carrier_bin=(win[0] + win[1]) / 2, seed=3)
    got, ref = both(TPL, cap.blocks, block_len=block_len, history_len=hist,
                    carrier_window=win, fft_impl=impl, gn_iters=4)
    assert_outputs_match(got, ref)


@pytest.mark.parametrize("capacity", [2, 8])
def test_gated_windowed(full_cap, capacity):
    """The gate on the windowed path (the correlation reads the blocks,
    not a carrier FFT) against JAX's gated program; capacity 2
    overflows, 8 does not."""
    got, ref = both(FULL_TPL, full_cap.blocks, gate_capacity=capacity,
                    **MATMUL)
    assert_outputs_match(got, ref)


@pytest.fixture(scope="module")
def small_cap():
    return sim.synth_capture(
        num_blocks=16, bursts_every=2, template=TPL, block_len=BLOCK,
        history_len=HISTORY, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=3)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("sync_mode", ["integer", "preshift"])
def test_full_fft_matmul_against_kernel_program(small_cap, sync_mode, impl):
    got, ref = both(TPL, small_cap.blocks, use_pallas="on",
                    block_len=BLOCK, history_len=HISTORY,
                    carrier_window=(7, 110), sync_mode=sync_mode,
                    fft_impl=impl)
    assert_outputs_match(got, ref)


@pytest.mark.parametrize("sync_mode", ["fractional", "integer"])
def test_bank_matmul_against_kernel_program(sync_mode):
    """A bank under the matmul impl against JAX's kernel program, whose
    carrier stage is a full FFT (the port's fractional bank takes the
    windowed stage: its own constants here)."""
    cap = sim.synth_capture(
        num_blocks=16, bursts_every=2, template=BANK[1], block_len=BLOCK,
        history_len=HISTORY, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=3)
    kw = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110),
              sync_mode=sync_mode, fft_impl="matmul")
    jdet = JaxDetector(BANK, JaxConfig(use_pallas="on", **kw))
    tdet = BatchDetector(BANK, DetectorConfig(**kw), device="cpu")
    got = tdet(cap.blocks)
    assert_outputs_match(got, jdet._detect_batch(np.asarray(cap.blocks)))
    assert np.all(got["template_idx"].numpy()[got["detected"].numpy()] == 1)


def test_use_pallas_off_is_the_plain_reduction(small_cap):
    """'off' names the plain reductions: a CPU detector runs them under
    every value (the wrapper's plain version for a CPU tensor, the same
    calls and every output bit equal), and a CUDA detector refuses 'off'
    before it resolves the device, since the kernel is the only
    reduction there."""
    kw = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110))
    a = BatchDetector(TPL, DetectorConfig(**kw), device="cpu")
    b = BatchDetector(TPL, DetectorConfig(use_pallas="off", **kw),
                      device="cpu")
    calls = []
    orig = pp.fused_power_peak
    pp.fused_power_peak = lambda *x, **k: calls.append(1) or orig(*x, **k)
    try:
        got = b(small_cap.blocks)
        assert len(calls) == 2
        want = a(small_cap.blocks)
        assert len(calls) == 4
    finally:
        pp.fused_power_peak = orig
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="use_pallas='off' runs the "
                           "plain power/peak reductions, which only a CPU "
                           "detector runs"):
            BatchDetector(TPL, DetectorConfig(use_pallas="off", **kw),
                          device=device)


@pytest.mark.parametrize("kw,batch", [
    (dict(), 12),                                  # batch % 8
    (dict(peak_filter_len=-1), 16),                # the peak filter
    (dict(block_len=1024, history_len=256), 16),   # block % 2048
])
def test_use_pallas_on_refuses_like_jax(kw, batch):
    cfg = dict(dict(block_len=BLOCK, history_len=HISTORY,
                    carrier_window=(7, 110), use_pallas="on"), **kw)
    blocks = np.zeros((batch, cfg["block_len"]), np.complex64)
    match = r"use_pallas='on' requires: batch divisible by 8 \(got {}\)" \
        .format(batch)
    with pytest.raises(ValueError, match=match):
        BatchDetector(TPL, DetectorConfig(**cfg), device="cpu")(blocks)
    with pytest.raises(ValueError, match=match):
        JaxDetector(TPL, JaxConfig(**cfg))(blocks)


@pytest.mark.parametrize("kw", [
    dict(MATMUL),
    dict(MATMUL, carrier_interp="none"),
    dict(MATMUL, carrier_interp="polyfit", interp_width=8),
    dict(MATMUL, carrier_window=(-60, -5)),
    dict(MATMUL, fft_impl="matmul3"),
    dict(MATMUL, fft_impl="xla"),
    dict(MATMUL, sync_mode="integer"),
    dict(MATMUL, carrier_window=None),
    dict(MATMUL, peak_filter_len=5),
    dict(MATMUL, carrier_thresh=(0.0, 15.0, 1.0)),
    dict(carrier_window=(7, 110)),
])
def test_state_window_equals_jax(kw):
    """numpy_state's ``carrier_win`` is JAX's ``_carrier_win`` (absent
    where JAX's is None), and the detector takes the path it names."""
    jwin = JaxDetector(FULL_TPL, JaxConfig(**kw))._carrier_win
    state = BatchDetector.numpy_state(FULL_TPL, DetectorConfig(**kw))
    if jwin is None:
        assert "carrier_win" not in state
    else:
        sel, ext, half = state["carrier_win"]
        assert half == jwin[2]
        for got, ref in ((sel, jwin[0]), (ext, jwin[1])):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    tdet = BatchDetector(FULL_TPL, DetectorConfig(**kw), device="cpu")
    assert (tdet._carrier_win is None) == (jwin is None)


def test_state_window_is_required_and_checked():
    cfg = DetectorConfig(block_len=BLOCK, history_len=HISTORY, **MATMUL)
    state = BatchDetector.numpy_state(TPL, cfg)
    lacking = {k: v for k, v in state.items() if k != "carrier_win"}
    with pytest.raises(ValueError, match="lacks"):
        BatchDetector.from_numpy_state(TPL, cfg, lacking, device="cpu")
    sel, ext, half = state["carrier_win"]
    with pytest.raises(ValueError, match="carrier_win"):
        BatchDetector.from_numpy_state(
            TPL, cfg, dict(state, carrier_win=(sel, ext[1:], half)),
            device="cpu")


# -- the capture gate --------------------------------------------------------

@pytest.fixture(scope="module")
def gate_raw():
    cap = sim.synth_capture(num_blocks=12, bursts_every=3, template=FULL_TPL,
                            seed=23)
    return jiq.iq_to_raw(cap.blocks), jiq.iq_to_raw(
        cap.blocks[:, 4920:]).reshape(-1)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
def test_gate_windowed_matches_jax(gate_raw, impl):
    raw, new = gate_raw
    tgate = capture.CarrierGate(16384, (7, 110), (0.0, 15.0, 0.0),
                                history_len=4920, fft_impl=impl,
                                device="cpu")
    jgate = jcapture.CarrierGate(16384, (7, 110), (0.0, 15.0, 0.0),
                                 history_len=4920, fft_impl=impl)
    assert tgate._win is not None and jgate._win is not None
    for got, ref in zip(tgate._win, jgate._win):
        np.testing.assert_array_equal(got, ref)
    got = tgate(raw)
    assert_gate_match(got, jgate(raw))
    assert got[0].any() and not got[0].all()
    assert_gate_match(tgate.gate_stream(new), jgate.gate_stream(new))
    # ...and the full-FFT gate: same verdicts and bins, floats within
    # the windowed transform's float32 error (JAX's bound, rtol 2e-5).
    full = capture.CarrierGate(16384, (7, 110), (0.0, 15.0, 0.0),
                               device="cpu")(raw)
    for i, (a, b) in enumerate(zip(full, got)):
        if i < 2:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5)


@pytest.mark.parametrize("kw", [dict(fft_impl="xla"),
                                dict(fft_impl="matmul",
                                     thresh=(0.0, 15.0, 2.0))])
def test_gate_full_fft_forms(gate_raw, kw):
    """Where the windowed gate does not apply (torch.fft, a stddev term)
    the gate is the transform plus the reduction, against JAX's."""
    thresh = kw.pop("thresh", (0.0, 15.0, 0.0))
    raw, _ = gate_raw
    tgate = capture.CarrierGate(16384, (7, 110), thresh, device="cpu", **kw)
    jgate = jcapture.CarrierGate(16384, (7, 110), thresh, **kw)
    assert tgate._win is None and jgate._win is None
    assert_gate_match(tgate(raw), jgate(raw))


def test_gate_bad_impl_raises():
    with pytest.raises(ValueError, match="unknown fft impl"):
        capture.CarrierGate(BLOCK, (7, 110), (0.0, 15.0, 0.0),
                            fft_impl="fftw", device="cpu")


def test_accuracy_sweep_script(tmp_path):
    """scripts/accuracy_sweep_torch.py at a tiny size on the CPU: every
    burst detected within 0.05 samples at the clear SNR, the oracle's
    RMS beside the port's, no false alarm on noise."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import accuracy_sweep_torch

    out = tmp_path / "sweep.json"
    assert accuracy_sweep_torch.main([
        "--device", "cpu", "--amplitudes", "0.6", "--blocks", "6",
        "--knee", "", "--noise-blocks", "4", "--fft-impl", "matmul",
        "--with-oracle", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["config"]["fft_impl"] == "matmul" and res["device"] == "cpu"
    row, = res["rows"]
    assert row["detected"] == row["bursts"] == 3
    assert row["soa_max"] < 0.05
    assert abs(row["oracle_rms"] - row["soa_rms"]) < 1e-3
    assert res["false_alarms"] == [0, 0]


def test_tf32_drift_script(tmp_path):
    """scripts/tf32_drift_torch.py at a tiny size on the CPU, where every
    precision computes in float32: each configuration keeps the default
    run's decisions and integer fields, and its offsets stay within the
    float32 transforms' 1e-4 samples and bins."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import tf32_drift_torch

    out = tmp_path / "drift.json"
    assert tf32_drift_torch.main([
        "--device", "cpu", "--seeds", "2", "--num-blocks", "8",
        "--configs", "matmul", "fft_high", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "CPU"
    assert sorted((r["seed"], r["config"]) for r in res["rows"]) == [
        (0, "fft_high"), (0, "matmul"), (1, "fft_high"), (1, "matmul")]
    for r in res["rows"]:
        assert not any(r["flips"].values()), r
        assert r["detections"] == 4
        assert r["corr_offset"] < 1e-4 and r["carrier_offset"] < 1e-4
        assert r["soa_all"] == r["corr_offset"]
        assert r["carrier_pos_all"] == r["carrier_offset"]
        assert r["bursts_off"] == r["default_bursts_off"] == 0
        assert r["flipped_own_blocks"] == 0
        assert r["burst_err"] < 0.05
        assert r["carrier_energy_rel"] < 1e-5
