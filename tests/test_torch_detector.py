"""The port's BatchDetector (on the CPU) against the JAX BatchDetector's
kernel program (``use_pallas='on'``), field by field.

Geometry of tests/test_pallas.py: block 2048, history 256, a 5-bit Gold
template.  The port is built from the JAX detector's own constants
(``from_numpy_state``).  Tolerances: decisions, bins and lags exact;
carrier_offset atol 2e-3 bins and corr_offset atol 1e-3 samples (the
.toad tolerances of tests/test_golden_reference.py: the float32 FFTs of
two libraries differ in the last bits, and the fits can amplify that);
magnitudes and noise rtol 1e-4.
"""

import unittest.mock as mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp import template as template_mod  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402

BLOCK, HISTORY = 2048, 256
TPL = template_mod.generate(5, 0, 2.0)
EXACT = ("detected", "carrier_detect", "carrier_bin", "corr_sample",
         "template_idx")
TOLS = {"carrier_offset": dict(atol=2e-3), "corr_offset": dict(atol=1e-3),
        "carrier_energy": dict(rtol=1e-4), "carrier_noise": dict(rtol=1e-4),
        "corr_energy": dict(rtol=1e-4), "corr_noise": dict(rtol=1e-4)}


def capture(carrier_bin, quantize, seed=3):
    return sim.synth_capture(
        num_blocks=16, bursts_every=2, template=TPL, block_len=BLOCK,
        history_len=HISTORY, carrier_bin=carrier_bin, amplitude=0.8,
        noise_std=0.05, seed=seed, quantize=quantize)


def jax_state(jdet):
    return {"tmpl_fft_conj": jdet._tmpl_fft_conj,
            "tmpl_energy": jdet._tmpl_energy,
            "carrier_mask": jdet._carrier_mask,
            "corr_mask_full": jdet._corr_mask_full}


def pair(window):
    jdet = JaxDetector(TPL, JaxConfig(block_len=BLOCK, history_len=HISTORY,
                                      carrier_window=window,
                                      use_pallas="on"))
    tdet = BatchDetector.from_numpy_state(
        TPL, DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                            carrier_window=window), jax_state(jdet),
        device="cpu")
    return jdet, tdet


def assert_outputs_match(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, err_msg=k, **TOLS[k])


# Negative carriers exercise the signed-bin wrap of the ramp.
CASES = [(40.25, (7, 110), False), (40.25, (7, 110), True),
         (-37.6, (-110, -7), False), (-37.6, (-110, -7), True)]


@pytest.mark.parametrize("carrier_bin,window,quantize", CASES)
def test_matches_jax_kernel_program(carrier_bin, window, quantize):
    cap = capture(carrier_bin, quantize)
    jdet, tdet = pair(window)
    ref = jdet._detect_batch(np.asarray(cap.blocks))
    got = tdet(cap.blocks)
    assert_outputs_match(got, ref)
    assert got["detected"].sum() == len(cap.bursts)


def test_matches_jax_with_pallas_interpret():
    """Against the JAX program with the Pallas kernel itself (interpret
    mode, as tests/test_pallas.py runs it)."""
    import thrifty_tpu.dsp.pallas_kernels as pkmod

    cap = capture(40.25, False, seed=5)
    orig = pkmod.fused_power_peak

    def interpreted(x, mask, **kw):
        kw["interpret"] = True
        return orig(x, mask, **kw)

    jdet, tdet = pair((7, 110))
    with mock.patch.object(pkmod, "fused_power_peak", interpreted):
        ref = jdet._detect_batch(np.asarray(cap.blocks))
    assert_outputs_match(tdet(cap.blocks), ref)


def test_detect_raw_matches_jax():
    cap = capture(40.25, True, seed=7)
    raw = jiq.iq_to_raw(cap.blocks)
    jdet, tdet = pair((7, 110))
    assert_outputs_match(tdet.detect_raw(raw), jdet.detect_raw(raw))


@pytest.mark.parametrize("window", [None, (7, 110), (-110, -7)])
def test_own_constants_bit_equal_to_jax(window):
    jdet = JaxDetector(TPL, JaxConfig(block_len=BLOCK, history_len=HISTORY,
                                      carrier_window=window))
    own = BatchDetector.numpy_state(
        TPL, DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                            carrier_window=window))
    for k, v in jax_state(jdet).items():
        v = np.asarray(v)
        assert own[k].dtype == v.dtype and own[k].shape == v.shape, k
        np.testing.assert_array_equal(
            np.atleast_1d(own[k]).view(np.uint8),
            np.atleast_1d(v).view(np.uint8), err_msg=k)
    tdet = BatchDetector(TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=window),
        device="cpu")
    assert tdet.window == jdet.window
    assert (tdet.corr_len, tdet.new_len) == (jdet.corr_len, jdet.new_len)


def test_soa_float64():
    jdet, tdet = pair((7, 110))
    blk = np.array([0, 123456789], dtype=np.int64)
    smp = np.array([5, 1000], dtype=np.int32)
    off = np.array([0.25, -0.125], dtype=np.float32)
    got = tdet.soa(blk, smp, off)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jdet.soa(blk, smp, off))
    assert got[1] == 123456789 * (BLOCK - HISTORY) + 1000 - 0.125


def test_state_is_checked():
    jdet, _ = pair((7, 110))
    cfg = DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                         carrier_window=(7, 110))
    state = jax_state(jdet)
    with pytest.raises(ValueError, match="lacks"):
        BatchDetector.from_numpy_state(TPL, cfg, {"tmpl_energy": 1.0},
                                       device="cpu")
    bad = dict(state, tmpl_fft_conj=state["tmpl_fft_conj"].astype(
        np.complex128))
    with pytest.raises(ValueError, match="complex64"):
        BatchDetector.from_numpy_state(TPL, cfg, bad, device="cpu")
    empty = dict(state, corr_mask_full=np.zeros(BLOCK, bool))
    with pytest.raises(ValueError, match="no True entries"):
        BatchDetector.from_numpy_state(TPL, cfg, empty, device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(corr_interp="cubic"), "unknown corr_interp"),
    (dict(sync_mode="bogus"), "unknown sync_mode"),
    (dict(carrier_interp="spline"), "unknown carrier_interp"),
    (dict(sync_mode="preshift", num_preshift=1), "num_preshift"),
    (dict(gate_capacity=-1), "gate_capacity"),
    (dict(history_len=10), "history_len"),
    (dict(use_pallas="ON"), "unknown use_pallas 'ON': expected 'auto', "
                            "'on' or 'off'"),
    (dict(fft_impl="fftw"), "unknown fft_impl 'fftw': expected 'auto', "
                            "'matmul', 'matmul3' or 'xla'"),
    (dict(fft_precision="quad"), "unknown fft_precision 'quad': expected "
                                 "'highest', 'high' or 'default'"),
    (dict(gate_capacity=8, use_pallas="on"),
     "gate_capacity and use_pallas='on' are mutually exclusive"),
])
def test_unported_options_raise(kw, match):
    """Every option of the JAX detector is ported; values it refuses are
    refused here too, with its wording."""
    cfg = DetectorConfig(**dict(dict(block_len=BLOCK, history_len=HISTORY),
                                **kw))
    with pytest.raises(ValueError, match=match):
        BatchDetector(TPL, cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxDetector(TPL, JaxConfig(**dict(
            dict(block_len=BLOCK, history_len=HISTORY), **kw)))


def test_template_bank_raises():
    """A [T, L] bank is ported (tests/test_torch_bank.py); a template of
    any other rank raises."""
    with pytest.raises(ValueError, match="template"):
        BatchDetector(np.stack([[TPL, TPL]]), DetectorConfig(
            block_len=BLOCK, history_len=HISTORY), device="cpu")


def test_bad_batch_shape_raises():
    _, tdet = pair((7, 110))
    with pytest.raises(ValueError, match="complex64"):
        tdet(np.zeros((2, BLOCK), np.complex128))
    with pytest.raises(ValueError, match="uint8"):
        tdet.detect_raw(np.zeros((2, BLOCK), np.uint8))
