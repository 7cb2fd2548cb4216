"""Template banks on the port (CPU): the [T, L] code-division detector
against the JAX detector, and the code-division flow through the port's
``kitchen_sink``.

Geometry of tests/test_torch_detector.py (block 2048, history 256) with
a 3-code bank of 5-bit Gold codes at 2 samples per chip; the capture
carries code 1.  The port is built from the JAX detector's constants
(``from_numpy_state``) and compared field by field with test_torch_
detector's ``EXACT``/``TOLS``: against the JAX kernel program
(``use_pallas='on'``) ungated, against the JAX gated detector
(``use_pallas='off'``: JAX refuses its kernel beside the gate) gated.
The code-division flow meets every assertion of
tests/test_code_division.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_code_division as cd  # noqa: E402
from test_torch_detector import BLOCK, HISTORY, \
    assert_outputs_match  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import template as template_mod  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.pipeline import kitchen_sink  # noqa: E402

BANK = template_mod.generate_bank(5, [0, 1, 2], 2.0)
KW = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110))
SYNCS = ("fractional", "integer", "preshift")
INTERPS = ("gaussian", "parabolic", "cosine", "autocorr", "none",
           "maximise")


@pytest.fixture(scope="module")
def cap():
    return sim.synth_capture(
        num_blocks=16, bursts_every=2, template=BANK[1], block_len=BLOCK,
        history_len=HISTORY, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=3)


def jax_state(jdet):
    """The JAX detector's constants under the port's state keys."""
    state = {"tmpl_fft_conj": jdet._tmpl_fft_conj,
             "tmpl_energy": jdet._tmpl_energy,
             "carrier_mask": jdet._carrier_mask,
             "corr_mask_full": jdet._corr_mask_full}
    if jdet.config.sync_mode == "preshift":
        state["preshift_bank"] = jdet._preshift_bank
    if jdet.config.peak_filter_len:
        state["peak_filter"] = jdet._peak_filter
        state["carrier_sel"] = jdet._carrier_sel
    if jdet.config.corr_interp == "autocorr":
        # JAX keeps the autocorr tables in the interpolator's closure.
        outer = jdet._corr_interp.__closure__[0].cell_contents
        cells = dict(zip(outer.__code__.co_freevars,
                         (c.cell_contents for c in outer.__closure__)))
        state["autocorr_table"] = np.asarray(cells["table"])
        state["autocorr_dtable"] = np.asarray(cells["dtable"])
    return state


def pair(template, use_pallas="on", **kw):
    jdet = JaxDetector(template, JaxConfig(use_pallas=use_pallas, **kw))
    tdet = BatchDetector.from_numpy_state(template, DetectorConfig(**kw),
                                          jax_state(jdet), device="cpu")
    return jdet, tdet


@pytest.mark.parametrize("corr_interp", INTERPS)
@pytest.mark.parametrize("sync_mode", SYNCS)
def test_bank_matches_jax_kernel_program(cap, sync_mode, corr_interp):
    jdet, tdet = pair(BANK, sync_mode=sync_mode, corr_interp=corr_interp,
                      **KW)
    got = tdet(cap.blocks)
    assert_outputs_match(got, jdet._detect_batch(np.asarray(cap.blocks)))
    det = got["detected"].numpy()
    assert det.sum() == len(cap.bursts)
    assert np.all(got["template_idx"].numpy()[det] == 1)


@pytest.mark.parametrize("template,kw", [
    (BANK, dict(sync_mode="fractional")),
    (BANK, dict(sync_mode="preshift", num_preshift=5)),
    (BANK[2], dict(sync_mode="preshift")),
    (BANK, dict(corr_interp="autocorr")),
    (BANK[0], dict(corr_interp="autocorr")),
    (BANK, dict(peak_filter_len=-1)),
    (BANK[0], dict(peak_filter_len=7, carrier_window=(-30, 40))),
])
def test_constants_bit_equal_to_jax(template, kw):
    """Every constant the port builds is bit-equal to the JAX
    detector's: bank spectra and energies, the preshift bank, the
    peak-filter weights and window order, the autocorr tables."""
    kw = dict(KW, **kw)
    jdet = JaxDetector(template, JaxConfig(**kw))
    own = BatchDetector.numpy_state(template, DetectorConfig(**kw))
    ref = jax_state(jdet)
    assert set(own) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert own[k].dtype == v.dtype and own[k].shape == v.shape, k
        np.testing.assert_array_equal(np.atleast_1d(own[k]).view(np.uint8),
                                      np.atleast_1d(v).view(np.uint8),
                                      err_msg=k)
    tdet = BatchDetector(template, DetectorConfig(**kw), device="cpu")
    assert (tdet.window, tdet.corr_len, tdet.num_templates) == \
        (jdet.window, jdet.corr_len, jdet.num_templates)


def test_state_shapes_are_checked():
    jdet = JaxDetector(BANK, JaxConfig(sync_mode="preshift", **KW))
    state = jax_state(jdet)
    cfg = DetectorConfig(sync_mode="preshift", **KW)
    with pytest.raises(ValueError, match="lacks"):
        BatchDetector.from_numpy_state(
            BANK, cfg, {k: v for k, v in state.items()
                        if k != "preshift_bank"}, device="cpu")
    with pytest.raises(ValueError, match="tmpl_fft_conj"):
        BatchDetector.from_numpy_state(
            BANK, cfg, dict(state, tmpl_fft_conj=state["tmpl_fft_conj"][0]),
            device="cpu")


@pytest.mark.parametrize("capacity", [3, 12])
def test_gated_bank_matches_jax_gated(cap, capacity):
    """The gated bank: [C*T, N] correlation rows, [B, T] defaults and
    keep[:, None] masking; capacity 3 overflows (8 carriers) and re-runs
    the whole batch."""
    kw = dict(KW, gate_capacity=capacity)
    jdet, tdet = pair(BANK, use_pallas="off", **kw)
    batch = tdet.submit(cap.blocks)
    got = batch.result()
    assert_outputs_match(got, jdet(cap.blocks))
    neg = ~got["carrier_detect"].numpy()
    for k in ("corr_sample", "corr_offset", "corr_energy", "corr_noise"):
        assert (got[k].numpy()[neg] == 0).all(), k
    assert batch.overflowed is (capacity == 3)


def test_bank_rows_reach_the_reduction_contiguous(cap, monkeypatch):
    """The bank's correlation reaches the power/peak reduction as one
    contiguous [B*T, N] launch with masks of length N; gated, as
    [C*T, N]."""
    calls = []
    orig = pp.fused_power_peak

    def spy(x, mask, stats_mask=None, layout="interleaved"):
        calls.append((tuple(x.shape), x.is_contiguous(), len(mask)))
        return orig(x, mask, stats_mask=stats_mask, layout=layout)

    monkeypatch.setattr(pp, "fused_power_peak", spy)
    BatchDetector(BANK, DetectorConfig(**KW), device="cpu")(cap.blocks)
    BatchDetector(BANK, DetectorConfig(gate_capacity=12, **KW),
                  device="cpu")(cap.blocks)
    b = len(cap.blocks)
    assert calls == [((b, BLOCK), True, BLOCK), ((3 * b, BLOCK), True, BLOCK),
                     ((b, BLOCK), True, BLOCK), ((36, BLOCK), True, BLOCK)]


@pytest.mark.parametrize("sync_mode", SYNCS)
@pytest.mark.parametrize("corr_interp",
                         ["gaussian", "parabolic", "cosine", "autocorr"])
def test_bank_all_modes(sync_mode, corr_interp):
    """tests/test_code_division.py::test_bank_all_modes on the port: the
    transmitted code is identified, SoA stays sub-sample accurate."""
    sps = cd.FS / 0.999707e6
    bank = template_mod.generate_bank(11, [0, 1, 2], sps)
    cap = sim.synth_capture(
        num_blocks=12, bursts_every=3, template=bank[1],
        carrier_bin=40.25, amplitude=0.5, noise_std=0.05, seed=5)
    det = BatchDetector(bank, DetectorConfig(
        carrier_window=(7, 110), sync_mode=sync_mode,
        corr_interp=corr_interp), device="cpu")
    out = {k: v.numpy() for k, v in det(cap.blocks).items()}
    soa = det.soa(cap.indices, out["corr_sample"], out["corr_offset"])
    errs = []
    for burst in cap.bursts:
        i = burst.block_idx
        assert out["detected"][i] and out["template_idx"][i] == 1
        errs.append(soa[i] - burst.expected_soa)
    tol = 0.6 if sync_mode == "integer" else 0.12
    assert float(np.sqrt(np.mean(np.square(errs)))) < tol


@pytest.fixture(scope="module")
def flow():
    """tests/test_code_division.py's flow on the port: synth_rx_captures
    (tx_codes) -> bank detect_all(txid_from_template) ->
    postdetect(keep_txid), and the JAX composition on the same
    captures."""
    from thrifty_tpu.pipeline import kitchen_sink as jax_sink

    sps = cd.FS / 0.999707e6
    bank = template_mod.generate_bank(11, [0, 1, 2], sps)
    schedule = [(0, t) for t in np.arange(0.02, 0.36, 0.05)]
    schedule += [(2, t) for t in (0.085, 0.185, 0.285)]
    caps = {rxid: (c.timestamps, c.indices, c.blocks)
            for rxid, c in sim.synth_rx_captures(
                cd.RX_POS, {**cd.BEACON_POS, **cd.MOBILE_POS},
                {0: cd.SHARED_BIN, 2: cd.SHARED_BIN}, schedule,
                template=bank[0], num_blocks=80, amplitude=0.6,
                noise_std=0.04, clock_offsets={1: 777.25, 2: -123.5},
                clock_drifts={1: 3e-6, 2: -2e-6}, seed=11,
                tx_codes={0: bank[0], 2: bank[2]}).items()}
    settings = kitchen_sink.PostdetectSettings(
        freqmap=None, match_window=0.02, tdoa_est_window=8.0,
        rx_pos=cd.RX_POS, beacon_pos=cd.BEACON_POS, sample_rate=cd.FS,
        keep_txid=True)
    det = BatchDetector(bank, DetectorConfig(carrier_window=(7, 110)),
                        device="cpu")
    port = kitchen_sink.postdetect(kitchen_sink.detect_all(
        caps, det, batch_size=16, txid_from_template=True), settings)
    jdet = JaxDetector(bank, JaxConfig(carrier_window=(7, 110)))
    ref = jax_sink.postdetect(jax_sink.detect_all(
        caps, jdet, batch_size=16, txid_from_template=True), settings)
    return port, ref


def test_codes_identified_on_shared_carrier(flow):
    port, ref = flow
    assert set(np.unique(port.toads["txid"])) == {0, 2}
    assert np.all(np.abs(port.toads["carrier_bin"] - cd.SHARED_BIN) <= 1)
    assert len(port.toads) == 30
    for k in ("rxid", "txid", "block", "sample", "carrier_bin"):
        np.testing.assert_array_equal(port.toads[k], ref.toads[k], err_msg=k)
    np.testing.assert_allclose(port.toads["soa"], ref.toads["soa"],
                               atol=1e-3)
    assert [sorted(m) for m in port.matches] == \
        [sorted(m) for m in ref.matches]


def test_positions_recovered(flow):
    port, ref = flow
    assert len(port.pos) == 3
    for row in port.pos:
        est = np.array([row["x"], row["y"]])
        assert np.linalg.norm(est - cd.MOBILE_POS[2]) < 60.0
    for k in ("x", "y"):
        np.testing.assert_allclose(port.pos[k], ref.pos[k], atol=0.05)
