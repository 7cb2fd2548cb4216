"""The port's streaming, integer-sync, gated, bank, preshift,
interpolator, stddev, peak-filter, capture and matmul-transform paths on
a CUDA card against the same port on the CPU (which the other
test_torch_* files hold against the JAX package), the power/peak kernel
against its plain version on the bank rows and both stats masks, and
the matmul transforms' precisions against the float64 FFT (TF32 off
again after every call).

Every test is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_card_paths.py``.
Geometry of tests/test_torch_detector.py (block 2048, history 256, a
5-bit Gold template, here as fixed chips).  Tolerances: decisions, bins
and lags exact; offsets atol 2e-3 (carrier) and 1e-3 (correlation);
magnitudes and noise rtol 1e-4 (cuFFT against PocketFFT in the last
bits).  Each path must launch the power/peak kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu_torch.dsp import iq  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.pipeline.capture import CarrierGate  # noqa: E402

pytestmark = pytest.mark.cuda

BLOCK, HISTORY = 2048, 256
EXACT = ("detected", "carrier_detect", "carrier_bin", "corr_sample",
         "template_idx")
TOLS = {"carrier_offset": dict(atol=2e-3), "corr_offset": dict(atol=1e-3),
        "carrier_energy": dict(rtol=1e-4), "carrier_noise": dict(rtol=1e-4),
        "corr_energy": dict(rtol=1e-4), "corr_noise": dict(rtol=1e-4)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def template(seed=5):
    # A 31-chip +-1 code at 2 samples per chip (the shape of the 5-bit
    # Gold template the JAX-side tests use), from a seed.
    chips = np.random.default_rng(seed).choice([-1.0, 1.0], size=31)
    return np.repeat(chips, 2)


def bank():
    return np.stack([template(5), template(6), template(7)])


def capture(bursts_every=2, seed=3, tmpl=None):
    return sim.synth_capture(
        num_blocks=16, bursts_every=bursts_every,
        template=template() if tmpl is None else tmpl,
        block_len=BLOCK, history_len=HISTORY, carrier_bin=40.25,
        amplitude=0.8, noise_std=0.05, seed=seed)


def assert_same(card, cpu):
    for k, c in cpu.items():
        g = card[k].cpu().numpy()
        c = c.numpy()
        if k in EXACT:
            np.testing.assert_array_equal(g, c, err_msg=k)
        else:
            np.testing.assert_allclose(g, c, err_msg=k, **TOLS[k])


def pair(dev, tmpl=None, **kw):
    cfg = DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                         carrier_window=(7, 110), **kw)
    tmpl = template() if tmpl is None else tmpl
    return (BatchDetector(tmpl, cfg, device=dev),
            BatchDetector(tmpl, cfg, device="cpu"))


STATS = dict(carrier_thresh=(0.0, 15.0, 40.0),
             corr_thresh=(0.0, 15.0, 600.0))


@pytest.mark.parametrize("kw,launches", [
    (dict(sync_mode="integer"), 2),
    (dict(gate_capacity=12), 2),          # 8 carriers: gated
    (dict(gate_capacity=4), 3),           # overflow: full re-run
    (dict(sync_mode="integer", gate_capacity=4), 3),
    (dict(sync_mode="preshift"), 2),
    (dict(corr_interp="autocorr"), 2),
    (dict(corr_interp="maximise"), 2),
    (dict(corr_interp="cosine", carrier_interp="polyfit"), 2),
    (STATS, 2),                           # both stats masks
    (dict(peak_filter_len=-1), 1),        # carrier search: torch ops
    (dict(bank=True), 2),                 # [B*T, N] correlation rows
    (dict(bank=True, gate_capacity=12, sync_mode="preshift"), 2),
    (dict(bank=True, gate_capacity=4), 3),
])
def test_detector_on_card_matches_cpu(cuda_device, kw, launches):
    kw = dict(kw)
    tmpl = bank() if kw.pop("bank", False) else None
    cap = capture(tmpl=None if tmpl is None else tmpl[1])
    raw = iq.iq_to_raw(cap.blocks)
    card, cpu = pair(cuda_device, tmpl, **kw)
    before = pp.launches
    got = card.detect_raw(torch.from_numpy(raw).to(cuda_device))
    torch.cuda.synchronize()
    assert pp.launches == before + launches
    assert_same(got, cpu.detect_raw(raw))


def test_stream_on_card_matches_cpu(cuda_device):
    cap = capture(seed=9)
    new = iq.iq_to_raw(cap.blocks[:, HISTORY:].reshape(-1))
    half = new.size // 2
    card, cpu = pair(cuda_device, gate_capacity=6)
    for part in (new[:half], new[half:]):
        assert_same(card.detect_raw_stream(part),
                    cpu.detect_raw_stream(part))
    assert card._stream.carry.device.type == "cuda"


@pytest.mark.parametrize("thresh", [(0.0, 15.0, 0.0), (0.0, 5.0, 40.0)])
def test_capture_gate_on_card_matches_cpu(cuda_device, thresh):
    cap = capture(bursts_every=3, seed=21)
    raw = iq.iq_to_raw(cap.blocks)
    new = raw[:, 2 * HISTORY:].reshape(-1)
    card = CarrierGate(BLOCK, (7, 110), thresh, history_len=HISTORY,
                       device=cuda_device)
    cpu = CarrierGate(BLOCK, (7, 110), thresh, history_len=HISTORY,
                      device="cpu")
    before = pp.launches
    for got, ref in ((card(raw), cpu(raw)),
                     (card.gate_stream(new), cpu.gate_stream(new))):
        for k, (g, r) in enumerate(zip(got, ref)):
            g, r = g.cpu().numpy(), r.numpy()
            if k < 2:
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g, r, rtol=1e-4)
    assert pp.launches == before + 2


def test_kernel_on_bank_rows_and_stats_masks(cuda_device):
    """The power/peak kernel against its plain version on the inputs the
    bank and the stddev terms give it: the [B*T, N] correlation rows of
    a bank (and the gathered [C*T, N] rows of the gated bank) with the
    correlation window and the first corr_len lags as stats mask, and
    the carrier spectrum with an all-true stats mask.  idx and peak
    bit-equal, sums within 1e-5 relative."""
    calls = []
    orig = pp.fused_power_peak

    def spy(x, mask, stats_mask=None, layout="interleaved"):
        calls.append((x.clone(), mask, stats_mask))
        return orig(x, mask, stats_mask=stats_mask, layout=layout)

    cap = capture(tmpl=bank()[2])
    pp.fused_power_peak = spy
    try:
        for kw in (STATS, dict(STATS, gate_capacity=12)):
            BatchDetector(bank(), DetectorConfig(
                block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110),
                **kw), device=cuda_device)(cap.blocks)
    finally:
        pp.fused_power_peak = orig
    assert [tuple(x.shape) for x, _, _ in calls] == [
        (16, BLOCK), (48, BLOCK), (16, BLOCK), (36, BLOCK)]
    for x, mask, stats in calls:
        got = [g.cpu() for g in pp.fused_power_peak(x, mask, stats)]
        ref = [r.cpu() for r in pp.fused_power_peak_reference(
            x.real, x.imag, mask.bool, stats.bool)]
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1], ref[1])
        for g, r in zip(got[2:], ref[2:]):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=0)


# -- the matmul transforms (dsp/mxu_fft.py) on the card ----------------------

def transform_error(dev, impl, prec, n=16384):
    """Max |error| / max |exact| of the matmul FFT on the card against the
    float64 numpy FFT, and TF32's switch after the call."""
    from thrifty_tpu_torch.dsp import mxu_fft

    rng = np.random.default_rng(8)
    x = (rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))
         ).astype(np.complex64)
    got = mxu_fft.fft(torch.from_numpy(x).to(dev), impl, prec).cpu().numpy()
    ref = np.fft.fft(x.astype(np.complex128))
    return (np.max(np.abs(got - ref)) / np.max(np.abs(ref)),
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("n", [1024, 16384])
def test_precisions_on_card(cuda_device, impl, n):
    """'highest' within JAX's 2e-5; 'high' (TF32) coarser than it and
    within 2e-3; 'default' (bf16) within 1e-2; TF32 off again after
    every call."""
    errs = {}
    for prec in ("highest", "high", "default"):
        errs[prec], tf32 = transform_error(cuda_device, impl, prec, n)
        assert tf32 is False, prec
    assert errs["highest"] < 2e-5, errs
    assert errs["highest"] < errs["high"] < 2e-3, errs
    assert errs["default"] < 1e-2, errs


def test_tf32_restored_after_high_detect(cuda_device):
    """A detector with 'high' transforms leaves TF32 as it found it (off,
    as resolve_device sets it), and so does every transform of it."""
    from thrifty_tpu_torch.dsp import mxu_fft

    cap = capture()
    card, _ = pair(cuda_device, fft_impl="matmul", fft_precision="high")
    card(cap.blocks)
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    x = torch.from_numpy(cap.blocks).to(cuda_device)
    for call in (lambda: mxu_fft.ifft_head(x, 100, "matmul3", "high"),
                 lambda: mxu_fft.windowed_dft(x, np.arange(7, 111),
                                              "matmul", "high"),
                 lambda: mxu_fft.fft_ramped(
                     x, torch.zeros(len(x), device=cuda_device), "matmul",
                     "high")):
        call()
        assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("kw,launches", [
    (dict(fft_impl="matmul"), 1),                    # windowed carrier
    (dict(fft_impl="matmul3"), 1),
    (dict(fft_impl="matmul", **STATS), 2),           # full carrier FFT
    (dict(fft_impl="matmul", sync_mode="integer"), 2),
    (dict(fft_impl="matmul", gate_capacity=4), 2),   # windowed + overflow
])
def test_transform_paths_on_card_match_cpu(cuda_device, kw, launches):
    cap = capture()
    raw = iq.iq_to_raw(cap.blocks)
    card, cpu = pair(cuda_device, **kw)
    before = pp.launches
    got = card.detect_raw(torch.from_numpy(raw).to(cuda_device))
    torch.cuda.synchronize()
    assert pp.launches == before + launches
    assert_same(got, cpu.detect_raw(raw))


def test_pallas_off_refused_on_card(cuda_device):
    """The card has no plain reduction path: a CUDA detector refuses
    use_pallas='off' and launches nothing."""
    before = pp.launches
    with pytest.raises(ValueError, match="use_pallas='off'"):
        pair(cuda_device, use_pallas="off")
    assert pp.launches == before


def test_windowed_capture_gate_on_card_matches_cpu(cuda_device):
    cap = capture(bursts_every=3, seed=21)
    raw = iq.iq_to_raw(cap.blocks)
    card = CarrierGate(BLOCK, (7, 110), (0.0, 15.0, 0.0),
                       fft_impl="matmul", device=cuda_device)
    cpu = CarrierGate(BLOCK, (7, 110), (0.0, 15.0, 0.0), fft_impl="matmul",
                      device="cpu")
    before = pp.launches
    for k, (g, r) in enumerate(zip(card(raw), cpu(raw))):
        g, r = g.cpu().numpy(), r.numpy()
        if k < 2:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4)
    assert pp.launches == before
