"""The port's interpolators, stddev terms, preshift sync and carrier peak
filter (CPU) against the JAX package, and the port's detect CLI against
the reference goldens of tests/golden/interp/.

Detector comparisons use the geometry and tolerances of
tests/test_torch_detector.py (block 2048, history 256, a 5-bit Gold
template; ``EXACT`` fields equal, ``TOLS`` on the floats), against the
JAX kernel program (``use_pallas='on'``) or, for the peak filter that
JAX's kernel program refuses, its XLA program (``use_pallas='off'``).
Single interpolators on random neighbourhoods agree with JAX to float32
rounding (atol 1e-5; the maximise search 1e-3, see its test).  The CLI
runs meet tests/test_golden_interp.py's bounds: integer columns equal;
tight cases corr_offset < 1e-4 and soa
atol 1e-3; autocorr and maximise the high-SNR / median / worst-case
bounds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_golden_interp as gi  # noqa: E402
from test_torch_bank import jax_state  # noqa: E402
from test_torch_detector import BLOCK, HISTORY, TPL, \
    assert_outputs_match, capture  # noqa: E402
from thrifty_tpu.dsp import dirichlet as jdir  # noqa: E402
from thrifty_tpu.dsp import xcorr as jxc  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet, xcorr  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402

KW = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110))


def pair(use_pallas="on", template=TPL, **kw):
    kw = dict(KW, **kw)
    jdet = JaxDetector(template, JaxConfig(use_pallas=use_pallas, **kw))
    tdet = BatchDetector.from_numpy_state(template, DetectorConfig(**kw),
                                          jax_state(jdet), device="cpu")
    return jdet, tdet


def compare(cap, use_pallas="on", **kw):
    jdet, tdet = pair(use_pallas, **kw)
    got = tdet(cap.blocks)
    ref = jdet._detect_batch(np.asarray(cap.blocks)) if use_pallas == "on" \
        else jdet(cap.blocks)
    assert_outputs_match(got, ref)
    return got


@pytest.mark.parametrize("carrier_interp", ["parabolic", "gaussian",
                                            "cosine", "polyfit", "none"])
@pytest.mark.parametrize("sync_mode", ["fractional", "integer"])
def test_carrier_interps_match_jax(sync_mode, carrier_interp):
    cap = capture(40.25, False)
    got = compare(cap, sync_mode=sync_mode, carrier_interp=carrier_interp)
    assert got["detected"].sum() == len(cap.bursts)


@pytest.mark.parametrize("corr_interp", ["gaussian", "autocorr",
                                         "maximise", "cosine"])
@pytest.mark.parametrize("carrier_bin,window", [(40.25, (7, 110)),
                                                (-37.6, (-110, -7))])
def test_preshift_matches_jax(carrier_bin, window, corr_interp):
    """Preshift sync, negative carriers included (the signed-bin wrap of
    the integer roll and the fraction)."""
    cap = capture(carrier_bin, True)
    got = compare(cap, sync_mode="preshift", corr_interp=corr_interp,
                  carrier_window=window)
    assert got["detected"].sum() == len(cap.bursts)


@pytest.mark.parametrize("carrier_d,corr_d", [(40.0, 0.0), (0.0, 600.0),
                                              (40.0, 600.0)])
def test_stddev_terms_match_jax(carrier_d, corr_d):
    """Stddev threshold terms on either side and both, from the
    reduction's one-pass sums, against JAX's kernel program; the terms
    are large enough to change decisions (d = 40 keeps 3 of 8 carriers,
    d = 600 6 of 8 correlations)."""
    cap = capture(40.25, False, seed=2)
    kw = dict(carrier_thresh=(0.0, 15.0, carrier_d),
              corr_thresh=(0.0, 15.0, corr_d))
    got = compare(cap, **kw)
    base = BatchDetector(TPL, DetectorConfig(**KW), device="cpu")(cap.blocks)
    side = "carrier_detect" if carrier_d else "detected"
    assert not torch.equal(got[side], base[side])


def test_stddev_terms_match_xla_var():
    """The one-pass variance against JAX's XLA program (jnp.var over
    the carrier magnitudes and the corr_len unique lags)."""
    cap = capture(-37.6, True, seed=2)
    compare(cap, use_pallas="off", carrier_window=(-110, -7),
            carrier_thresh=(0.0, 15.0, 30.0), corr_thresh=(0.0, 15.0, 600.0))


def test_var_from_stats_clamps_cancellation():
    """E[x^2] - E[x]^2 in float32 can cancel below zero on a constant
    surface; the clamp keeps the threshold finite."""
    mag = torch.full((4, 1000), 1234.567, dtype=torch.float32)
    var = xcorr.var_from_stats(torch.sum(mag * mag, -1), torch.sum(mag, -1),
                               1000)
    assert torch.all(var >= 0) and torch.all(torch.isfinite(var))


@pytest.mark.parametrize("flen,window", [
    (-1, (7, 110)), (7, (7, 110)), (7, (-30, 40)), (9, (-110, -7)),
    (-1, None), (5, (-1024, 1023)),
])
def test_peak_filter_matches_jax(flen, window):
    """The carrier peak filter (auto and odd lengths; a window crossing
    DC, a negative one, the full range and a wrapped full-span window)
    against JAX's XLA program."""
    cap = capture(-37.6 if window == (-110, -7) else 40.25, False)
    got = compare(cap, use_pallas="off", peak_filter_len=flen,
                  carrier_window=window)
    assert got["carrier_detect"].any()


@pytest.mark.parametrize("kw", [dict(), dict(gate_capacity=12),
                                dict(sync_mode="integer",
                                     carrier_thresh=(0.0, 15.0, 2.0))])
def test_peak_filter_one_reduction_per_batch(kw, monkeypatch):
    """With a peak filter the carrier search is torch ops: exactly one
    power/peak call per batch (the correlation's); the gate's
    correlation runs on the compacted rows."""
    cap = capture(40.25, False)
    calls = []
    orig = pp.fused_power_peak

    def spy(x, mask, stats_mask=None, layout="interleaved"):
        calls.append(tuple(x.shape))
        return orig(x, mask, stats_mask=stats_mask, layout=layout)

    monkeypatch.setattr(pp, "fused_power_peak", spy)
    jdet, tdet = pair("off", peak_filter_len=-1, **kw)
    got = tdet(cap.blocks)
    monkeypatch.setattr(pp, "fused_power_peak", orig)
    assert calls == [(kw.get("gate_capacity", len(cap.blocks)), BLOCK)]
    assert_outputs_match(got, jdet(cap.blocks))


@pytest.mark.parametrize("n,batch", [(2048, 8), (3000, 4), (65536, 2)])
def test_maximise_matches_jax(n, batch):
    """The golden-section search against JAX's on the spectra of noisy
    peaks at lags across the whole block: power-of-two n where k*p
    wraps uint32 (65536) and a non-power-of-two n.  atol 1e-3 (TOLS):
    near its maximum the float32 objective is flat to ~5e-4 samples,
    where the two libraries' sums round differently."""
    rng = np.random.default_rng(n)
    k = np.fft.fftfreq(n) * n
    idx = np.linspace(0, n - 1, batch).astype(np.int32)
    frac = rng.uniform(-0.5, 0.5, batch)
    spec = 64 * np.exp(-2j * np.pi * k * (idx + frac)[:, None] / n)
    spec = (spec + 0.5 * (rng.normal(size=spec.shape)
                          + 1j * rng.normal(size=spec.shape))).astype(
        np.complex64)
    ref = np.asarray(jxc.make_maximise_interpolator()(spec, idx))
    got = xcorr.make_maximise_interpolator()(torch.from_numpy(spec),
                                             torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got, frac, atol=1e-3)


def neighbourhoods(shape, k, seed=0):
    """Peaked magnitude neighbourhoods [.., k] plus degenerate rows
    (flat, zero, one-sided)."""
    rng = np.random.default_rng(seed)
    x = np.arange(k) - k // 2
    off = rng.uniform(-0.6, 0.6, shape)
    y = np.exp(-0.3 * (x - off[..., None]) ** 2) * rng.uniform(
        1, 100, shape)[..., None]
    y = (y + rng.uniform(0, 0.05, y.shape)).astype(np.float32)
    flat = y.reshape(-1, k)
    flat[0] = 1.0
    flat[1] = 0.0
    flat[2, :k // 2] = 0.0
    return y


@pytest.mark.parametrize("name", ["parabolic", "gaussian", "cosine",
                                  "polyfit", "dirichlet"])
def test_carrier_interpolators_match_jax(name):
    width = 6
    k = width + 1 if name in ("polyfit", "dirichlet") else 3
    y = neighbourhoods((64,), k)
    idx = np.zeros(64, np.int32)
    ref = {"parabolic": lambda v: jdir.parabolic_interpolate(
               None, idx, values=v),
           "gaussian": lambda v: jdir.gaussian_interpolate(
               None, idx, values=v),
           "cosine": lambda v: jdir.cosine_interpolate(None, idx, values=v),
           "polyfit": lambda v: jdir.make_polyfit_interpolator(width)(
               None, idx, values=v),
           "dirichlet": lambda v: jdir.make_dirichlet_interpolator(
               BLOCK, 62, width)(None, idx, values=v)}[name](y)
    if name == "polyfit":
        # A flat row leaves a2 = float32 rounding noise over 1e-30.
        y, ref = y[1:], np.asarray(ref)[1:]
    port = {"parabolic": dirichlet.parabolic_interpolate,
            "gaussian": dirichlet.gaussian_interpolate,
            "cosine": dirichlet.cosine_interpolate,
            "polyfit": dirichlet.make_polyfit_interpolator(width),
            "dirichlet": dirichlet.make_dirichlet_interpolator(
                BLOCK, 62, width)}[name]
    np.testing.assert_allclose(port(torch.from_numpy(y)).numpy(),
                               np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name", ["gaussian", "parabolic", "cosine",
                                  "none", "autocorr", "autocorr_bank"])
def test_corr_interpolators_match_jax(name):
    """Correlation interpolators on [.., 2*half+1] neighbourhoods with
    the bounds check (peaks at both edges of ``length``)."""
    from thrifty_tpu.dsp import template as template_mod

    bank = template_mod.generate_bank(5, [0, 1, 2], 2.0)
    length = 1000
    if name.startswith("autocorr"):
        tmpl = bank if name == "autocorr_bank" else TPL
        shape = (16, 3) if name == "autocorr_bank" else (48,)
        table, dtable = (torch.from_numpy(t) for t in
                         xcorr.autocorr_tables(tmpl))
        port = xcorr.make_autocorr_interpolator(table, dtable, clip=0.6)
        jfn = jxc.make_autocorr_interpolator(tmpl, clip=0.6)
        k = 5
    else:
        port = getattr(xcorr, name + "_interpolate")
        jfn = getattr(jxc, name + "_interpolate")
        shape, k = (48,), 3
    y = neighbourhoods(shape, k, seed=1)
    idx = np.random.default_rng(2).integers(0, length, shape).astype(
        np.int32)
    idx.reshape(-1)[:4] = [0, 1, length - 2, length - 1]
    ref = jfn(None, idx, values=y, length=length)
    got = port(None, torch.from_numpy(idx), values=torch.from_numpy(y),
               length=length)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# -- the port's CLI against the reference goldens -------------------------


@pytest.fixture(scope="module")
def rerun(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_golden_interp")
    common = ["--carrier-window", "7-110", "--quiet", "--rxid", "0",
              "--template", os.path.join(gi.INPUT, "template.npy"),
              "--device", "cpu"]
    for name, (extra, _) in gi.CASES.items():
        assert main(["detect", os.path.join(gi.INPUT, "rx0.card"),
                     "-o", str(d / (name + ".toad"))]
                    + common + extra) == 0, name
    return d


@pytest.mark.parametrize("name", sorted(gi.CASES))
def test_cli_matches_reference_interp_goldens(rerun, name):
    """tests/test_golden_interp.py's check, on the port's CLI."""
    gi.test_experimental_surface_matches_reference(rerun, name)


def test_cli_emit_txid_matches_jax_cli(tmp_path):
    """A 2-D template file is a bank; --emit-txid writes the winning
    template as the txid column, as the JAX CLI does; without a bank it
    is a usage error."""
    from thrifty_tpu import sim
    from thrifty_tpu.cli import main as jax_main
    from thrifty_tpu.dsp import iq
    from thrifty_tpu.dsp import template as template_mod
    from thrifty_tpu.io import card

    bank = template_mod.generate_bank(5, [0, 1, 2], 2.0)
    np.save(tmp_path / "bank.npy", bank)
    cap = sim.synth_capture(num_blocks=12, bursts_every=3,
                            template=bank[2], block_len=BLOCK,
                            history_len=HISTORY, carrier_bin=40.25,
                            amplitude=0.8, noise_std=0.05, seed=6)
    card.write_card(str(tmp_path / "in.card"), cap.timestamps, cap.indices,
                    iq.iq_to_raw(cap.blocks))
    args = [str(tmp_path / "in.card"), "--emit-txid", "--quiet",
            "--template", str(tmp_path / "bank.npy"), "--block-size",
            str(BLOCK), "--history", str(HISTORY), "--carrier-window",
            "7-110", "--batch-size", "8", "--sync-mode", "preshift"]
    assert main(["detect"] + args + ["-o", str(tmp_path / "p.toads"),
                                     "--device", "cpu"]) == 0
    assert jax_main(["detect"] + args + ["-o", str(tmp_path / "j.toads")]) \
        == 0
    got = np.atleast_2d(np.loadtxt(tmp_path / "p.toads"))
    ref = np.atleast_2d(np.loadtxt(tmp_path / "j.toads"))
    assert got.shape == ref.shape and got.shape[0] == len(cap.bursts)
    np.testing.assert_array_equal(got[:, 1], 2)
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=1e-3)
    np.save(tmp_path / "one.npy", bank[0])
    with pytest.raises(SystemExit):
        main(["detect", str(tmp_path / "in.card"), "--emit-txid",
              "--template", str(tmp_path / "one.npy"), "--device", "cpu"])
