"""The port's DSP modules against their JAX counterparts, on the CPU.

Every input is made with numpy from a seed and handed to both sides as
explicit complex64 / float32 arrays (the test session enables JAX's
float64 mode, which would otherwise widen them on the JAX side).
Tolerances are stated per test; host-side numpy helpers are bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thrifty_tpu.dsp import carrier as jcarrier  # noqa: E402
from thrifty_tpu.dsp import dirichlet as jdirichlet  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp import mxu_fft  # noqa: E402
from thrifty_tpu.dsp import shift as jshift  # noqa: E402
from thrifty_tpu.dsp import template as template_mod  # noqa: E402
from thrifty_tpu.dsp import xcorr as jxcorr  # noqa: E402
from thrifty_tpu_torch.dsp import carrier, dirichlet, iq, shift, \
    xcorr  # noqa: E402
from thrifty_tpu_torch.dsp import fft as tfft  # noqa: E402

N = 2048


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


# -- ingest ------------------------------------------------------------------

def test_raw_to_iq_bit_equal():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(4, 2 * N), dtype=np.uint8)
    raw[0, :256] = np.arange(256)  # every byte value
    got = iq.raw_to_iq(torch.from_numpy(raw)).numpy()
    assert got.dtype == np.complex64 and got.shape == (4, N)
    np.testing.assert_array_equal(bits(got.view(np.float32)),
                                  bits(jiq.raw_to_iq(raw).view(np.float32)))
    dev = np.asarray(jiq.raw_to_iq_jax(jnp.asarray(raw)))
    np.testing.assert_array_equal(bits(got.view(np.float32)),
                                  bits(dev.view(np.float32)))


def test_raw_to_iq_rejects_odd_width():
    with pytest.raises(ValueError, match="uint8"):
        iq.raw_to_iq(torch.zeros((2, 7), dtype=torch.uint8))


def test_iq_to_raw_bit_equal():
    # Exact: both sides quantise the same float32 values the same way.
    rng = np.random.default_rng(1)
    x = cplx(rng, (3, N), scale=0.5)
    x[0, :4] = [2.0 + 2.0j, -2.0 - 2.0j, 0.0, 0.3 - 0.7j]  # clipped, DC
    got = iq.iq_to_raw(x)
    assert got.dtype == np.uint8 and got.shape == (3, 2 * N)
    np.testing.assert_array_equal(got, jiq.iq_to_raw(x))


# -- transforms --------------------------------------------------------------

def fft_close(got, ref):
    """float32 FFTs of two libraries: within 2e-6 of the largest bin."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * np.max(np.abs(ref)))


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_matches_xla(inverse):
    x = cplx(np.random.default_rng(1), (4, N))
    t = torch.from_numpy(x)
    if inverse:
        got, ref = tfft.ifft(t), mxu_fft.ifft(x, impl="xla")
    else:
        got, ref = tfft.fft(t), mxu_fft.fft(x, impl="xla")
    assert got.dtype == torch.complex64
    fft_close(got.numpy(), ref)


@pytest.mark.parametrize("shifts", [(40.25, -37.6, 0.0, 0.5),
                                    (-1000.3, 1000.7, -0.49, 7.0)])
def test_fft_ramped_matches_full_ramp(shifts):
    """The full-ramp branch of mxu_fft.fft_ramped, shift by shift: the
    phase is rounded the same way, so only cos/sin and FFT rounding
    differ (2e-6 of the largest bin)."""
    x = cplx(np.random.default_rng(2), (4, N))
    s = np.asarray(shifts, dtype=np.float32)
    got = tfft.fft_ramped(torch.from_numpy(x), torch.from_numpy(s))
    ref = mxu_fft.fft_ramped(x, jnp.asarray(s), impl="xla",
                             separable=False)
    fft_close(got.numpy(), ref)
    via_shift = jshift.fractional_shift_fft(x, jnp.asarray(s), impl="xla",
                                            ramp="full")
    fft_close(shift.fractional_shift_fft(
        torch.from_numpy(x), torch.from_numpy(s)).numpy(), via_shift)


# -- carrier -----------------------------------------------------------------

@pytest.mark.parametrize("window", [None, (7, 110), (-110, -7), (-10, 10),
                                    (0, -1), (110, 7)])
def test_window_mask_bit_equal(window):
    np.testing.assert_array_equal(carrier.window_mask(window, N),
                                  jcarrier.window_mask(window, N))
    w = window or (0, -1)
    np.testing.assert_array_equal(
        carrier.fft_window_indices(w[0], w[1], N),
        jcarrier.fft_window_indices(w[0], w[1], N))


def test_window_out_of_range_raises():
    with pytest.raises(ValueError, match="out of range"):
        carrier.window_mask((0, N), N)


def test_noise_and_threshold_signed_variance():
    """Includes carriers holding more than half the energy (negative
    variance: the threshold follows the signed value).  rtol 1e-6."""
    rng = np.random.default_rng(3)
    energy = rng.uniform(1e3, 1e5, size=64).astype(np.float32)
    peak = (energy * rng.uniform(0.0, 0.9, size=64)).astype(np.float32)
    coeffs = (1.5, 15.0, 0.0)
    got = carrier.noise_and_threshold_sq(
        torch.from_numpy(energy), torch.from_numpy(peak), N, coeffs)
    ref = jcarrier.noise_and_threshold_sq(
        jnp.asarray(energy), jnp.asarray(peak), N, coeffs)
    assert np.any(np.asarray(ref[1]) < 0)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


# -- correlation constants and helpers --------------------------------------

def test_template_constants_bit_equal():
    tpl = template_mod.generate(5, 0, 2.0)
    np.testing.assert_array_equal(xcorr.corr_window(N, 256, len(tpl)),
                                  jxcorr.corr_window(N, 256, len(tpl)))
    got = xcorr.template_fft_conj(tpl, N)
    ref = jxcorr.template_fft_conj(tpl, N)
    assert got.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(bits(got.view(np.float32)),
                                  bits(ref.view(np.float32)))
    np.testing.assert_array_equal(xcorr.template_energy(tpl),
                                  jxcorr.template_energy(tpl))


def test_corr_window_needs_history():
    with pytest.raises(ValueError, match="history_len"):
        xcorr.corr_window(N, 10, 100)


def test_despread_and_noise_rms():
    """Elementwise float32 products: equal to 1 ulp-level (rtol 1e-6)."""
    rng = np.random.default_rng(4)
    a, b = cplx(rng, (4, N)), cplx(rng, (N,))
    np.testing.assert_allclose(
        xcorr.despread_spec(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jxcorr.despread_spec(a, b)), rtol=1e-6)
    peak = rng.uniform(1, 50, 16).astype(np.float32)
    energy = rng.uniform(1e3, 1e4, 16).astype(np.float32)
    e_t = np.float32(123.5)
    got = xcorr.noise_rms(torch.from_numpy(peak), torch.from_numpy(energy),
                          torch.tensor(e_t), N)
    ref = jxcorr.noise_rms(jnp.asarray(peak), jnp.asarray(energy),
                           jnp.asarray(e_t), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_gather_neighborhood_wraps():
    rng = np.random.default_rng(5)
    x = cplx(rng, (6, 64))
    idx = np.array([0, 1, 30, 62, 63, 5], dtype=np.int32)
    offs = np.arange(-3, 4)
    got = dirichlet.gather_neighborhood(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(offs))
    ref = jdirichlet.gather_neighborhood(jnp.asarray(x), jnp.asarray(idx),
                                         jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def gaussian_neighbourhoods(rng, m):
    centre = rng.uniform(1.0, 100.0, m)
    frac = rng.uniform(-0.6, 0.6, m)
    xs = np.arange(-1, 2)
    y = centre[:, None] * np.exp(-0.3 * (xs - frac[:, None]) ** 2)
    y[0] = [1.0, 1.0, 1.0]          # flat: the denominator guard
    y[1] = [0.0, 5.0, 0.0]          # zero magnitudes: the log guard
    return y.astype(np.float32)


def test_gaussian_interpolate_on_same_neighbourhoods():
    """Same [..., 3] neighbourhoods and bounds; rtol 1e-5, atol 1e-6
    (float32 log of the same inputs)."""
    rng = np.random.default_rng(6)
    y = gaussian_neighbourhoods(rng, 64)
    length = 500
    idx = rng.integers(0, length, 64).astype(np.int32)
    idx[2:6] = [0, 1, length - 2, length - 1]  # bounds check edges
    got = xcorr.gaussian_interpolate(None, torch.from_numpy(idx), clip=0.6,
                                     values=torch.from_numpy(y),
                                     length=length)
    ref = jxcorr.gaussian_interpolate(None, jnp.asarray(idx), clip=0.6,
                                      values=jnp.asarray(y), length=length)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert got[2] == 0 and got[5] == 0 and got[3] != 0


def test_gaussian_interpolate_gathers():
    """Without ``values`` the neighbourhood is gathered with clipped
    indices, as the JAX path does."""
    rng = np.random.default_rng(7)
    mag = rng.uniform(0.1, 1.0, (8, 100)).astype(np.float32)
    idx = np.array([0, 1, 50, 98, 99, 2, 3, 97], dtype=np.int32)
    got = xcorr.gaussian_interpolate(torch.from_numpy(mag),
                                     torch.from_numpy(idx))
    ref = jxcorr.gaussian_interpolate(jnp.asarray(mag), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# -- Dirichlet sub-bin fit ---------------------------------------------------

@pytest.mark.parametrize("fn", ["dirichlet_kernel", "dirichlet_kernel_deriv"])
def test_dirichlet_kernel_matches(fn):
    """float32 sin/cos of two libraries: rtol 2e-5, atol 1e-7."""
    x = np.concatenate([np.linspace(-3.5, 3.5, 141),
                        [0.0, 5e-3, -5e-3, 1e-2]]).astype(np.float32)
    got = getattr(dirichlet, fn)(torch.from_numpy(x), N, 1100)
    ref = getattr(jdirichlet, fn)(jnp.asarray(x), N, 1100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=1e-7)


def test_dirichlet_fit_on_same_neighbourhoods():
    """Seven-point |A*D(x - delta)| neighbourhoods with noise, the same
    float32 values on both sides.  Twelve float32 Gauss-Newton steps
    can amplify last-bit differences of sin/cos; the fitted offsets
    agree to 1e-5 bins (the .toad comparison allows 2e-3)."""
    rng = np.random.default_rng(8)
    m, tlen = 256, 1100
    delta = rng.uniform(-0.5, 0.5, m)
    amp = rng.uniform(10.0, 1000.0, m)
    xs = np.arange(-3, 4)
    clean = amp[:, None] * np.abs(jdirichlet.dirichlet_kernel(
        xs[None, :] - delta[:, None], N, tlen))
    y = (clean + rng.normal(scale=0.02, size=clean.shape)
         * amp[:, None]).astype(np.float32)
    y = np.abs(y)
    got = dirichlet.make_dirichlet_interpolator(N, tlen)(torch.from_numpy(y))
    ref = jdirichlet.make_dirichlet_interpolator(N, tlen)(
        None, None, values=jnp.asarray(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert np.max(np.abs(got.numpy() - delta)) < 0.2
