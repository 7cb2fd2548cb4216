"""The port's transform family (thrifty_tpu_torch/dsp/mxu_fft.py) on the
CPU against JAX ``mxu_fft`` and the float64 numpy oracle, case for case
of tests/test_mxu_fft.py.

Every input is made with numpy from a seed and handed to both sides as
complex64 / float32 arrays.  Tolerances are JAX's own bounds against the
oracle, relative to the largest output: 2e-5 for the transforms and the
windowed DFT, 2e-6 for the separable ramp, 4e-6 for its matmul3 form,
1e-5 for the full ramp; the port and JAX run the same algorithm in
float32 with different GEMMs, so they are held to each other within the
same bound.  The constants are bit-equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from thrifty_tpu.dsp import mxu_fft as jfft  # noqa: E402
from thrifty_tpu.dsp import shift as jshift  # noqa: E402
from thrifty_tpu_torch.dsp import mxu_fft, shift  # noqa: E402


def rand(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n))
            + 1j * rng.normal(size=(b, n))).astype(np.complex64)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def port(fn, x, *args, **kw):
    out = fn(torch.from_numpy(np.ascontiguousarray(x)), *args, **kw)
    assert out.dtype == torch.complex64
    return out.numpy()


def held(got, jax_out, oracle, bound):
    """Port within ``bound`` of the oracle and of JAX on the same input."""
    assert got.shape == np.shape(oracle)
    assert rel_err(got, oracle) < bound, rel_err(got, oracle)
    assert rel_err(got, jax_out) < bound, rel_err(got, jax_out)


# -- constants ---------------------------------------------------------------

@pytest.mark.parametrize("n,inverse", [(64, False), (2048, True)])
def test_dft_matrix_bit_equal(n, inverse):
    np.testing.assert_array_equal(
        mxu_fft._dft_matrix(n, inverse).view(np.uint32),
        jfft._dft_matrix(n, inverse).view(np.uint32))


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_consts_bit_equal(inverse):
    for got, ref in zip(mxu_fft._four_step_consts(128, 128, inverse),
                        jfft._four_step_consts(128, 128, inverse)):
        assert got.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.mark.parametrize("n,dense", [(1024, False), (16384, True),
                                     (16384, False), (6000, False)])
def test_windowed_consts_bit_equal(n, dense):
    sel = tuple(int(s) for s in np.arange(-10, 11) % n)
    for got, ref in zip(mxu_fft._windowed_consts(n, sel, False, dense),
                        jfft._windowed_consts(n, sel, False, dense)):
        if ref is None:
            assert got is None
            continue
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      ref.view(np.uint8))


def test_split_and_limits_match_jax():
    assert mxu_fft._DFT_MAX == jfft._DFT_MAX
    assert mxu_fft.WINDOWED_DENSE_MAX_ELEMS == jfft.WINDOWED_DENSE_MAX_ELEMS
    for n in (2048, 4096, 6000, 16384, 32768, 128 * 2048, 128 * 2049):
        assert mxu_fft._split(n) == jfft._split(n), n


# -- full transforms ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("n", [64, 256, 2048, 4096, 16384])
def test_fft_matches_jax_and_oracle(n, impl):
    x = rand(3, n, seed=n)
    held(port(mxu_fft.fft, x, impl=impl), jfft.fft(x, impl=impl),
         np.fft.fft(x.astype(np.complex128)), 2e-5)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("n", [256, 4096, 16384])
def test_ifft_matches_jax_and_oracle(n, impl):
    x = rand(2, n, seed=n + 1)
    held(port(mxu_fft.ifft, x, impl=impl), jfft.ifft(x, impl=impl),
         np.fft.ifft(x.astype(np.complex128)), 2e-5)


def test_roundtrip():
    x = rand(2, 16384, seed=7)
    back = mxu_fft.ifft(mxu_fft.fft(torch.from_numpy(x), "matmul"),
                        "matmul").numpy()
    assert np.max(np.abs(back - x)) < 1e-4


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_auto_and_xla_are_torch_fft(impl):
    """'auto' is torch.fft on every device: the default path keeps its
    numerics bit for bit (the goldens rely on them)."""
    t = torch.from_numpy(rand(2, 1024, seed=3))
    assert torch.equal(mxu_fft.fft(t, impl), torch.fft.fft(t))
    assert torch.equal(mxu_fft.ifft(t, impl), torch.fft.ifft(t))


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
def test_unfactorable_size_falls_back(impl):
    x = rand(1, 6000, seed=4)  # 6000: not 128-divisible, > _DFT_MAX
    held(port(mxu_fft.fft, x, impl=impl), jfft.fft(x, impl=impl),
         np.fft.fft(x.astype(np.complex128)), 2e-5)


@pytest.mark.parametrize("call", [
    lambda x: mxu_fft.fft(x, impl="fast"),
    lambda x: mxu_fft.fft_ramped(x, torch.zeros(1), impl="fast"),
    lambda x: mxu_fft.windowed_dft(x, [1], impl="fast"),
])
def test_bad_impl_rejected(call):
    with pytest.raises(ValueError, match="unknown fft impl 'fast': "
                                         "expected 'auto', 'matmul', "
                                         "'matmul3' or 'xla'"):
        call(torch.from_numpy(rand(1, 64)))
    with pytest.raises(ValueError, match="unknown fft impl"):
        jfft.fft(rand(1, 64), impl="fast")


def test_leading_dims():
    x = rand(6, 16384, seed=9).reshape(2, 3, 16384)
    held(port(mxu_fft.fft, x, impl="matmul"), jfft.fft(x, impl="matmul"),
         np.fft.fft(x.astype(np.complex128)), 2e-5)


# -- windowed DFT ------------------------------------------------------------

WINDOWS = [(16384, np.arange(7, 111)),            # the carrier window
           (16384, np.arange(-10, 11) % 16384),   # wrapped
           (1024, np.arange(3, 40))]              # dense-matrix path


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("n,sel", WINDOWS)
def test_windowed_dft_matches_jax_and_oracle(n, sel, impl):
    x = rand(3, n, seed=n + len(sel))
    held(port(mxu_fft.windowed_dft, x, sel, impl=impl),
         jfft.windowed_dft(x, sel, impl=impl),
         np.fft.fft(x.astype(np.complex128))[:, sel], 2e-5)


@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
def test_windowed_dft_factorized(monkeypatch, impl):
    """The factorized form (the four-step's column transform plus a W-bin
    combine), pinned on both sides with the dense limit at 0."""
    monkeypatch.setattr(mxu_fft, "WINDOWED_DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(jfft, "WINDOWED_DENSE_MAX_ELEMS", 0)
    x = rand(3, 16384, seed=33).reshape(3, 1, 16384)
    sel = np.arange(-10, 30) % 16384
    held(port(mxu_fft.windowed_dft, x, sel, impl=impl),
         jfft.windowed_dft(x, sel, impl=impl),
         np.fft.fft(x.astype(np.complex128))[..., sel], 2e-5)


def test_windowed_xla_impl_is_exact_take():
    t = torch.from_numpy(rand(2, 2048, seed=12))
    sel = np.arange(5, 50)
    assert torch.equal(mxu_fft.windowed_dft(t, sel, impl="xla"),
                       torch.fft.fft(t)[:, sel])


def test_windowed_out_of_range_bins_rejected():
    with pytest.raises(ValueError, match="out of range for n=256"):
        mxu_fft.windowed_dft(torch.from_numpy(rand(1, 256)),
                             np.asarray([256]), impl="matmul")


def test_windowed_leading_dims():
    x = rand(6, 16384, seed=2).reshape(2, 3, 16384)
    sel = np.arange(7, 111)
    got = port(mxu_fft.windowed_dft, x, sel, impl="matmul")
    assert got.shape == (2, 3, len(sel))
    held(got, jfft.windowed_dft(x, sel, impl="matmul"),
         np.fft.fft(x.astype(np.complex128))[..., sel], 2e-5)


# -- head-trimmed inverse ----------------------------------------------------

@pytest.mark.parametrize("impl", ["matmul", "matmul3"])
@pytest.mark.parametrize("n,m", [(16384, 11471), (16384, 16384),
                                 (1024, 100), (256, 1)])
def test_ifft_head_equals_sliced_ifft(n, m, impl):
    """Same dot products minus the discarded outputs: 1e-6 of the full
    inverse (JAX's bound), and within 2e-5 of the oracle and JAX."""
    x = rand(2, n, seed=n + m)
    head = port(mxu_fft.ifft_head, x, m, impl=impl)
    assert head.shape == (2, m)
    full = port(mxu_fft.ifft, x, impl=impl)[..., :m]
    assert np.max(np.abs(head - full)) < 1e-6
    held(head, jfft.ifft_head(x, m, impl),
         np.fft.ifft(x.astype(np.complex128))[..., :m], 2e-5)


def test_ifft_head_xla_is_exact_slice():
    t = torch.from_numpy(rand(2, 6000, seed=3))
    assert torch.equal(mxu_fft.ifft_head(t, 123, "xla"),
                       torch.fft.ifft(t)[..., :123])


# -- precision ---------------------------------------------------------------

@pytest.mark.parametrize("prec", ["high", "default"])
def test_precisions_run_in_float32_on_the_cpu(prec):
    """On the CPU every precision computes in float32: within the
    'highest' bound of the oracle, and equal to 'highest'."""
    x = rand(2, 16384, seed=8)
    got = port(mxu_fft.fft, x, "matmul", prec)
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-5
    np.testing.assert_array_equal(got, port(mxu_fft.fft, x, "matmul"))


@pytest.mark.parametrize("call", [
    lambda x: mxu_fft.fft(x, "matmul", "quad"),
    lambda x: mxu_fft.ifft_head(x, 3, "auto", "quad"),
    lambda x: mxu_fft.windowed_dft(x, [1], "matmul", "quad"),
    lambda x: mxu_fft.fft_ramped(x, torch.zeros(1), "matmul", "quad"),
])
def test_bad_precision_rejected(call):
    with pytest.raises(ValueError, match=r"unknown fft precision 'quad': "
                                         r"expected one of \['default', "
                                         r"'high', 'highest'\]"):
        call(torch.from_numpy(rand(1, 256)))
    with pytest.raises(ValueError, match="unknown fft precision"):
        jfft.fft(rand(1, 256), "matmul", "quad")


# -- separable ramp ----------------------------------------------------------

def ramp_oracle(x, s):
    n = x.shape[-1]
    pos = np.arange(n) / n - 0.5
    return np.fft.fft(x.astype(np.complex128)
                      * np.exp(2j * np.pi * s.astype(np.float64)[:, None]
                               * pos), axis=-1)


def ramped(x, s, impl, **kw):
    return mxu_fft.fft_ramped(torch.from_numpy(x), torch.from_numpy(s),
                              impl, **kw).numpy()


def test_separable_ramp_matches_oracle():
    """Within 2e-6 of the oracle and closer to it than the full float32
    ramp through the same transform, as in JAX."""
    rng = np.random.default_rng(5)
    x = rand(4, 16384, seed=15)
    s = rng.uniform(-110, 110, 4).astype(np.float32)
    ref = ramp_oracle(x, s)
    got = ramped(x, s, "matmul")
    sep_err = rel_err(got, ref)
    assert sep_err < 2e-6, sep_err
    full = ramped(x, s, "matmul", separable=False)
    assert sep_err < rel_err(full, ref)
    held(got, jfft.fft_ramped(jnp.asarray(x), jnp.asarray(s), "matmul"),
         ref, 2e-6)


def test_separable_ramp_edge_shifts():
    """Half-integer rounding boundaries, zero, negatives."""
    s = np.array([0.0, -0.5, 0.5, 109.5, -109.5, 37.25, -0.49999, 3.0],
                 np.float32)
    x = rand(8, 16384, seed=6)
    held(ramped(x, s, "matmul"),
         jfft.fft_ramped(jnp.asarray(x), jnp.asarray(s), "matmul"),
         ramp_oracle(x, s), 2e-6)


@pytest.mark.parametrize("n,impl", [(1024, "matmul"), (16384, "xla"),
                                    (16384, "auto")])
def test_ramp_fallback_paths(n, impl):
    """xla/auto and non-four-step sizes take the full ramp."""
    rng = np.random.default_rng(7)
    x = rand(3, n, seed=n)
    s = rng.uniform(-20, 20, 3).astype(np.float32)
    held(ramped(x, s, impl),
         jfft.fft_ramped(jnp.asarray(x), jnp.asarray(s), impl),
         ramp_oracle(x, s), 1e-5)


def test_separable_ramp_matmul3():
    rng = np.random.default_rng(8)
    x = rand(3, 16384, seed=18)
    s = rng.uniform(-110, 110, 3).astype(np.float32)
    held(ramped(x, s, "matmul3"),
         jfft.fft_ramped(jnp.asarray(x), jnp.asarray(s), "matmul3"),
         ramp_oracle(x, s), 4e-6)


def test_fractional_shift_ramp_choice():
    """shift.fractional_shift_fft takes the separable ramp on the
    four-step path, as JAX's does under ramp='separable'."""
    x = rand(2, 16384, seed=19)
    s = np.array([40.25, -37.6], np.float32)
    got = shift.fractional_shift_fft(torch.from_numpy(x),
                                     torch.from_numpy(s), "matmul")
    assert torch.equal(got, mxu_fft.fft_ramped(
        torch.from_numpy(x), torch.from_numpy(s), "matmul", separable=True))
    ref = jshift.fractional_shift_fft(jnp.asarray(x), jnp.asarray(s),
                                      "matmul", ramp="separable")
    held(got.numpy(), ref, ramp_oracle(x, s), 2e-6)
