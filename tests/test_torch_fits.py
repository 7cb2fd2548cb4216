"""The detector's three iterative fits: the Dirichlet carrier fit, the
autocorr fit and the maximise search.

On the CPU each wrapper takes its plain PyTorch version (the eager loop),
held here against the JAX package's compiled loop on the same float32
inputs, made from a seed with numpy.  Tolerances: the Dirichlet and
autocorr offsets atol 1e-5 (twelve / ten float32 Gauss-Newton steps
amplify last-bit differences of sin/cos and of the sums); maximise atol
1e-3 (near its maximum the float32 objective is flat to ~5e-4 samples,
where the two libraries' sums round differently).

Tests marked ``cuda`` hold each hand-written kernel (``csrc/fits.cu``)
against its plain version on the card, at the detect path's shapes and
on edge rows, with the same tolerances, and skip where there is no card.
The JAX package is imported inside the CPU tests only, so the card tests
also run on a machine without it: ``python -m pytest --noconftest -m
cuda tests/test_torch_fits.py``.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import _build  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet, fits_lib, xcorr  # noqa: E402
from thrifty_tpu_torch.dsp import template as template_mod  # noqa: E402

BLOCK, TLEN = 16384, 4914       # the deployment's block and template length
TEMPLATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "input", "template.npy")
FIT_ATOL = 1e-5
MAXIMISE_ATOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def dirichlet_rows(rows, points, seed=0):
    """[rows, points] float32 carrier magnitudes |A*D(x - delta)| with
    noise, then the edge rows: all zero (a gate's filler), flat, and
    one-sided ramps that drive delta onto the +-1 clamp."""
    rng = np.random.default_rng(seed)
    half = points // 2
    x = np.arange(-half, half + 1)
    delta = rng.uniform(-0.5, 0.5, rows)
    amp = rng.uniform(10.0, 1000.0, rows)
    u = x[None, :] - delta[:, None]
    a = math.pi / BLOCK
    safe = np.where(u == 0, 1.0, np.sin(a * u))
    d = np.where(u == 0, 1.0, np.sin(a * TLEN * u) / (TLEN * safe))
    y = np.abs(amp[:, None] * np.abs(d) + rng.normal(
        scale=0.02, size=d.shape) * amp[:, None])
    y[rows // 4] = amp[rows // 4] * np.abs(d[rows // 4])  # clean
    y[0] = 0.0
    y[1] = 5.0
    y[2] = 3.0 ** np.arange(points)        # rising: clamps at +1
    y[3] = y[2][::-1]                      # falling: clamps at -1
    return y.astype(np.float32)


def gold_template():
    return template_mod.generate_bank(5, [0], 2.0)[0]


def autocorr_rows(shape, seed=0):
    """Peaked [.., 5] correlation magnitudes plus a zero and a flat
    row."""
    rng = np.random.default_rng(seed)
    x = np.arange(5) - 2
    off = rng.uniform(-0.6, 0.6, shape)
    y = np.exp(-0.3 * (x - off[..., None]) ** 2) * rng.uniform(
        1, 100, shape)[..., None]
    y = (y + rng.uniform(0, 0.05, y.shape)).astype(np.float32)
    flat = y.reshape(-1, 5)
    flat[0] = 0.0
    flat[1] = 1.0
    return y


def maximise_spectra(n, rows, seed=0):
    """Spectra of noisy correlation peaks at lags across the block and
    their true fractional offsets."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n) * n
    idx = np.linspace(0, n - 1, rows).astype(np.int32)
    frac = rng.uniform(-0.5, 0.5, rows)
    spec = 64 * np.exp(-2j * np.pi * k * (idx + frac)[:, None] / n)
    spec = (spec + 0.5 * (rng.normal(size=spec.shape)
                          + 1j * rng.normal(size=spec.shape))).astype(
        np.complex64)
    return spec, idx, frac


# -- the plain versions against JAX (CPU) -------------------------------------

@pytest.mark.parametrize("width", [4, 6])
def test_dirichlet_fit_matches_jax(width):
    """Clean, noisy, zero, flat and clamped rows at interp_width 4 and 6."""
    jdir = pytest.importorskip("thrifty_tpu.dsp.dirichlet")
    y = dirichlet_rows(64, width + 1, seed=width)
    got = dirichlet.make_dirichlet_interpolator(BLOCK, TLEN, width)(
        torch.from_numpy(y)).numpy()
    ref = np.asarray(jdir.make_dirichlet_interpolator(BLOCK, TLEN, width)(
        None, None, values=y))
    np.testing.assert_allclose(got, ref, atol=FIT_ATOL)
    assert got[0] == 0.0 and got[2] == 1.0 and got[3] == -1.0


@pytest.mark.parametrize("bank", [False, True])
def test_autocorr_fit_matches_jax(bank):
    """One template and a [3, M] bank (row t of the tables serves
    template t), the bounds check at both edges of ``length``."""
    jxc = pytest.importorskip("thrifty_tpu.dsp.xcorr")
    tmpl = template_mod.generate_bank(5, [0, 1, 2], 2.0) if bank \
        else gold_template()
    shape = (16, 3) if bank else (48,)
    table, dtable = (torch.from_numpy(t) for t in
                     xcorr.autocorr_tables(tmpl))
    y = autocorr_rows(shape, seed=int(bank))
    length = 1000
    idx = np.random.default_rng(2).integers(2, length - 2, shape).astype(
        np.int32)
    idx.reshape(-1)[2:4] = [0, length - 1]
    got = xcorr.make_autocorr_interpolator(table, dtable, clip=0.6)(
        None, torch.from_numpy(idx), values=torch.from_numpy(y),
        length=length).numpy()
    ref = np.asarray(jxc.make_autocorr_interpolator(tmpl, clip=0.6)(
        None, idx, values=y, length=length))
    np.testing.assert_allclose(got, ref, atol=FIT_ATOL)
    fit = xcorr.autocorr_fit(torch.from_numpy(y), table, dtable).numpy()
    inside = (idx >= 2) & (idx < length - 2)
    np.testing.assert_array_equal(got[inside], fit[inside])
    assert np.all(got[~inside] == 0.0)


@pytest.mark.parametrize("n", [1024, 1000])
def test_maximise_search_matches_jax(n):
    """A power-of-two n and one that is not."""
    jxc = pytest.importorskip("thrifty_tpu.dsp.xcorr")
    spec, idx, frac = maximise_spectra(n, 6, seed=n)
    got = xcorr.maximise_search(torch.from_numpy(spec),
                                torch.from_numpy(idx)).numpy()
    ref = np.asarray(jxc.make_maximise_interpolator()(spec, idx))
    np.testing.assert_allclose(got, ref, atol=MAXIMISE_ATOL)
    np.testing.assert_allclose(got, frac, atol=MAXIMISE_ATOL)


def test_cpu_never_loads_the_library(monkeypatch):
    """CPU tensors take the plain versions: nothing is built or loaded
    and no launch is counted."""
    def refuse(name):
        raise AssertionError("loaded {} for a CPU tensor".format(name))

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(fits_lib, "_lib", None)
    counts = (dirichlet.launches, xcorr.autocorr_launches,
              xcorr.maximise_launches)
    dirichlet.make_dirichlet_interpolator(BLOCK, TLEN)(
        torch.from_numpy(dirichlet_rows(8, 7)))
    table, dtable = (torch.from_numpy(t) for t in
                     xcorr.autocorr_tables(gold_template()))
    xcorr.make_autocorr_interpolator(table, dtable)(
        None, torch.full((8,), 10), values=torch.from_numpy(
            autocorr_rows((8,))), length=100)
    spec, idx, _ = maximise_spectra(64, 4)
    xcorr.make_maximise_interpolator()(torch.from_numpy(spec),
                                       torch.from_numpy(idx))
    assert fits_lib._lib is None
    assert (dirichlet.launches, xcorr.autocorr_launches,
            xcorr.maximise_launches) == counts


def test_other_devices_and_widths_raise():
    """A device other than the CPU or a card raises, as does a
    neighbourhood that does not match the interpolator's width."""
    y = torch.zeros((4, 7), device="meta")
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        dirichlet.dirichlet_fit(y, BLOCK, TLEN)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        xcorr.autocorr_fit(y[:, :5], y[0], y[0])
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        xcorr.maximise_search(torch.zeros((4, 8), dtype=torch.complex64,
                                          device="meta"),
                              torch.zeros(4, dtype=torch.int32,
                                          device="meta"))
    with pytest.raises(ValueError, match="expected 7 magnitudes"):
        dirichlet.make_dirichlet_interpolator(BLOCK, TLEN)(torch.zeros(4, 5))


# -- the kernels against their plain versions (card) ---------------------------

def held(got, ref, atol):
    torch.cuda.synchronize()
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, atol=atol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("rows,points", [(256, 7), (128, 7), (256, 5),
                                         (4, 15)])
def test_dirichlet_kernel_matches_plain(cuda_device, rows, points):
    y = torch.from_numpy(dirichlet_rows(rows, points)).to(cuda_device)
    before = dirichlet.launches
    got = dirichlet.dirichlet_fit(y, BLOCK, TLEN)
    assert dirichlet.launches == before + 1
    got = held(got, dirichlet.dirichlet_fit_reference(y, BLOCK, TLEN),
               FIT_ATOL)
    assert got[0] == 0.0
    if points <= 7:   # wider ramps span more than the main lobe
        assert got[2] == 1.0 and got[3] == -1.0
    again = dirichlet.dirichlet_fit(y, BLOCK, TLEN).cpu().numpy()
    np.testing.assert_array_equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256,), (128,), (256, 3)])
def test_autocorr_kernel_matches_plain(cuda_device, shape):
    tmpl = template_mod.generate_bank(11, [0, 1, 2], 2.4) \
        if len(shape) == 2 else np.load(TEMPLATE)
    table, dtable = (torch.from_numpy(t).to(cuda_device) for t in
                     xcorr.autocorr_tables(tmpl))
    y = torch.from_numpy(autocorr_rows(shape)).to(cuda_device)
    before = xcorr.autocorr_launches
    got = xcorr.autocorr_fit(y, table, dtable)
    assert xcorr.autocorr_launches == before + 1
    assert got.shape == shape
    got = held(got, xcorr.autocorr_fit_reference(y, table, dtable),
               FIT_ATOL)
    assert got.reshape(-1)[0] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,idx_dtype", [
    (16384, 256, torch.int32), (16384, 128, torch.int64),
    (3000, 8, torch.int32), (65536, 4, torch.int64)])
def test_maximise_kernel_matches_plain(cuda_device, n, rows, idx_dtype):
    """The main path's [256, 16384] and the gated rows, a
    non-power-of-two n, and n = 65536 (the row does not fit in shared
    memory: the kernel uses its scratch row); int64 indices beyond n and
    negative ones wrap."""
    spec, idx, frac = maximise_spectra(n, rows, seed=rows)
    s = torch.from_numpy(spec).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device).to(idx_dtype)
    if idx_dtype == torch.int64:
        i = i + n * torch.arange(-1, rows - 1, device=cuda_device)
    before = xcorr.maximise_launches
    got = xcorr.maximise_search(s, i)
    assert xcorr.maximise_launches == before + 1
    got = held(got, xcorr.maximise_reference(s, i), MAXIMISE_ATOL)
    np.testing.assert_allclose(got, frac, atol=MAXIMISE_ATOL)


@pytest.mark.cuda
def test_maximise_kernel_bank_and_ties(cuda_device):
    """A bank's [R, T, N] spectra, and all-zero rows whose every
    evaluation ties (fc > fd never holds: both versions walk right)."""
    spec, idx, _ = maximise_spectra(4096, 12, seed=3)
    spec[:3] = 0.0
    s = torch.from_numpy(spec).to(cuda_device).reshape(4, 3, 4096)
    i = torch.from_numpy(idx).to(cuda_device).reshape(4, 3)
    got = xcorr.maximise_search(s, i)
    assert got.shape == (4, 3)
    got = held(got, xcorr.maximise_reference(s, i), MAXIMISE_ATOL)
    assert np.all(got[0] == got[0, 0]) and got[0, 0] > 0.5


@pytest.mark.cuda
def test_fit_kernels_refuse_and_count_nothing_empty(cuda_device):
    """Unsupported dtypes raise on the card (no fallback to the plain
    version); empty batches launch nothing."""
    with pytest.raises(ValueError, match="float32"):
        dirichlet.dirichlet_fit(torch.zeros((4, 7), dtype=torch.float64,
                                            device=cuda_device), BLOCK, TLEN)
    with pytest.raises(ValueError, match="complex64"):
        xcorr.maximise_search(
            torch.zeros((4, 8), dtype=torch.complex128, device=cuda_device),
            torch.zeros(4, dtype=torch.int32, device=cuda_device))
    counts = (dirichlet.launches, xcorr.autocorr_launches,
              xcorr.maximise_launches)
    empty = torch.zeros((0, 7), device=cuda_device)
    assert dirichlet.dirichlet_fit(empty, BLOCK, TLEN).shape == (0,)
    table = torch.ones(129, device=cuda_device)
    assert xcorr.autocorr_fit(empty[:, :5], table, table).shape == (0,)
    assert xcorr.maximise_search(
        torch.zeros((0, 8), dtype=torch.complex64, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device)).shape == (0,)
    assert (dirichlet.launches, xcorr.autocorr_launches,
            xcorr.maximise_launches) == counts
