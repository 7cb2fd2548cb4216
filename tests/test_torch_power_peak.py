"""The port's fused power/peak reduction against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version; it is held
against the JAX plain version (``fused_power_peak_reference``) and the
Pallas kernel itself in interpret mode.  Tolerances: ``idx`` is exact;
``peak`` rtol 1e-6 (|x|^2 of the same float32 inputs, where XLA may fuse
a multiply-add); sums rtol 1e-5 (float32 reassociation).

Tests marked ``cuda`` hold the hand-written kernel against the plain
version on the card, with ``idx`` and ``peak`` bit-equal, and skip where
there is none.  They import no JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_power_peak.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch.dsp import power_peak as tpp  # noqa: E402

RTOL = (1e-6, 1e-5, 1e-5, 1e-5)  # peak, total, stat_pow, stat_mag


@pytest.fixture(scope="module")
def pk():
    return pytest.importorskip("thrifty_tpu.dsp.pallas_kernels")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def make_data(b=16, n=4096, seed=0):
    """The JAX suite's input (tests/test_pallas.py make_data)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, n)) + 1j * rng.normal(size=(b, n))
         ).astype(np.complex64)
    for i in range(b):
        x[i, 100 + i] = 50.0 + 0j        # inside window
        x[i, n - 10] = 80.0 + 0j         # outside window (must be ignored)
    mask = np.zeros(n, dtype=bool)
    mask[50:2000] = True
    return x, mask


def background(b, n, seed=0):
    """Small random samples (|x| <= 0.03).  Random, not constant: a
    constant background rounds the same way on every add, and a
    sequential float32 sum of n such terms drifts by ~n ulps instead
    of ~sqrt(n), beyond the reassociation tolerance of the sums."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.02, 0.02, (b, n))
            + 1j * rng.uniform(-0.02, 0.02, (b, n))).astype(np.complex64)


def ties_data(b=8, n=2048):
    """Equal maxima planted twice per row: the earliest must win."""
    x = background(b, n)
    for i in range(b):
        x[i, 300 + i] = 3.0 + 4.0j
        x[i, 1500 - i] = 4.0 + 3.0j  # same power, later column
    mask = np.ones(n, dtype=bool)
    return x, mask


def stats_mask_for(n):
    sm = np.zeros(n, dtype=bool)
    sm[:(3 * n) // 4] = True
    return sm


def port(x, mask, stats_mask=None, layout="interleaved"):
    out = tpp.fused_power_peak(torch.from_numpy(x), mask,
                               stats_mask=stats_mask, layout=layout)
    return [o.numpy() for o in out]


def assert_close(got, ref):
    assert len(got) == len(ref)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    for g, r, tol in zip(got[1:], ref[1:], RTOL):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=tol)


def jax_reference(pk, x, mask, stats_mask=None):
    import jax.numpy as jnp
    return pk.fused_power_peak_reference(
        jnp.real(x), jnp.imag(x), jnp.asarray(mask),
        None if stats_mask is None else jnp.asarray(stats_mask))


CASES = {
    "window": lambda: make_data(),
    "window_seed7": lambda: make_data(seed=7),
    "ties": ties_data,
}


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_reference(pk, case, stats):
    x, mask = CASES[case]()
    sm = stats_mask_for(x.shape[1]) if stats else None
    assert_close(port(x, mask, sm), jax_reference(pk, x, mask, sm))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_plain_matches_pallas_interpret(pk, layout, stats):
    x, mask = make_data(seed=11)
    sm = stats_mask_for(x.shape[1]) if stats else None
    got = port(x, mask, sm, layout=layout)
    ref = pk.fused_power_peak(x, mask, row_tile=8, chunk=512,
                              interpret=True, layout=layout, stats_mask=sm)
    assert_close(got, ref)


@pytest.mark.parametrize("peak_pos", [0, 255, 256, 1792, 2047])
def test_chunk_edge_peaks(pk, peak_pos):
    """Peaks at the first/last sample of the Pallas kernel's chunks."""
    b, n, chunk = 8, 2048, 512
    x = background(b, n, seed=peak_pos)
    x[:, peak_pos] = 7.0 - 2.0j
    mask = np.ones(n, dtype=bool)
    got = port(x, mask)
    ref = pk.fused_power_peak(x, mask, row_tile=8, chunk=chunk,
                              interpret=True, layout="interleaved")
    assert np.all(got[0] == peak_pos)
    assert_close(got, ref)


def test_ragged_shape(pk):
    """3 x 1000 tiles nothing; the port has no tiling gate."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 1000))
         + 1j * rng.normal(size=(3, 1000))).astype(np.complex64)
    mask = np.ones(1000, dtype=bool)
    got = port(x, mask, stats_mask_for(1000))
    assert_close(got, jax_reference(pk, x, mask, stats_mask_for(1000)))
    np.testing.assert_array_equal(got[0], np.argmax(np.abs(x) ** 2, -1))


def test_ties_earliest_wins():
    x, mask = ties_data()
    idx = port(x, mask)[0]
    np.testing.assert_array_equal(idx, 300 + np.arange(len(x)))


@pytest.mark.parametrize("stats", [False, True])
def test_empty_mask_raises(stats):
    x, _ = make_data(b=2, n=256)
    empty = np.zeros(256, dtype=bool)
    with pytest.raises(ValueError, match="no True entries"):
        tpp.fused_power_peak(torch.from_numpy(x), empty,
                             stats_mask=empty if stats else None)


def test_bad_inputs_raise():
    x, mask = make_data(b=2, n=256)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="complex64"):
        tpp.fused_power_peak(t.to(torch.complex128), mask)
    with pytest.raises(ValueError, match="contiguous"):
        tpp.fused_power_peak(t.t().contiguous().t(), np.ones(2, bool))
    with pytest.raises(ValueError, match="length"):
        tpp.fused_power_peak(t, np.ones(10, bool))
    with pytest.raises(ValueError, match="layout"):
        tpp.fused_power_peak(t, mask, layout="rows")


def test_cpu_never_counts_launches():
    x, mask = make_data(b=2, n=256)
    before = tpp.launches
    port(x, mask)
    assert tpp.launches == before


# -- on the card -------------------------------------------------------------

def card_cases():
    rng = np.random.default_rng(5)
    n = 16384
    x = (rng.normal(size=(256, n))
         + 1j * rng.normal(size=(256, n))).astype(np.complex64)
    x[:, -1] = 40.0  # peak in the last column
    carrier = np.zeros(n, dtype=bool)
    carrier[7:111] = True
    corr = np.zeros(n, dtype=bool)
    corr[2000:13000] = True
    full = np.ones(n, dtype=bool)
    rag = (rng.normal(size=(3, 1000))
           + 1j * rng.normal(size=(3, 1000))).astype(np.complex64)
    tx, tmask = ties_data()
    return {"carrier": (x, carrier), "corr": (x, corr),
            "last_column": (x, full), "ragged": (rag, np.ones(1000, bool)),
            "ties": (tx, tmask)}


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
@pytest.mark.parametrize("case", ["carrier", "corr", "last_column", "ragged",
                                  "ties"])
def test_kernel_matches_plain_on_card(cuda_device, case, layout, stats):
    x, mask = card_cases()[case]
    sm = stats_mask_for(x.shape[1]) if stats else None
    xd = torch.from_numpy(x).to(cuda_device)
    before = tpp.launches
    got = tpp.fused_power_peak(xd, mask, stats_mask=sm, layout=layout)
    torch.cuda.synchronize()
    assert tpp.launches == before + 1
    ref = tpp.fused_power_peak_reference(
        xd.real, xd.imag, torch.from_numpy(mask).to(cuda_device),
        None if sm is None else torch.from_numpy(sm).to(cuda_device))
    got = [g.cpu().numpy() for g in got]
    ref = [r.cpu().numpy() for r in ref]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])  # bit-equal peak
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g, r, rtol=1e-5)
    if case == "last_column":
        assert np.all(got[0] == x.shape[1] - 1)
    if case == "ties":
        np.testing.assert_array_equal(got[0], 300 + np.arange(len(x)))


@pytest.mark.cuda
def test_kernel_empty_batch_and_errors(cuda_device):
    x = torch.zeros((0, 128), dtype=torch.complex64, device=cuda_device)
    before = tpp.launches
    idx, peak, total = tpp.fused_power_peak(x, np.ones(128, bool))
    assert idx.shape == (0,) and tpp.launches == before
    with pytest.raises(ValueError, match="no True entries"):
        tpp.fused_power_peak(x, np.zeros(128, bool))
