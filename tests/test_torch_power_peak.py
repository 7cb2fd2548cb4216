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


# -- the kernel's launch plan (CPU) ------------------------------------------

N_VALUES = [1, 7, 1000, 2048, 2049, 16384, 16385]
SMS = 132  # an H100 SXM
# One row: S = clamp(ceil(n / 2048), 1, 8), the rows never fill the card.
PLANS = {1: (1, 4), 7: (1, 8), 1000: (1, 1000), 2048: (1, 2048),
         2049: (2, 1028), 16384: (8, 2048), 16385: (8, 2052)}
# At n = 16384: split while rows < 66 (half the SMs), by ceil(66 / rows).
ROW_PLANS = {1: (8, 2048), 8: (8, 2048), 9: (8, 2048), 11: (6, 2732),
             32: (3, 5464), 64: (2, 8192), 65: (2, 8192), 66: (1, 16384),
             128: (1, 16384), 256: (1, 16384), 768: (1, 16384)}


@pytest.mark.parametrize("n", N_VALUES)
def test_cluster_plan_and_slices(n):
    """For one row: S = clamp(ceil(n / 2048), 1, 8) CTAs; slices of
    ceil(n/S) columns rounded up to 4 that start 16-byte aligned and tile
    the row in rank order, none empty.  A batch of 256 rows fills the
    card and is never split."""
    assert tpp.cluster_plan(n, 1, SMS) == PLANS[n]
    s, slice_len = PLANS[n]
    bounds = tpp.slice_bounds(n, 1, SMS)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (lo, hi), (nxt, _) in zip(bounds, bounds[1:] + [(n, n)]):
        assert lo % 4 == 0 and lo < hi <= lo + slice_len and hi == nxt
    assert tpp.slice_bounds(n, 256, SMS) == [(0, n)]


@pytest.mark.parametrize("rows", sorted(ROW_PLANS))
def test_cluster_plan_by_rows(rows):
    """Rows are split only while they give fewer CTAs than half the SMs."""
    assert tpp.cluster_plan(16384, rows, SMS) == ROW_PLANS[rows]
    assert tpp.cluster_plan(16384, rows, 16)[0] == (1 if rows >= 8 else
                                                    -(-8 // rows))


A = 1 << 20  # a 16-byte-aligned address


@pytest.mark.parametrize("case,args,vec", [
    ("interleaved", (A, A + 4, A + 4096, None, 2 * 16384, 2, 1), True),
    ("interleaved_stats", (A, A + 4, A + 4096, A + 8192, 2 * 16384, 2, 1),
     True),
    ("interleaved_odd_n", (A, A + 4, A + 4096, None, 2 * 16385, 2, 1),
     False),
    ("interleaved_offset_8", (A + 8, A + 12, A + 4096, None, 2 * 16384, 2,
                              1), False),
    ("mask_offset", (A, A + 4, A + 4097, None, 2 * 16384, 2, 1), False),
    ("stats_mask_offset", (A, A + 4, A + 4096, A + 8196, 2 * 16384, 2, 1),
     False),
    ("planes", (A, A + 65536, A + 4096, None, 16384, 1, 0), True),
    ("planes_n_not_4k", (A, A + 65536, A + 4096, None, 16386, 1, 0), False),
    ("planes_im_offset", (A, A + 65540, A + 4096, None, 16384, 1, 0), False),
    ("planes_elem_stride_2", (A, A + 65536, A + 4096, None, 16384, 2, 0),
     False),
])
def test_vector_path_choice(case, args, vec):
    """The 16-byte load path runs only on aligned rows, planes and masks;
    everything else takes the scalar path of the same kernel."""
    assert tpp.vector_path(*args) is vec


def slice_merge(x, mask, stats_mask=None):
    """Plain-torch emulation of the kernel's reduction: each slice of
    slice_bounds(n, rows, SMS) reduced on its own (argmax with NaN largest
    and the earliest column, sums), then merged in slice order with the
    kernel's rule; the peak re-read at the winning column."""
    power = x.real * x.real + x.imag * x.imag
    masked = torch.where(mask, power, -1.0)
    best = col = None
    sums = []
    for lo, hi in tpp.slice_bounds(x.shape[1], x.shape[0], SMS):
        k = torch.argmax(masked[:, lo:hi], dim=-1)
        v = torch.gather(masked[:, lo:hi], -1, k[:, None])[:, 0]
        c = k + lo
        part = [power[:, lo:hi].sum(-1)]
        if stats_mask is not None:
            sm = stats_mask[lo:hi]
            part += [torch.where(sm, power[:, lo:hi], 0.0).sum(-1),
                     torch.where(sm, torch.sqrt(power[:, lo:hi]),
                                 0.0).sum(-1)]
        if best is None:
            best, col, sums = v, c, part
            continue
        v_nan, b_nan = torch.isnan(v), torch.isnan(best)
        take = torch.where(v_nan | b_nan, v_nan & (~b_nan | (c < col)),
                           (v > best) | ((v == best) & (c < col)))
        best, col = torch.where(take, v, best), torch.where(take, c, col)
        sums = [a + b for a, b in zip(sums, part)]
    peak = torch.gather(power, -1, col[:, None])[:, 0]
    return [col.to(torch.int32), peak] + sums


def boundary_rows(n, rows, sms=SMS, seed=0):
    """Rows with their maxima placed on the slice boundaries of n: a peak
    in the last column of a slice, equal powers at the last column of
    slice k and the first of slice k+1 (the earliest must win), a NaN in
    a later slice, NaNs at two slice starts, a NaN in a masked-out
    column; other rows random.  Returns (x complex64, mask, stats mask)."""
    x = background(rows, n, seed)
    bounds = tpp.slice_bounds(n, rows, sms)
    last = len(bounds) - 1
    mask = np.ones(n, dtype=bool)
    if n >= 100:
        mask[1:n // 50] = False
    for r in range(rows):
        k = r % len(bounds)
        hi = bounds[k][1]
        kind = r % 6
        if kind == 0:
            x[r, hi - 1] = 5.0 + 1.0j
        elif kind == 1 and last:
            k = min(k, last - 1)
            x[r, bounds[k][1] - 1] = 3.0 + 4.0j
            x[r, bounds[k + 1][0]] = 4.0 + 3.0j  # same power, later column
        elif kind == 2:
            x[r, max(bounds[last][0], n - 1 - r % 3)] = np.nan
            x[r, 0] = 9.0
        elif kind == 3 and last:
            x[r, bounds[1][0]] = np.nan + 0j
            x[r, bounds[last][0]] = np.nan
        elif kind == 4 and n >= 100:
            x[r, 2] = np.nan                # masked out: ignored in idx
            x[r, n - 1] = 2.0
    return x, mask, stats_mask_for(n)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("n", [7, 2049, 16384, 16385])
def test_slice_merge_matches_plain(n, stats):
    """The slice-ordered merge gives the plain version's idx and peak bit
    for bit (ties and NaNs on slice boundaries) and its sums within
    float32 reassociation."""
    x, mask, sm = boundary_rows(n, 12, seed=n)
    xt = torch.from_numpy(x)
    m = torch.from_numpy(mask)
    smt = torch.from_numpy(sm) if stats else None
    got = slice_merge(xt, m, smt)
    ref = tpp.fused_power_peak_reference(xt.real, xt.imag, m, smt)
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  ref[1].numpy().view(np.uint32))
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5)
    if n > 2048:
        assert np.isnan(ref[1].numpy()[2]) and np.isnan(ref[1].numpy()[3])
        bounds = tpp.slice_bounds(n, 12, SMS)
        k = min(1, len(bounds) - 2)
        assert ref[0].numpy()[1] == bounds[k][1] - 1  # the earlier tie


# -- the cluster kernel on the card -------------------------------------------

CARD_SHAPES = [(rows, 16384) for rows in (1, 3, 32, 64, 128, 256, 768)] \
    + [(3, n) for n in N_VALUES if n != 16384]


def card_sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def expected_plan(xd, layout):
    """The plan of the Python mirror for ``xd`` (masks are fresh, so
    aligned; planes are fresh contiguous copies)."""
    rows, n = xd.shape
    if layout == "interleaved":
        vec = xd.data_ptr() % 16 == 0 and (8 * xd.stride(0)) % 16 == 0
    else:
        vec = n % 4 == 0
    sms = card_sms(xd.device)
    return tpp.cluster_plan(n, rows, sms) + (vec, sms)


def assert_kernel_matches_plain(xd, mask, sm, layout):
    """One launch against the plain version: idx and peak bit-equal, sums
    within 1e-5; a second launch gives bit-equal sums."""
    dev = xd.device
    before = tpp.launches
    got = tpp.fused_power_peak(xd, mask, stats_mask=sm, layout=layout)
    again = tpp.fused_power_peak(xd, mask, stats_mask=sm, layout=layout)
    torch.cuda.synchronize()
    assert tpp.launches == before + 2
    ref = tpp.fused_power_peak_reference(
        xd.real, xd.imag, torch.from_numpy(mask).to(dev),
        None if sm is None else torch.from_numpy(sm).to(dev))
    got = [g.cpu().numpy() for g in got]
    again = [g.cpu().numpy() for g in again]
    ref = [r.cpu().numpy() for r in ref]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  ref[1].view(np.uint32))
    for g, a, r in zip(got[2:], again[2:], ref[2:]):
        np.testing.assert_allclose(g, r, rtol=1e-5)
        np.testing.assert_array_equal(g.view(np.uint32), a.view(np.uint32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
@pytest.mark.parametrize("rows,n", CARD_SHAPES)
def test_cluster_kernel_on_slice_boundaries(cuda_device, rows, n, layout,
                                            stats):
    """Rows split over clusters of up to 8 CTAs (few rows) or one CTA
    each (a full card): peaks in the last column of a slice, equal powers
    across a slice boundary, NaNs in later slices; the kernel's own
    launch plan equals the Python mirror."""
    x, mask, sm = boundary_rows(n, rows, card_sms(cuda_device),
                                seed=rows + n)
    xd = torch.from_numpy(x).to(cuda_device)
    sm = sm if stats else None
    assert tpp.kernel_plan(xd, mask, sm, layout) == expected_plan(xd, layout)
    got = assert_kernel_matches_plain(xd, mask, sm, layout)
    bounds = tpp.slice_bounds(n, rows, card_sms(cuda_device))
    if len(bounds) > 1 and rows > 1:
        assert got[0][1] == bounds[min(1, len(bounds) - 2)][1] - 1


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cluster_kernel_misaligned_input(cuda_device, layout, stats):
    """A contiguous complex64 view 8 bytes past a 16-byte boundary takes
    the scalar path of the same kernel (interleaved) and still matches."""
    b, n = 6, 16384
    x, mask, sm = boundary_rows(n, b, card_sms(cuda_device), seed=3)
    buf = torch.empty(b * n + 1, dtype=torch.complex64, device=cuda_device)
    xd = buf[1:].view(b, n)
    xd.copy_(torch.from_numpy(x))
    assert xd.data_ptr() % 16 == 8
    sm = sm if stats else None
    plan = tpp.kernel_plan(xd, mask, sm, layout)
    assert plan == expected_plan(xd, layout)
    assert plan[2] is (layout == "planes")
    assert_kernel_matches_plain(xd, mask, sm, layout)
