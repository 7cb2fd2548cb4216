"""The port's integer sync (fastdet numerics) on the CPU: its modules
against the JAX package, and its CLI against the goldens of the compiled
reference C tools in tests/golden/fastdet/ (see
tests/test_golden_fastdet.py for how they were made).

- ``integer_roll_fft``: bit-equal to JAX (a gather is a permutation).
- ``parabolic_interpolate``: atol 1e-6 (float32 arithmetic in another
  library).
- The integer-sync detector against JAX's kernel program
  (``use_pallas='on'``, ``sync_mode='integer'``) under
  test_torch_detector's ``TOLS``.
- ``detect --sync-mode integer`` on the golden cards and the raw golden
  stream at full width: integer columns exact, floats within
  test_golden_fastdet's ``TOAD_TOLS``; ``--card-out`` payloads
  byte-identical to fastdet's tee.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_golden_fastdet import FASTDET, INPUT, TOAD_INT_COLS, TOAD_TOLS, \
    card_lines  # noqa: E402
from test_torch_detector import BLOCK, HISTORY, TPL, assert_outputs_match, \
    capture, jax_state  # noqa: E402
from thrifty_tpu.dsp import dirichlet as jdirichlet  # noqa: E402
from thrifty_tpu.dsp import shift as jshift  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet, shift  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402


def test_integer_roll_bit_equal():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 512)) + 1j * rng.normal(size=(6, 512))
         ).astype(np.complex64)
    s = np.array([0, 1, -1, 511, -300, 1000], dtype=np.int32)
    got = shift.integer_roll_fft(torch.from_numpy(x), torch.from_numpy(s))
    ref = np.asarray(jshift.integer_roll_fft(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  ref.view(np.uint64))
    for row, k in enumerate(s):
        np.testing.assert_array_equal(got[row].numpy(), np.roll(x[row], k))


def test_parabolic_matches_jax():
    rng = np.random.default_rng(4)
    y = rng.uniform(0.0, 2.0, size=(64, 3)).astype(np.float32)
    y[:8, 1] += 3.0                     # proper peaks
    y[8] = (1.0, 2.0, 1.0)              # symmetric: offset 0
    y[9] = (1.0, 1.5, 2.0)              # den 0: the 1e-30 guard
    y[10] = (2.0, 1.5, 1.0)
    idx = jnp.zeros(64, jnp.int32)
    for clip in (None, 0.5):
        got = dirichlet.parabolic_interpolate(torch.from_numpy(y), clip=clip)
        ref = np.asarray(jdirichlet.parabolic_interpolate(
            None, idx, clip=clip, values=jnp.asarray(y)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        if clip is not None:
            assert np.abs(got.numpy()).max() <= clip


def integer_pair(window):
    jdet = JaxDetector(TPL, JaxConfig(block_len=BLOCK, history_len=HISTORY,
                                      carrier_window=window,
                                      sync_mode="integer", use_pallas="on"))
    tdet = BatchDetector.from_numpy_state(
        TPL, DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                            carrier_window=window, sync_mode="integer"),
        jax_state(jdet), device="cpu")
    return jdet, tdet


# Negative carriers roll by an FFT index near N.
@pytest.mark.parametrize("carrier_bin,window,quantize", [
    (40.25, (7, 110), False), (40.25, (7, 110), True),
    (-37.6, (-110, -7), True)])
def test_integer_sync_matches_jax_kernel_program(carrier_bin, window,
                                                 quantize):
    cap = capture(carrier_bin, quantize)
    jdet, tdet = integer_pair(window)
    got = tdet(cap.blocks)
    assert_outputs_match(got, jdet._detect_batch(np.asarray(cap.blocks)))
    assert got["detected"].sum() == len(cap.bursts)
    assert tdet.carrier_interp_resolved == "parabolic"
    assert tdet.corr_clip == 0.5
    assert np.abs(got["carrier_offset"].numpy()).max() <= 0.5


def test_explicit_interpolators_match_jax():
    """'dirichlet' in integer sync and 'parabolic' (unclipped) in
    fractional sync, as the JAX detector resolves them."""
    cap = capture(40.25, True, seed=6)
    for sync, interp in (("integer", "dirichlet"),
                         ("fractional", "parabolic")):
        kw = dict(block_len=BLOCK, history_len=HISTORY,
                  carrier_window=(7, 110), sync_mode=sync,
                  carrier_interp=interp)
        jdet = JaxDetector(TPL, JaxConfig(use_pallas="on", **kw))
        tdet = BatchDetector(TPL, DetectorConfig(**kw), device="cpu")
        assert_outputs_match(tdet(cap.blocks),
                             jdet._detect_batch(np.asarray(cap.blocks)))


def assert_fastdet_toad(got_path, ref_path, skip_cols=()):
    ref = np.atleast_2d(np.loadtxt(ref_path))
    got = np.atleast_2d(np.loadtxt(got_path))
    assert got.shape == ref.shape, "different detection count"
    for col in TOAD_INT_COLS:
        np.testing.assert_array_equal(got[:, col], ref[:, col],
                                      err_msg="toad col %d" % col)
    for col, tol in TOAD_TOLS.items():
        if col not in skip_cols:
            np.testing.assert_allclose(got[:, col], ref[:, col],
                                       err_msg="toad col %d" % col, **tol)


COMMON = ["--carrier-window", "7-110", "--quiet", "--sync-mode", "integer",
          "--template", os.path.join(INPUT, "template.npy"),
          "--batch-size", "48", "--device", "cpu"]


@pytest.fixture(scope="module")
def rerun(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fastdet")
    for rxid in (0, 1, 2):
        tee = ["--card-out", str(d / "tee.card")] if rxid == 0 else []
        assert main(["detect", os.path.join(INPUT, "rx%d.card" % rxid),
                     "-o", str(d / ("rx%d.toad" % rxid)),
                     "--rxid", str(rxid)] + tee + COMMON) == 0
    return d


@pytest.mark.parametrize("rxid", [0, 1, 2])
def test_integer_cli_matches_compiled_fastdet(rerun, rxid):
    assert_fastdet_toad(rerun / ("rx%d.toad" % rxid),
                        os.path.join(FASTDET, "rx%d_fastdet.toad" % rxid))


def test_card_tee_matches_compiled_fastdet(rerun):
    assert card_lines(str(rerun / "tee.card")) == card_lines(
        os.path.join(FASTDET, "tee.card"))


def test_raw_skip_matches_compiled_fastdet(tmp_path):
    """detect --raw -k 1 --t0 0: fastdet's default raw skip.  Timestamps
    are wall-clock in the C run, so column 1 is not compared."""
    out = tmp_path / "raw_skip1.toad"
    assert main(["detect", "--raw",
                 os.path.join(FASTDET, "input", "rx0.raw"), "-o", str(out),
                 "-k", "1", "--t0", "0", "--rxid", "0"] + COMMON) == 0
    assert_fastdet_toad(out, os.path.join(FASTDET, "raw_skip1_fastdet.toad"),
                        skip_cols=(1,))
