"""The plain float64 reference of upstream fastdet's receiver
(``thrifty_tpu_torch.oracle.fastdet_plain``) against the port's
carrier-gated detector and against the port's NumPy oracle, on the CPU.

Streams: the port's ``sim`` at the upstream geometry (block 16384,
history 4920, the 11-bit Gold template), three transmitters at
upstream's ``rpi/freq-map.cfg`` bins and amplitudes from strong to a few
dB over the ``15*snr`` thresholds, 8-bit quantized as a receiver
delivers them, in batches of 8 and 16 blocks.  The port runs
``submit_raw`` under fastdet's settings (integer sync, parabolic
carrier fit) ungated, at a capacity one below the batch's carrier
count (it overflows and re-runs in full) and at that count (it fits).

Tolerances, port against the float64 reference.  The port's largest
distances on these streams: carrier offset 5.9e-7 bins, correlation
offset 3.7e-7 samples, energies 2.5e-7 and noise 1.7e-7 relative; on
six more streams of the kind, up to 2.2e-6 / 7.2e-7 / 2.2e-7 / 1.7e-7:

- ``detected``, ``carrier_detect``: equal, no block of these streams
  lies within float32 rounding of a threshold;
- ``carrier_bin``, ``corr_sample``: equal where both detect, the
  argmax of a float32 spectrum lands on the float64 one's bin;
- ``carrier_offset``: 1e-5 bins, the parabolic fit divides float32
  magnitude differences (relative error ~1e-7) by the peak's curvature;
- ``corr_offset``: 5e-6 samples, the Gaussian fit's log magnitudes
  carry the same relative error;
- ``carrier_energy``, ``corr_energy``: 2e-6 relative, a float32 FFT of
  16384 points is good to ~1e-7 x log2(N);
- ``carrier_noise``, ``corr_noise``: 1e-6 relative, float32 sums of
  16384 squares.

A float32 reference is the port's own precision: it lands within the
same distances (1.0e-6 / 3.8e-7 / 2.0e-7 / 1.7e-7 on these streams),
so no tolerance the port passes can fail it.  The control is TF32: the
reference at float32 with each transform's input rounded to TF32's 10
mantissa bits, as a TF32 GEMM transform rounds its operands.  Its
least distances on these streams, 1.6e-5 / 6.7e-6 / 1.3e-5 / 3.2e-6,
fail every tolerance; the tests ask that it fail at least one on every
stream, and each tolerance on some stream.
"""

import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.dsp import iq  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.oracle import fastdet_plain  # noqa: E402
from thrifty_tpu_torch.oracle.numpy_ref import \
    FastdetOracleDetector  # noqa: E402

BLOCK, HISTORY = 16384, 4920
NEW = BLOCK - HISTORY
WINDOW = (7, 110)
TPL = sim.make_template()
# (carrier bin, amplitude): rpi/freq-map.cfg's first, third and fifth.
TX = ((15.5, 0.5), (52.5, 0.08), (96.5, 0.025))
SEEDS = (1, 2, 3)
BATCHES = (8, 16)
TOLS = {"carrier_offset": 1e-5, "corr_offset": 5e-6,
        "carrier_energy": 2e-6, "corr_energy": 2e-6,
        "carrier_noise": 1e-6, "corr_noise": 1e-6}
RELATIVE = ("carrier_energy", "corr_energy", "carrier_noise",
            "corr_noise")
_cache = {}


def raw_blocks(seed, batch):
    """uint8 [batch, 2N]: the overlap-save rows of a seeded stream with
    ``batch // 4`` bursts of each transmitter at random positions."""
    rng = np.random.default_rng(seed)
    length = batch * NEW
    bursts = [{"position": float(p),
               "carrier_bin": b + float(rng.uniform(-0.4, 0.4)),
               "amplitude": a, "phase": float(rng.uniform(0, 2 * np.pi))}
              for b, a in TX
              for p in rng.uniform(200, length - len(TPL) - 300,
                                   batch // 4)]
    stream = sim.synth_stream(length, bursts, TPL, block_len=BLOCK,
                              seed=seed)
    return iq.iq_to_raw(sim.stream_to_blocks(stream, BLOCK, HISTORY))


class Float32Plain(fastdet_plain.FastdetPlain):
    """The same arithmetic one precision lower."""

    REAL = torch.float32
    COMPLEX = torch.complex64


def reference(seed, batch, cls=fastdet_plain.FastdetPlain):
    key = (seed, batch, cls)
    if key not in _cache:
        _cache[key] = cls(TPL, BLOCK, HISTORY, carrier_window=WINDOW
                          ).detect_raw(raw_blocks(seed, batch))
    return _cache[key]


def distances(got, ref):
    """{field: largest distance} of the compared fields, where the
    decisions agree (asserted)."""
    for k in ("detected", "carrier_detect"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    carrier, both = ref["carrier_detect"], ref["detected"]
    np.testing.assert_array_equal(got["carrier_bin"][carrier],
                                  ref["carrier_bin"][carrier])
    np.testing.assert_array_equal(got["corr_sample"][both],
                                  ref["corr_sample"][both])
    out = {}
    for k in TOLS:
        rows = carrier if k.startswith("carrier") else both
        a = np.asarray(got[k][rows], np.float64)
        b = np.asarray(ref[k][rows], np.float64)
        gap = np.abs(a / b - 1.0) if k in RELATIVE else np.abs(a - b)
        out[k] = float(gap.max(initial=0.0))
    return out


@pytest.mark.parametrize("kind", ["ungated", "overflows", "fits"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("seed", SEEDS)
def test_gated_port_matches_plain(seed, batch, kind):
    ref = reference(seed, batch)
    carriers = int(ref["carrier_detect"].sum())
    assert 2 <= carriers < batch
    capacity = {"ungated": 0, "overflows": carriers - 1,
                "fits": carriers}[kind]
    det = BatchDetector(TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=WINDOW,
        sync_mode="integer", carrier_interp="parabolic",
        gate_capacity=capacity), device="cpu")
    pending = det.submit_raw(raw_blocks(seed, batch))
    got = {k: v.numpy() for k, v in pending.result().items()}
    assert pending.overflowed is {"ungated": None, "overflows": True,
                                  "fits": False}[kind]
    assert det.gate_overflows == (kind == "overflows")
    gaps = distances(got, ref)
    assert all(gaps[k] <= TOLS[k] for k in TOLS), gaps
    assert ref["detected"].sum() >= 2


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_matches_numpy_oracle(seed, batch):
    """The same semantics as the port's NumPy float64 oracle, to float64
    rounding."""
    raw = raw_blocks(seed, batch)
    oracle = FastdetOracleDetector(TPL, BLOCK, HISTORY,
                                   carrier_window=WINDOW)
    f = raw.astype(np.float64)
    blocks = (f[:, 0::2] - 127.4) / 128.0 + 1j * (f[:, 1::2] - 127.4) / 128.0
    rows = [oracle.detect_block(b) for b in blocks]
    want = {k: np.array([getattr(r, k) for r in rows])
            for k in fastdet_plain.FIELDS}
    gaps = distances(reference(seed, batch), want)
    assert all(g <= 1e-12 for g in gaps.values()), gaps


def tf32_round(x):
    """complex64 with each part rounded to TF32 (10 mantissa bits)."""
    def part(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.complex(part(x.real), part(x.imag))


@pytest.fixture(scope="module")
def control_gaps():
    """{(seed, batch): distances} of the TF32 control."""
    refs = {(s, b): reference(s, b) for s in SEEDS for b in BATCHES}
    fft, ifft = torch.fft.fft, torch.fft.ifft
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.fft, "fft", lambda x: fft(tf32_round(x)))
    mp.setattr(torch.fft, "ifft", lambda x: ifft(tf32_round(x)))
    try:
        return {(s, b): distances(
            Float32Plain(TPL, BLOCK, HISTORY, carrier_window=WINDOW
                         ).detect_raw(raw_blocks(s, b)),
            ref) for (s, b), ref in refs.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails(control_gaps, seed, batch):
    gaps = control_gaps[(seed, batch)]
    assert any(gaps[k] > TOLS[k] for k in TOLS), gaps


def test_tf32_control_fails_each_tolerance(control_gaps):
    for k in TOLS:
        assert max(g[k] for g in control_gaps.values()) > TOLS[k], k


def test_float32_reference_is_the_ports_precision():
    """The float32 reference lands where the port does: within every
    tolerance, so it is no control (the module docstring)."""
    for seed in SEEDS:
        gaps = distances(reference(seed, 16, Float32Plain),
                         reference(seed, 16))
        assert all(gaps[k] <= TOLS[k] for k in TOLS), gaps
        assert max(gaps.values()) > 1e-9, gaps


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_reference_keeps_tf32_off_while_it_computes(monkeypatch):
    """TF32 is off inside the reference's transforms, and the process's
    flags are as they were before and after."""
    seen = []
    fft = torch.fft.fft

    def spy(x):
        seen.append(flags())
        return fft(x)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ref = fastdet_plain.FastdetPlain(TPL, BLOCK, HISTORY,
                                     carrier_window=WINDOW)
    assert flags() == (True, True)
    monkeypatch.setattr(torch.fft, "fft", spy)
    ref.detect_raw(raw_blocks(1, 8)[:2])
    assert seen and set(seen) == {(False, False)}
    assert flags() == (True, True)


def test_refuses_what_fastdet_lacks():
    with pytest.raises(ValueError, match="stddev"):
        fastdet_plain.FastdetPlain(TPL, carrier_thresh=(0.0, 15.0, 2.0))
    with pytest.raises(ValueError, match="history_len"):
        fastdet_plain.FastdetPlain(TPL, history_len=100)


def test_imports_only_torch_numpy_and_the_standard_library():
    import sys

    with open(fastdet_plain.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names - {"torch", "numpy"} <= set(sys.stdlib_module_names), names
