"""The port's device-side overlap-save unfold and streaming detect, on the
CPU, against the JAX package.

Geometry of tests/test_torch_detector.py: block 2048, history 256, a
5-bit Gold template.  Unfolded rows are held bit-equal to JAX
``unfold_stream`` + ``iq.u16_to_iq_jax`` across calls that carry state;
the streaming detector is held to the JAX kernel program under
test_torch_detector's ``TOLS``; the CLI's ``--device-unfold`` must
write the same .toad as its host unfold.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_detector import BLOCK, HISTORY, TPL, assert_outputs_match, \
    capture, jax_state  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp import unfold as junfold  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import iq, unfold  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402


def bits(a):
    return np.ascontiguousarray(a).view(np.float32).view(np.uint32)


# (block, history): history <= new, and history > new (the JAX gather
# fallback; Tensor.unfold needs none).
@pytest.mark.parametrize("block,history", [(64, 20), (64, 40), (2048, 256)])
def test_unfold_rows_bit_equal_across_calls(block, history):
    rng = np.random.default_rng(block + history)
    new = block - history
    carry = unfold.StreamCarry(history, "cpu")
    jcarry = junfold.StreamCarry(history)

    def jax_fn(new_u16, carry_u16):
        rows, c = junfold.unfold_stream(new_u16, carry_u16, block, history)
        return jiq.u16_to_iq_jax(rows), c

    def port_fn(new_u8, carry_u8):
        rows, c = unfold.unfold_stream(new_u8, carry_u8, block, history)
        return iq.raw_to_iq(rows), c

    for blocks in (3, 1, 5):
        raw = rng.integers(0, 256, size=2 * new * blocks, dtype=np.uint8)
        ref = np.asarray(jcarry.call(jax_fn, raw, new_len=new))
        got = carry.call(port_fn, raw, new_len=new).numpy()
        assert got.shape == (blocks, block)
        np.testing.assert_array_equal(bits(got), bits(ref))
        np.testing.assert_array_equal(
            carry.carry.numpy(), np.asarray(jcarry.carry).view(np.uint8))
    assert carry.carry.numel() == 2 * history


def test_overlap_rows_is_a_view():
    full = torch.arange(2 * 10 + 4, dtype=torch.uint8)
    rows = unfold.overlap_rows(full, 8, 4)  # 2 samples = 4 bytes of history
    assert rows.shape == (5, 8) and rows.data_ptr() == full.data_ptr()
    np.testing.assert_array_equal(rows[2].numpy(), np.arange(8, 16))


def test_carry_never_aliases_the_input():
    new_u8 = torch.full((2 * 44,), 7, dtype=torch.uint8)
    carry = torch.full((2 * 20,), 0x80, dtype=torch.uint8)
    _, out = unfold.unfold_stream(new_u8, carry, 64, 20)
    new_u8.fill_(9)
    assert (out == 7).all()


def test_whole_blocks_required():
    carry = unfold.StreamCarry(20, "cpu")
    fn = lambda b, c: unfold.unfold_stream(b, c, 64, 20)  # noqa: E731
    with pytest.raises(ValueError, match="whole number of blocks"):
        carry.call(fn, np.zeros(2 * 44 + 2, np.uint8), new_len=44)
    with pytest.raises(ValueError, match="whole positive number"):
        unfold.unfold_stream(torch.zeros(10, dtype=torch.uint8),
                             torch.zeros(40, dtype=torch.uint8), 64, 20)
    with pytest.raises(ValueError, match="uint8"):
        carry.call(fn, np.zeros(88, np.int16))
    assert carry.carry is None  # nothing ran, nothing advanced


def stream_pair(window=(7, 110)):
    jdet = JaxDetector(TPL, JaxConfig(block_len=BLOCK, history_len=HISTORY,
                                      carrier_window=window,
                                      use_pallas="on"))
    tdet = BatchDetector.from_numpy_state(
        TPL, DetectorConfig(block_len=BLOCK, history_len=HISTORY,
                            carrier_window=window), jax_state(jdet),
        device="cpu")
    return jdet, tdet


def test_detect_raw_stream_matches_jax():
    """Two carried calls of 8 blocks each, then a reset and a repeat."""
    cap = capture(40.25, True, seed=9)
    raw = jiq.iq_to_raw(cap.blocks[:, HISTORY:].reshape(-1))
    half = raw.size // 2
    jdet, tdet = stream_pair()
    for _ in range(2):
        for part in (raw[:half], raw[half:]):
            ref = jdet.detect_raw_stream(part)
            assert_outputs_match(tdet.detect_raw_stream(part), ref)
        jdet.reset_stream()
        tdet.reset_stream()


def test_stream_equals_host_unfold():
    """The stream path's rows are the host-unfolded rows of detect_raw
    (whose first row is given the stream path's 0x80 pre-stream
    history)."""
    cap = capture(40.25, True, seed=11)
    raw = jiq.iq_to_raw(cap.blocks)
    raw[0, :2 * HISTORY] = 0x80
    new = raw[:, 2 * HISTORY:].reshape(-1)
    _, tdet = stream_pair()
    a = tdet.detect_raw(raw)
    b = tdet.detect_raw_stream(torch.from_numpy(new))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def cli_args(tmp_path, extra):
    return ["detect", str(tmp_path / "s.bin"), "--raw", "--quiet",
            "--template", str(tmp_path / "t.npy"), "--block-size", "2048",
            "--history", "256", "--carrier-window", "7-110",
            "--batch-size", "4", "--t0", "1.5e9", "--device", "cpu"] \
        + list(extra)


@pytest.fixture
def raw_stream(tmp_path):
    np.save(tmp_path / "t.npy", TPL)
    bursts = [{"position": p, "carrier_bin": 40.25, "amplitude": 0.8,
               "phase": 0.3} for p in (2500.0, 6100.0, 9700.0, 15000.0,
                                       21000.0)]
    stream = sim.synth_stream(23000, bursts, TPL, block_len=BLOCK, seed=4)
    (tmp_path / "s.bin").write_bytes(jiq.iq_to_raw(stream).tobytes())
    return tmp_path


@pytest.mark.parametrize("sync", ["fractional", "integer"])
def test_cli_device_unfold_same_toad(raw_stream, sync):
    """--device-unfold (a short, padded last batch included) writes the
    .toad of the host unfold, byte for byte."""
    outs = []
    for extra in ([], ["--device-unfold"]):
        out = raw_stream / "o{}.toad".format(len(outs))
        assert main(cli_args(raw_stream, ["-o", str(out), "--sync-mode",
                                          sync] + extra)) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) >= 4


@pytest.mark.parametrize("extra,match", [
    (["--card-out", "x.card"], "--card-out"),
    (["--skip", "1"], "--skip"),
])
def test_device_unfold_usage_errors(raw_stream, capsys, extra, match):
    with pytest.raises(SystemExit):
        main(cli_args(raw_stream, ["--device-unfold"] + extra))
    assert match in capsys.readouterr().err


def test_device_unfold_needs_raw(tmp_path, capsys):
    gold = os.path.join(os.path.dirname(__file__), "golden", "input")
    with pytest.raises(SystemExit):
        main(["detect", os.path.join(gold, "rx0.card"), "--device-unfold",
              "--device", "cpu"])
    assert "raw stream input" in capsys.readouterr().err


def test_detect_batches_rejects_card_out_with_device_unfold():
    import io

    from thrifty_tpu_torch.pipeline import detect as port_detect

    _, tdet = stream_pair()
    with pytest.raises(ValueError, match="card_out"):
        next(port_detect.detect_batches(tdet, iter([]), 4,
                                        card_out=io.StringIO(),
                                        device_unfold=True))


def test_zero_signal_matches_jax():
    """Pre-stream history: the JAX package's 0x8080 sample, byte-wise."""
    carry = unfold.StreamCarry(5, "cpu")
    carry.reset()
    assert carry.carry.numpy().view(np.uint16).tolist() == \
        [junfold.ZERO_SIGNAL_U16] * 5
