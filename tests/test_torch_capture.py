"""The port's capture node on the CPU: ``CarrierGate`` against the JAX
``CarrierGate``, the ``capture`` CLI against the compiled fastcard's
``gated.card``, and the live rtl_tcp paths against the same bytes read
from a file.

Tolerances: indices and decisions exact; magnitude, noise and threshold
rtol 1e-4 (the port takes |X| as the square root of the power its
reduction finds, JAX as |X| itself: last-bit differences).  Archives:
block indices and payloads identical.
"""

import io as io_mod
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_golden_fastdet import FASTDET, card_lines  # noqa: E402
from test_rtl_tcp import FakeRtlTcpServer  # noqa: E402
from test_torch_detector import BLOCK, HISTORY, TPL  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.config import settings as st  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.io import rtl_tcp  # noqa: E402
from thrifty_tpu.pipeline import capture as jcapture  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.pipeline import capture  # noqa: E402

THRESH = (0.0, 15.0, 0.0)
RAW0 = os.path.join(FASTDET, "input", "rx0.raw")


def bursty_stream(num_blocks=12, seed=21):
    cap = sim.synth_capture(
        num_blocks=num_blocks, bursts_every=3, template=TPL,
        block_len=BLOCK, history_len=HISTORY, carrier_bin=40.25,
        amplitude=0.5, noise_std=0.05, seed=seed)
    return cap, jiq.iq_to_raw(cap.blocks[:, HISTORY:].reshape(-1))


def assert_gate_match(got, ref):
    names = ("detected", "argmax", "magnitude", "noise", "threshold")
    for name, g, r in zip(names, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, name
        if name in ("detected", "argmax"):
            np.testing.assert_array_equal(g, r.astype(g.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("window", [(7, 110), (-110, -7), None])
def test_gate_matches_jax(window):
    cap, _ = bursty_stream()
    raw = jiq.iq_to_raw(cap.blocks)
    got = capture.CarrierGate(BLOCK, window, THRESH, device="cpu")(raw)
    ref = jcapture.CarrierGate(BLOCK, window, THRESH)(raw)
    assert_gate_match(got, ref)
    if window == (7, 110):
        assert got[0].any() and not got[0].all()


@pytest.mark.parametrize("block,history", [(BLOCK, HISTORY), (256, 160)])
def test_gate_stream_matches_jax(block, history):
    """Carried calls of the stream gate, history > advance included."""
    rng = np.random.default_rng(5)
    new = block - history
    kw = dict(history_len=history)
    window = (7, 110) if block == BLOCK else (3, 12)
    tgate = capture.CarrierGate(block, window, THRESH, device="cpu", **kw)
    jgate = jcapture.CarrierGate(block, window, THRESH, **kw)
    if block == BLOCK:
        _, stream = bursty_stream()
    else:
        stream = rng.integers(0, 256, size=2 * new * 8, dtype=np.uint8)
    half = stream.size // 2 // (2 * new) * (2 * new)
    for _ in range(2):
        for part in (stream[:half], stream[half:]):
            assert_gate_match(tgate.gate_stream(part),
                              jgate.gate_stream(part))
        tgate.reset_stream()
        jgate.reset_stream()


@pytest.mark.parametrize("thresh", [(0.0, 15.0, 2.0), (0.0, 5.0, 40.0)])
def test_stddev_term_raises(thresh):
    """A stddev term no longer raises: the port's gate takes var(|X|)
    from the kernel's stats sums in the same launch, and its decisions
    equal the JAX gate's (jnp.var) exactly; with a large d the term
    changes decisions."""
    cap, stream = bursty_stream(num_blocks=24, seed=4)
    raw = jiq.iq_to_raw(cap.blocks)
    got = capture.CarrierGate(BLOCK, (7, 110), thresh, device="cpu")(raw)
    ref = jcapture.CarrierGate(BLOCK, (7, 110), thresh)(raw)
    assert_gate_match(got, ref)
    base = capture.CarrierGate(BLOCK, (7, 110), thresh[:2] + (0.0,),
                               device="cpu")(raw)
    if thresh[2] > 10:
        assert not torch.equal(got[0], base[0])
    gate = capture.CarrierGate(BLOCK, (7, 110), thresh, history_len=HISTORY,
                               device="cpu")
    jgate = jcapture.CarrierGate(BLOCK, (7, 110), thresh,
                                 history_len=HISTORY)
    assert_gate_match(gate.gate_stream(stream), jgate.gate_stream(stream))


def test_header_and_build_args_match_jax():
    values = st.load_settings(config_file=iter([
        "sample_rate: 2.4M", "tuner_freq: 433.83M", "tuner_gain: 29",
        "block_size: 16384", "block_history: 4920",
        "carrier_window: 7 - 110", "carrier_threshold: 100c+2s",
        "capture_skip: 20000"]))
    ns = st.Namespace(values)
    assert capture.build_args(ns, "rx.card") == \
        jcapture.build_args(ns, "rx.card")
    for sdr in (False, True):
        assert capture.card_header(ns, (7, 110), sdr=sdr, t0=1.5) == \
            jcapture.card_header(ns, (7, 110), sdr=sdr, t0=1.5)


@pytest.mark.parametrize("extra", [[], ["--device-unfold"]])
def test_capture_cli_matches_compiled_fastcard(tmp_path, extra):
    """capture --raw-in rx0.raw --t0 0 (default skip 1) keeps fastcard's
    blocks with byte-identical payloads, host or device unfold."""
    out = tmp_path / "gated.card"
    assert main(["capture", "--raw-in", RAW0, "-o", str(out), "--t0", "0",
                 "--quiet", "--carrier-window", "7-110", "--device",
                 "cpu"] + extra) == 0
    assert card_lines(str(out)) == card_lines(
        os.path.join(FASTDET, "gated.card"))


def test_capture_device_unfold_byte_identical(tmp_path):
    """The whole archive, header included, for skip 0 and 1 and a short
    last batch."""
    _, stream = bursty_stream(num_blocks=11)
    raw = tmp_path / "s.bin"
    raw.write_bytes(stream.tobytes())
    for skip in ("0", "1"):
        texts = []
        for extra in ([], ["--device-unfold"]):
            out = tmp_path / "o.card"
            assert main(["capture", "--raw-in", str(raw), "-o", str(out),
                         "--quiet", "--carrier-window", "7-110", "-k",
                         skip, "--t0", "1.5e9", "--block-size", "2048",
                         "--history", "256", "--batch-size", "4",
                         "--device", "cpu"] + extra) == 0
            texts.append(out.read_text())
        assert texts[0] == texts[1], skip
        assert 0 < texts[0].count("\n") - 4 < 11


def test_record_cards_flushes_on_stream_error():
    """A dying stream leaves the archive and the counts of what reached
    the host (one batch is in flight)."""
    gate = capture.CarrierGate(BLOCK, (7, 110), THRESH, history_len=HISTORY,
                               device="cpu")
    rows = np.full((4, 2 * BLOCK), 128, np.uint8)

    def batches():
        yield np.arange(4.0), np.arange(4), rows
        yield np.arange(4.0) + 4, np.arange(4) + 4, rows
        raise IOError("stream died")

    out, stats = io_mod.StringIO(), {}
    with pytest.raises(IOError):
        capture.record_cards(gate, batches(), 4, out, stats=stats)
    assert stats == {"read": 8, "written": 0}


def live_args(cmd, port):
    return [cmd, "--rtl-tcp", "127.0.0.1:%d" % port, "--quiet",
            "--carrier-window", "7-110", "--block-size", "2048",
            "--history", "256", "--batch-size", "4", "--t0", "0",
            "--device", "cpu"]


def test_capture_rtl_tcp_matches_file(tmp_path):
    _, stream = bursty_stream()
    raw = tmp_path / "s.bin"
    raw.write_bytes(stream.tobytes())
    srv = FakeRtlTcpServer(payload=stream.tobytes())
    live = tmp_path / "live.card"
    assert main(live_args("capture", srv.port)
                + ["-o", str(live), "-k", "0"]) == 0
    srv.join()
    assert (rtl_tcp.CMD_SET_FREQ, 433830000) in srv.commands
    assert any("tuner:" in ln for ln in open(live) if ln.startswith("#"))
    ref = tmp_path / "file.card"
    assert main(["capture", "--raw-in", str(raw), "-o", str(ref), "-k",
                 "0"] + live_args("capture", 0)[3:]) == 0
    assert card_lines(str(live)) == card_lines(str(ref))
    assert len(card_lines(str(ref))) >= 3


@pytest.mark.parametrize("extra", [[], ["--device-unfold"]])
def test_detect_rtl_tcp_matches_file(tmp_path, extra):
    _, stream = bursty_stream()
    np.save(tmp_path / "t.npy", TPL)
    raw = tmp_path / "s.bin"
    raw.write_bytes(stream.tobytes())
    tpl = ["--template", str(tmp_path / "t.npy")]
    srv = FakeRtlTcpServer(payload=stream.tobytes())
    live = tmp_path / "live.toad"
    assert main(live_args("detect", srv.port) + tpl + extra
                + ["-o", str(live)]) == 0
    srv.join()
    ref = tmp_path / "file.toad"
    assert main(["detect", str(raw), "--raw", "-o", str(ref)]
                + live_args("detect", 0)[3:] + tpl) == 0
    assert live.read_text() == ref.read_text()
    assert len(ref.read_text().splitlines()) >= 3


def test_live_source_errors_exit_nonzero(tmp_path, capsys):
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens there now
    np.save(tmp_path / "t.npy", TPL)
    for cmd in ("detect", "capture"):
        args = live_args(cmd, port) + ["-o", str(tmp_path / "x")]
        if cmd == "detect":
            args += ["--template", str(tmp_path / "t.npy")]
        assert main(args) == 1
        assert "stream error" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["capture", "--raw-in", RAW0, "--rtl-tcp", "x:1",
              "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["detect", RAW0, "--rtl-tcp", "x:1", "--device", "cpu"])


def test_capture_cuda_without_card_raises(tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.card"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["capture", "--raw-in", RAW0, "-o", str(out), "--quiet",
              "--device", "cuda"])
    assert not out.exists()
