"""The port's deployment supervisor (deploy/detect_torch.sh) on the CPU:
the shutdown semantics of tests/test_deploy.py, the port's CLI in both
of its branches, and a raw capture streamed through its FIFO into a
.toad that holds the planted bursts."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.dsp import iq, template as template_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "deploy", "detect_torch.sh")
UNIT = os.path.join(REPO, "deploy", "detector_torch.service")
needs_bash = pytest.mark.skipif(not os.path.exists("/bin/bash"),
                                reason="needs bash")


def supervisor_env(tmp_path, cfg, capture_cmd):
    return dict(
        os.environ,
        CONFIG=str(cfg),
        OUTPUT=str(tmp_path / "rx.toad"),
        FIFO=str(tmp_path / "capture.fifo"),
        CAPTURE_CMD=capture_cmd,
        DEVICE="cpu",
        PYTHON=sys.executable,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PATH=os.environ["PATH"],
    )


def stop(proc, seconds=20):
    """SIGTERM the supervisor; it must exit within ``seconds``.
    Returns the seconds it took."""
    os.kill(proc.pid, signal.SIGTERM)
    t0 = time.time()
    try:
        proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        pytest.fail("detect_torch.sh did not exit within {} s of SIGTERM "
                    "(trap re-entry livelock)".format(seconds))
    return time.time() - t0


@needs_bash
def test_sigterm_shuts_down_promptly(tmp_path):
    """systemctl stop sends TERM: cleanup's `kill 0` re-delivers TERM
    to the supervisor shell itself, which must NOT re-enter the trap in
    a loop."""
    cfg = tmp_path / "detector.cfg"
    cfg.write_text("block_size: 2048\nblock_history: 600\n"
                   "carrier_window: 7 - 110\n")
    # New session: the script's `kill 0` must signal ITS process group,
    # not pytest's.
    proc = subprocess.Popen(
        ["/bin/bash", SCRIPT],
        env=supervisor_env(tmp_path, cfg, "sleep 300"),
        start_new_session=True, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    time.sleep(2.0)  # let it reach the supervised stage
    assert stop(proc) < 15
    assert not (tmp_path / "capture.fifo").exists()


def test_runs_the_port_cli():
    """Both branches (the FIFO and --rtl-tcp) run the port's detect on
    $DEVICE; nothing names the JAX package's CLI; the unit starts this
    script."""
    text = open(SCRIPT).read()
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    assert code.count('"$PYTHON" -m thrifty_tpu_torch.cli detect') == 2
    assert code.count('--device "$DEVICE"') == 2
    assert "DEVICE=${DEVICE:-cuda}" in code
    assert "thrifty_tpu.cli" not in text
    assert os.access(SCRIPT, os.X_OK)
    unit = open(UNIT).read()
    assert "ExecStart=/usr/local/lib/thrifty-tpu/detect_torch.sh" in unit
    assert "detect.sh" not in unit.replace("detect_torch.sh", "")


@needs_bash
def test_streams_a_raw_capture_through_the_fifo(tmp_path):
    """A raw capture fed through the FIFO reaches the .toad while the
    supervisor runs, and SIGTERM then stops it promptly.  The capture is
    followed by zero-signal bytes, as a live radio keeps streaming: the
    reader fills 256 KiB chunks and a batch is written once the next
    one is queued, so the tail must cover a chunk and two batches."""
    block, history, batch = 2048, 256, 8
    tpl = template_mod.generate(5, 0, 2.0)
    cap = sim.synth_capture(
        num_blocks=4 * batch, bursts_every=2, template=tpl,
        block_len=block, history_len=history, carrier_bin=40.25,
        amplitude=0.8, noise_std=0.05, seed=3)
    raw = tmp_path / "capture.raw"
    tail = np.full((1 << 18) + 2 * batch * 2 * (block - history), 128,
                   np.uint8)
    np.concatenate([iq.iq_to_raw(cap.blocks[:, history:].reshape(-1)),
                    tail]).tofile(str(raw))
    np.save(str(tmp_path / "template.npy"), tpl)
    cfg = tmp_path / "detector.cfg"
    cfg.write_text(
        "block_size: {}\nblock_history: {}\ncarrier_window: 20 - 60\n"
        "batch_size: {}\ntemplate: {}\n".format(
            block, history, batch, tmp_path / "template.npy"))
    feed = tmp_path / "feed.sh"
    feed.write_text("cat '{}'\nexec sleep 300\n".format(raw))
    planted = {b.block_idx for b in cap.bursts}
    proc = subprocess.Popen(
        ["/bin/bash", SCRIPT],
        env=supervisor_env(tmp_path, cfg, "/bin/sh " + str(feed)),
        start_new_session=True, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    toad = tmp_path / "rx.toad"

    def detected_blocks():
        if not toad.exists():
            return set()
        text = toad.read_text()
        text = text[:text.rfind("\n") + 1]  # whole lines only
        rows = np.loadtxt(text.splitlines(), ndmin=2) if text.strip() \
            else np.zeros((0, 3))
        return set(rows[:, 2].astype(int).tolist())

    deadline = time.time() + 120
    while not planted <= detected_blocks():
        if proc.poll() is not None or time.time() > deadline:
            os.killpg(proc.pid, signal.SIGKILL)
            pytest.fail("the supervisor stopped or stalled before the "
                        "planted bursts reached the .toad")
        time.sleep(0.2)
    assert stop(proc) < 15
    assert planted <= detected_blocks()
    assert not (tmp_path / "capture.fifo").exists()
