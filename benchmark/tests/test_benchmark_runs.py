"""Whole runs of every cell on the CPU at a small size: the window drives
the port's ``detect_batches`` and the frozen reference judges its
``.toad`` records; with the timed path broken underneath, the same run
comes out not correct."""

import pytest
import torch

from benchmark.harness import cells, session

SPEC = cells.manifest()
# The manifest's cells, and those PERF.md keeps for later (their files
# are in benchmark/configs and benchmark/traffic).
CELLS = SPEC["workloads"] + [
    {"name": "rx_example.pipe_devunfold", "config": "rx_example",
     "traffic": "tx5_1hz_pipe_devunfold", "chips": 1},
    {"name": "rx_fastdet.pipe_gated", "config": "rx_fastdet",
     "traffic": "tx5_1hz_pipe_devunfold", "chips": 1},
    {"name": "rx_example.card_replay", "config": "rx_example",
     "traffic": "tx5_1hz_card", "chips": 1},
]
BY_NAME = {c["name"]: c for c in CELLS}
# A size a CPU test holds: 32-block base stream, batches of 8.
SMALL = {"base_blocks": 32, "batch_size": 8, "card_lines": 64,
         "warmup_batches": 2}


def run(workload, seed=2 ** 31 + 11, seconds=2.0, **kw):
    return session.run_cell(BY_NAME[workload], seed, seconds, False,
                            device="cpu", sizes=SMALL, **kw)


@pytest.mark.parametrize("workload", sorted(BY_NAME))
def test_reference_agrees_with_the_port(workload):
    r = run(workload)
    info = r["info"]
    assert info["batches"] > 0 and info["records"] > 0
    assert r["correct"], r["checks"]
    metrics = session.end_to_end(r)
    assert metrics["iq_samples_per_s"] > 0
    assert metrics["setup_s"] > 0


def _patch_outputs(monkeypatch, change):
    from thrifty_tpu_torch.dsp.detector import BatchDetector

    inner = BatchDetector._finish_outputs

    def broken(self, *args):
        return change(inner(self, *args))

    monkeypatch.setattr(BatchDetector, "_finish_outputs", broken)


def _half_left_out(out):
    out = dict(out)
    half = out["detected"].shape[0] // 2
    out["detected"] = out["detected"].clone()
    out["detected"][half:] = False
    return out


def _answer_altered(out):
    out = dict(out)
    out["corr_offset"] = out["corr_offset"] + 0.05
    return out


def _peak_altered(out):
    # A power/peak output a thousandth off: the carrier peak magnitude.
    out = dict(out)
    out["carrier_energy"] = out["carrier_energy"] * 1.001
    return out


def _noise_altered(out):
    out = dict(out)
    out["carrier_noise"] = out["carrier_noise"] * 1.001
    return out


FAULTS = {"half_left_out": _half_left_out, "answer_altered": _answer_altered,
          "peak_altered": _peak_altered, "noise_altered": _noise_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["state_unchanged"])
def test_faults_are_not_correct(monkeypatch, fault):
    if fault in FAULTS:
        _patch_outputs(monkeypatch, FAULTS[fault])
    else:
        from thrifty_tpu_torch.dsp import unfold

        inner = unfold.unfold_stream

        def unchanged(new_u8, carry_u8, block_len, history_len):
            rows, _ = inner(new_u8, carry_u8, block_len, history_len)
            return rows, carry_u8

        monkeypatch.setattr(unfold, "unfold_stream", unchanged)
    r = run("rx_example.pipe_devunfold")
    assert r["info"]["batches"] > 0
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_is_not_correct_on_card():
    """The control (the configuration's TF32 matmul transforms) fails
    the comparison at a size a test holds; the card alone has TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    settings = cells.config("rx_example")
    r = session.run_cell(BY_NAME["rx_example.pipe_devunfold"], 2 ** 31 + 3,
                         3.0, False, device="cuda",
                         overrides=settings["control"])
    assert not r["correct"], r["checks"]



def test_no_result_without_a_card():
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(cells.BENCH_DIR, "run.py"),
         "--workload", CELLS[0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=cells.REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr

