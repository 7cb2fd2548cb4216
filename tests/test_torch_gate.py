"""The port's carrier-gated correlation compaction (``gate_capacity``) on
the CPU, against the JAX GATED detector.

The gate changes what carrier-negative rows report (zeros / not
detected, on filler rows and on the full-batch overflow fallback alike,
thrifty_tpu/dsp/detector.py:564-589), so the reference is the JAX
detector with the same ``gate_capacity`` (``use_pallas='off'``: JAX
refuses the gate beside its kernel), not the ungated one.  The cases
mirror tests/test_gate.py at the small geometry of
tests/test_torch_detector.py (block 2048, history 256, a 5-bit Gold
template).  Tolerances: test_torch_detector's ``TOLS`` (decisions, bins
and lags exact; offsets atol 2e-3 / 1e-3; magnitudes rtol 1e-4); the
zeros of carrier-negative rows are exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_detector import BLOCK, HISTORY, TPL, \
    assert_outputs_match  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402

CORR_FIELDS = ("corr_sample", "corr_offset", "corr_energy", "corr_noise")
KW = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110))


@pytest.fixture(scope="module")
def cap():
    return sim.synth_capture(
        num_blocks=24, bursts_every=3, template=TPL, block_len=BLOCK,
        history_len=HISTORY, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=7)


@pytest.fixture(scope="module")
def n_carrier(cap):
    det = BatchDetector(TPL, DetectorConfig(**KW), device="cpu")
    return int(det(cap.blocks)["carrier_detect"].sum())


def detectors(capacity, **kw):
    jdet = JaxDetector(TPL, JaxConfig(use_pallas="off",
                                      gate_capacity=capacity, **KW, **kw))
    tdet = BatchDetector(TPL, DetectorConfig(gate_capacity=capacity, **KW,
                                             **kw), device="cpu")
    return jdet, tdet


def check_gated(got, ref, batch):
    """Port vs JAX gated outputs, plus the uniform carrier-negative
    contract on the port's side."""
    assert_outputs_match(got, ref)
    neg = ~got["carrier_detect"].numpy()
    for k in CORR_FIELDS:
        assert (got[k].numpy()[neg] == 0).all(), k
    assert not got["detected"].numpy()[neg].any()
    assert batch.overflowed is not None


def run(tdet, blocks):
    batch = tdet.submit(blocks)
    return batch.result(), batch


@pytest.mark.parametrize("capacity", [3, 8, 12, 23])
def test_gated_matches_jax_gated(cap, n_carrier, capacity):
    jdet, tdet = detectors(capacity)
    got, batch = run(tdet, cap.blocks)
    check_gated(got, jdet(cap.blocks), batch)
    assert batch.overflowed == (n_carrier > capacity)
    assert tdet.gate_overflows == int(batch.overflowed)


def test_capacities_cover_both_branches(n_carrier):
    assert 3 < n_carrier <= 12


def test_boundary_capacities(cap, n_carrier):
    """Exactly at capacity stays gated (filler-free compaction); one
    below overflows and re-runs the full batch."""
    for capacity, overflow in ((n_carrier, False), (n_carrier - 1, True)):
        jdet, tdet = detectors(capacity)
        got, batch = run(tdet, cap.blocks)
        check_gated(got, jdet(cap.blocks), batch)
        assert batch.overflowed is overflow


def test_gate_equals_ungated_on_carrier_rows(cap):
    """On carrier-positive rows the gate is invisible: the port's gated
    outputs equal its ungated ones there, bit for bit (the same row-wise
    program on gathered rows)."""
    full = BatchDetector(TPL, DetectorConfig(**KW), device="cpu")(cap.blocks)
    gated = BatchDetector(TPL, DetectorConfig(gate_capacity=12, **KW),
                          device="cpu")(cap.blocks)
    pos = full["carrier_detect"]
    for k in full:
        assert torch.equal(full[k][pos], gated[k][pos]), k


@pytest.mark.parametrize("capacity", [5, 12])
def test_integer_sync(cap, capacity):
    jdet, tdet = detectors(capacity, sync_mode="integer")
    got, batch = run(tdet, cap.blocks)
    check_gated(got, jdet(cap.blocks), batch)


def test_stream_path(cap):
    raw = jiq.iq_to_raw(cap.blocks[:, HISTORY:].reshape(-1))
    half = raw.size // 2
    jdet, tdet = detectors(5)
    for part in (raw[:half], raw[half:]):
        batch = tdet.submit_raw_stream(part)
        check_gated(batch.result(), jdet.detect_raw_stream(part), batch)


def test_pure_noise_batch():
    """No carriers: every gathered row is filler, nothing detected,
    nothing NaN."""
    rng = np.random.default_rng(11)
    noise = ((rng.standard_normal((16, BLOCK))
              + 1j * rng.standard_normal((16, BLOCK))) * 0.05
             ).astype(np.complex64)
    jdet, tdet = detectors(4)
    got, batch = run(tdet, noise)
    check_gated(got, jdet(noise), batch)
    assert not batch.overflowed
    assert not got["detected"].any()
    for k, v in got.items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k


def test_all_bursts_batch_falls_back():
    """A burst in every block: the capacity overflows and the full-batch
    fallback detects what the JAX fallback detects."""
    dense = sim.synth_capture(
        num_blocks=16, bursts_every=1, template=TPL, block_len=BLOCK,
        history_len=HISTORY, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=5)
    jdet, tdet = detectors(4)
    got, batch = run(tdet, dense.blocks)
    check_gated(got, jdet(dense.blocks), batch)
    assert batch.overflowed
    assert got["detected"][1:].all()


def test_capacity_at_or_above_batch_is_ungated(cap):
    tdet = BatchDetector(TPL, DetectorConfig(gate_capacity=24, **KW),
                         device="cpu")
    batch = tdet.submit(cap.blocks)
    assert batch.overflowed is None
    full = BatchDetector(TPL, DetectorConfig(**KW), device="cpu")(cap.blocks)
    for k, v in batch.result().items():
        assert torch.equal(v, full[k]), k
    assert batch.overflowed is None  # no flag, no host read


def test_negative_capacity_raises():
    with pytest.raises(ValueError, match="gate_capacity"):
        BatchDetector(TPL, DetectorConfig(gate_capacity=-1, **KW),
                      device="cpu")


def test_compaction_gathers_carrier_rows_in_order(cap, monkeypatch):
    """The correlation stage sees the carrier rows first, in index order,
    then filler rows (a stable sort of integer keys)."""
    tdet = BatchDetector(TPL, DetectorConfig(gate_capacity=12, **KW),
                         device="cpu")
    seen = []
    orig = tdet._corr_stage

    def spy(src, c_idx, c_off, energy):
        seen.append(src.clone())
        return orig(src, c_idx, c_off, energy)

    monkeypatch.setattr(tdet, "_corr_stage", spy)
    out = tdet(cap.blocks)
    pos = np.flatnonzero(out["carrier_detect"].numpy())
    neg = np.flatnonzero(~out["carrier_detect"].numpy())
    order = np.concatenate([pos, neg])[:12]
    assert len(seen) == 1 and seen[0].shape == (12, BLOCK)
    assert torch.equal(seen[0], torch.from_numpy(cap.blocks[order]))


def test_cli_gate_matches_jax_cli(tmp_path):
    """detect --gate-capacity on a raw stream through both CLIs, with a
    capacity that overflows some batches and not others."""
    from thrifty_tpu.cli import main as jax_main
    from thrifty_tpu_torch.cli import main

    np.save(tmp_path / "t.npy", TPL)
    bursts = [{"position": p, "carrier_bin": 40.25, "amplitude": 0.8,
               "phase": 0.3} for p in (2500.0, 4300.0, 6100.0, 15000.0)]
    stream = sim.synth_stream(18000, bursts, TPL, block_len=BLOCK, seed=4)
    (tmp_path / "s.bin").write_bytes(jiq.iq_to_raw(stream).tobytes())
    outs = {}
    for name, run_cli, extra in (("jax", jax_main, []),
                                 ("port", main, ["--device", "cpu"])):
        outs[name] = tmp_path / (name + ".toad")
        assert run_cli(["detect", str(tmp_path / "s.bin"), "--raw",
                        "--quiet", "-o", str(outs[name]), "--t0", "0",
                        "--template", str(tmp_path / "t.npy"),
                        "--block-size", "2048", "--history", "256",
                        "--carrier-window", "7-110", "--batch-size", "4",
                        "--gate-capacity", "1"] + extra) == 0
    ref = np.atleast_2d(np.loadtxt(outs["jax"]))
    got = np.atleast_2d(np.loadtxt(outs["port"]))
    assert got.shape == ref.shape and len(ref) >= 3
    np.testing.assert_array_equal(got[:, [0, 2, 4, 8]], ref[:, [0, 2, 4, 8]])
    np.testing.assert_allclose(got[:, 3], ref[:, 3], atol=1e-3)
