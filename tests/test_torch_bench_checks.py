"""The port's graded ``bench`` programs (selfcheck, abcheck) and the
bench's usage errors, against the JAX bench.

Every selfcheck/abcheck case of ``tests/test_bench.py`` runs on the port
in process at ``--device cpu`` with the JAX test's assertions;
``parse_config_overrides``, ``_field_diffs`` and the knee abcheck are
held against the root ``bench.py``'s own functions on the same inputs.
A usage error exits 2 before any power/peak launch.

The JAX package is imported inside the tests, so the ``cuda`` test at
the end runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_bench_checks.py``.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import bench, sim  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.dsp.detector import (  # noqa: E402
    BatchDetector, DetectorConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_FIELDS = ("detected", "carrier_detect", "carrier_bin", "corr_sample",
              "template_idx")


def jax_bench():
    sys.path.insert(0, ROOT)
    import bench as root_bench

    return root_bench


@pytest.fixture(autouse=True)
def lastgood(tmp_path, monkeypatch):
    """Each test keeps its last-good figures in its own file."""
    path = str(tmp_path / "bench_lastgood.json")
    monkeypatch.setattr(bench, "_lastgood_path", lambda: path)
    return path


def run_bench(capsys, args, device="cpu"):
    """rc and the last JSON line of ``bench <args> --device <device>``."""
    rc = main(["bench"] + list(args) + ["--device", device])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    return rc, json.loads(line)


def test_selfcheck_program(capsys):
    """The detector on --device against its plain CPU run: passes, with
    both devices named (here both sides are the plain version)."""
    rc, data = run_bench(capsys, ["--program", "selfcheck", "--batch", "16"])
    assert rc == 0
    assert data["metric"] == "pallas_xla_selfcheck"
    assert data["value"] == 1.0
    assert data["devices"] == {"on": "cpu", "off": "cpu"}
    d = data["field_diffs"]
    assert d["detected"] == 0 and d["corr_sample"] == 0
    assert d["corr_offset"] <= 1e-3
    assert all(d["stream_" + k] == 0 for k in INT_FIELDS)


def test_selfcheck_wide_program(capsys):
    rc, data = run_bench(capsys, ["--program", "selfcheck", "--batch", "16",
                                  "--wide"])
    assert rc == 0
    assert data["value"] == 1.0 and data["wide"] is True
    d = data["field_diffs"]
    for cfg in ("parabolic_polyfit", "autocorr_integer", "maximise",
                "stddev"):
        assert d[cfg + ":detected"] == 0, cfg
        assert d[cfg + ":corr_sample"] == 0, cfg


def test_abcheck_program(capsys):
    """carrier_fast off-vs-auto under the matmul impl exercises the
    windowed carrier path."""
    rc, data = run_bench(capsys, ["--program", "abcheck", "--batch", "16",
                                  "--fft-impl", "matmul", "--ab",
                                  "carrier_fast=off"])
    assert rc == 0
    assert data["metric"] == "config_abcheck"
    assert data["value"] == 1.0
    assert data["ab"] == {"carrier_fast": "off"}
    d = data["field_diffs"]
    assert d["detected"] == 0 and d["corr_sample"] == 0


def test_abcheck_knee_program(capsys):
    """matmul-vs-xla through the knee: flip-free, SoAs equal on the
    both-detected blocks, and the sweep straddles the knee."""
    rc, data = run_bench(capsys, ["--program", "abcheck", "--batch", "32",
                                  "--fft-impl", "matmul", "--ab",
                                  "fft_impl=xla", "--ab-knee"])
    assert rc == 0
    assert data["metric"] == "config_abcheck_knee"
    assert data["value"] == 1.0
    k = data["knee"]
    assert k["n_blocks"] == 32
    assert 0 < k["n_both"] < k["n_blocks"]
    assert k["n_flips"] == 0 or k["max_flip_margin_rel"] <= k["band"]
    assert k["sample_mismatch_both"] == 0
    assert k["max_corr_off_diff_both"] <= 1e-3


def test_abcheck_knee_gate(capsys):
    rc, data = run_bench(capsys, ["--program", "abcheck", "--batch", "32",
                                  "--ab", "gate_capacity=16", "--ab-knee"])
    assert rc == 0
    assert data["metric"] == "config_abcheck_knee"
    assert data["value"] == 1.0
    assert data["ab"] == {"gate_capacity": 16}


def test_abcheck_gate_wired(capsys):
    """An explicit --gate reaches the abcheck base config (both sides
    gated) and is recorded; without it the base stays ungated."""
    rc, data = run_bench(capsys, ["--program", "abcheck", "--batch", "16",
                                  "--gate", "8", "--fft-impl", "matmul",
                                  "--ab", "carrier_fast=off"])
    assert rc == 0
    assert data["value"] == 1.0
    assert data["gate"] == 8
    rc, data = run_bench(capsys, ["--program", "abcheck", "--batch", "16",
                                  "--fft-impl", "matmul", "--ab",
                                  "carrier_fast=off"])
    assert rc == 0
    assert data["gate"] == 0


def test_gate_batch_program(capsys):
    """--gate wires into the timed batch program and its sweep."""
    rc, data = run_bench(capsys, ["--batch", "16", "--iters", "2",
                                  "--repeats", "1", "--scan-k", "2",
                                  "--sweep", "8,16", "--gate", "8",
                                  "--skip-baseline"])
    assert rc == 0
    assert data["metric"] == "detect_throughput" and data["value"] > 0
    assert data["gate"] == 8


USAGE_ERRORS = [
    (["--program", "abcheck", "--batch", "16"], "--ab"),
    (["--program", "abcheck", "--ab", "gate_capacity=8"], "ab-knee"),
    (["--program", "abcheck", "--ab", "fft_precison=high"],
     "unknown DetectorConfig field"),
    (["--program", "abcheck", "--ab", "gate_capacity=lots", "--ab-knee"],
     "not a valid value"),
    (["--program", "abcheck", "--ab", "carrier_thresh=0"],
     "not overridable"),
    (["--program", "e2e", "--input", "raw", "--feeds", "2"], "ingest"),
    (["--input", "card"], "only meaningful with --program e2e"),
    (["--program", "e2e", "--input", "c64"], "--input c64"),
    (["--device-unfold"], "--device-unfold applies"),
    (["--ab", "fft_impl=matmul"], "--program abcheck only"),
    (["--ab-knee"], "--program abcheck only"),
]


@pytest.mark.parametrize("args,message", USAGE_ERRORS)
def test_usage_errors(capsys, args, message):
    """The JAX bench's usage errors (tests/test_bench.py), and the
    port's: --ab/--ab-knee outside --program abcheck; each exits 2 with
    the message before any launch."""
    pp.launches = 0
    with pytest.raises(SystemExit) as e:
        main(["bench", "--device", "cpu"] + args)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert pp.launches == 0


@pytest.mark.parametrize("args", [
    ["--pallas", "off"],
    ["--program", "abcheck", "--ab", "use_pallas=off"]])
def test_pallas_off_on_the_card_is_a_usage_error(capsys, args):
    """The card has no plain reductions: --pallas off (or an A/B to it)
    with --device cuda is refused before the device is even resolved,
    so it is the same usage error with or without a card."""
    pp.launches = 0
    with pytest.raises(SystemExit) as e:
        main(["bench", "--device", "cuda"] + args)
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert pp.launches == 0


def test_pallas_off_runs_on_the_cpu(capsys):
    rc, data = run_bench(capsys, ["--pallas", "off", "--batch", "8",
                                  "--iters", "1", "--scan-k", "1",
                                  "--repeats", "1", "--oracle-blocks", "1",
                                  "--sweep", "none"])
    assert rc == 0 and data["pallas"] == "off" and data["gate"] == 4


OVERRIDES = ["fft_precision=high", "gate_capacity=128,carrier_fast=off",
             "use_pallas=on, num_preshift = 5", "interp_width=4.5",
             "gate_capacity=12x", "no_such=1", "carrier_window=7",
             "sync_mode", "", "corr_thresh=(0, 15, 0)"]


@pytest.mark.parametrize("text", OVERRIDES)
def test_parse_config_overrides_matches_jax(text):
    """The port's parser gives the root bench.py's result, or its usage
    error word for word, on the same text."""
    def outcome(parse):
        errors = []

        def error(msg):
            errors.append(msg)
            raise SystemExit(msg)

        try:
            return parse(text, error)
        except SystemExit:
            return errors

    assert outcome(bench.parse_config_overrides) == outcome(
        jax_bench().parse_config_overrides)


def test_field_diffs_matches_jax():
    """The port's per-field diff equals the root bench.py's on the same
    two output dicts: mismatch counts, absolute and relative maxima."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n = 64

    def outputs(seed_shift):
        r = np.random.default_rng(seed_shift)
        return {
            "detected": r.random(n) < 0.5,
            "carrier_bin": r.integers(0, 4, n).astype(np.int32),
            "corr_offset": r.normal(size=n).astype(np.float32),
            "corr_energy": (r.random(n) * 10).astype(np.float32),
            "carrier_noise": np.zeros(n, np.float32),
        }

    a, b = outputs(1), outputs(2)
    b["carrier_noise"][:3] = rng.random(3).astype(np.float32)
    got = bench._field_diffs({k: torch.from_numpy(v) for k, v in a.items()},
                             {k: torch.from_numpy(v) for k, v in b.items()})
    want = {k: float(v) for k, v in jax_bench()._field_diffs(
        {k: jnp.asarray(v) for k, v in a.items()},
        {k: jnp.asarray(v) for k, v in b.items()}).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_card_vs_plain_compares_each_field_on_its_rows():
    """Decisions on every row; carrier fields on the plain side's
    carrier rows, corr fields on its detected rows (another FFT
    library's noise argmax elsewhere is not a difference)."""
    plain = {"detected": torch.tensor([True, False, False]),
             "carrier_detect": torch.tensor([True, True, False]),
             "carrier_bin": torch.tensor([40, 41, 7], dtype=torch.int32),
             "carrier_offset": torch.tensor([0.1, 0.2, 0.0]),
             "corr_sample": torch.tensor([9000, 3, 0], dtype=torch.int32),
             "corr_energy": torch.tensor([100.0, 5.0, 0.0])}
    card = {k: v.clone() for k, v in plain.items()}
    card["carrier_bin"][2] = 99        # carrier-negative row: ignored
    card["corr_sample"][1] = 5000      # undetected row: ignored
    card["corr_energy"][1] = 9.0       # undetected row: ignored
    card["carrier_offset"][0] += 5e-4  # a carrier row: measured
    d = bench._card_vs_plain(card, plain)
    assert d["carrier_bin"] == 0 and d["corr_sample"] == 0
    assert d["corr_energy"] == 0
    assert d["carrier_offset"] == pytest.approx(5e-4, rel=1e-3)
    card["detected"][2] = True         # a flipped decision counts
    card["carrier_bin"][1] = 42        # so does a carrier row's bin
    d = bench._card_vs_plain(card, plain)
    assert d["detected"] == 1 and d["carrier_bin"] == 1


def test_selfcheck_fails_on_a_difference(monkeypatch, capsys):
    """A side that disagrees fails the selfcheck: value 0.0, rc 1."""
    real = BatchDetector.detect_raw

    def off_by_one(self, raw):
        out = dict(real(self, raw))
        if self.config.use_pallas == "on":
            out["corr_sample"] = out["corr_sample"] + 1
        return out

    monkeypatch.setattr(BatchDetector, "detect_raw", off_by_one)
    rc, data = run_bench(capsys, ["--program", "selfcheck", "--batch", "8"])
    assert rc == 1 and data["value"] == 0.0
    assert data["field_diffs"]["corr_sample"] > 0


def test_knee_matches_jax():
    """The knee abcheck's counts on the CPU equal JAX's, within the
    blocks whose deciding gate lies in the band (margin <= 1e-3), where
    float32 reassociation may flip a decision."""
    batch, band = 32, 1e-3
    tpl = sim.make_template()
    ok, got = bench.bench_abcheck_knee(
        tpl, batch, DetectorConfig(carrier_window=(7, 110)),
        {"fft_impl": "matmul"}, device="cpu")
    from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig

    jax_ok, want = jax_bench().bench_abcheck_knee(
        tpl, batch, JaxConfig(carrier_window=(7, 110)),
        {"fft_impl": "matmul"})
    assert ok and jax_ok
    from thrifty_tpu_torch.dsp import iq

    cfg = DetectorConfig(carrier_window=(7, 110))
    out = BatchDetector(tpl, cfg, device="cpu").detect_raw(
        iq.iq_to_raw(bench.knee_blocks(tpl, batch)))
    in_band = int(torch.sum(bench.gate_margin(
        out, cfg.carrier_thresh, cfg.corr_thresh) <= band))
    assert got["n_blocks"] == want["n_blocks"] == batch
    for k in ("carrier_a", "detected_a"):
        assert abs(got[k] - want[k]) <= in_band, k
    assert 0 < got["detected_a"] < batch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_selfcheck_on_the_card(cuda_device, capsys):
    """selfcheck --wide at batch 256: the detector on the card (the
    power/peak kernel) against the same detector on the CPU."""
    rc, data = run_bench(capsys, ["--program", "selfcheck", "--wide"],
                         device="cuda")
    assert rc == 0 and data["value"] == 1.0
    assert data["devices"]["on"].startswith("cuda:")
    assert data["devices"]["off"] == "cpu"
    d = data["field_diffs"]
    assert all(d[k] == 0 and d["stream_" + k] == 0 for k in INT_FIELDS)
