"""The port's ``bench`` command against the JAX bench's contract.

Every case of ``tests/test_bench.py`` runs on the port through
``python -m thrifty_tpu_torch.cli bench`` in process, at ``--device cpu``
and batch 8 (the timed programs, ``stream``, ``e2e``, ``serve``), with
the JAX test's contract assertions; ``scaling_verdict`` and
``bench_serve`` are held against the root ``bench.py``'s own functions on
the same inputs.  The graded programs (selfcheck, abcheck) are in
``tests/test_torch_bench_checks.py``.

The JAX package is imported inside the tests, so the ``cuda`` tests at
the end run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_bench.py``.
"""

import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import bench  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_BYTES = 2 * (16384 - 4920)


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


def check_contract(data):
    """tests/test_bench.py's check_contract, on the port's line."""
    assert set(data) >= {"metric", "value", "unit", "vs_baseline"}
    assert data["metric"] == "detect_throughput"
    assert data["unit"] == "IQ_samples/s/chip"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0
    assert data["relay_degraded"] in (False, True)
    assert len(data["runs_sec_per_batch"]) >= 1
    assert all(math.isfinite(r) for r in data["runs_sec_per_batch"])
    assert (any(r > 0 for r in data["runs_sec_per_batch"])
            or data.get("slope_unresolved") is True)
    assert {"batch", "iters", "sync_mode", "pallas", "input"} <= set(data)
    return data


def test_bench_default_contract(capsys):
    rc, data = run_bench(capsys, ["--batch", "8", "--iters", "2",
                                  "--scan-k", "2", "--oracle-blocks", "2",
                                  "--sweep", "none"])
    assert rc == 0
    check_contract(data)
    assert data["headline_batch"] == 8
    assert data["anomalously_fast"] in (False, True)
    # The K/2K chain issued from the host (CUDA events on the card, the
    # host clock here) replaces JAX's in-program scan slope; the
    # dispatch chain is recorded alongside.
    assert data["method"] == "event_slope"
    assert data["scan_k"] == 2
    assert data["device"] == "cpu" and data["clock"] == "host"
    assert data["dispatch_chain_sec_per_batch"] > 0
    assert len(data["scan_dispatch_times"]["t_k_s"]) == 3
    assert len(data["scan_dispatch_times"]["t_2k_s"]) == 3
    assert data["gate"] == 4  # auto: batch // 2


def test_bench_batch_sweep_scaling(capsys):
    """The sweep records per-size timings, the JAX verdict and an affine
    fit over every size; the headline stays at --batch whatever the
    verdict (the port's departure from the JAX bench)."""
    rc, data = run_bench(capsys, ["--batch", "8", "--iters", "2",
                                  "--skip-baseline", "--scan-k", "2",
                                  "--sweep", "2,4,8"])
    assert rc == 0
    check_contract(data)
    assert set(data["batch_sweep_sec"]) == {"2", "4", "8"}
    assert set(data["batch_sweep_samples_per_s"]) == {"2", "4", "8"}
    sc = data["scaling"]
    assert sc["verdict"] in ("linear", "scale_economy") \
        or sc["verdict"].startswith("floor_limited_above_"), sc
    assert sc["linear_up_to"] in (2, 4, 8)
    assert set(sc["ratios"]) == {"2->4", "4->8"}
    assert set(sc["fit_all_sizes"]) == {"fixed_cost_s",
                                        "slope_s_per_block"}
    assert data["headline_batch"] == 8
    if len(data["runs_sec_per_batch"]) == 3 \
            and not data.get("slope_unresolved"):
        expect = data["batch_sweep_samples_per_s"]["8"]
        assert abs(data["value"] - expect) <= 0.51


@pytest.mark.parametrize("floor", [False, True])
def test_headline_at_batch_whatever_the_verdict(capsys, monkeypatch,
                                                floor):
    """A sweep whose time does not grow with the batch (the card's
    launch-bound regime) reads as floor-limited, and the headline still
    comes from --batch, at its own median."""
    sec = {2: 1e-3, 4: 1e-3 if floor else 2e-3, 8: 1e-3 if floor else 4e-3}

    def fake_slope(det, blocks_list, k, raw_input=False, repeats=3):
        s = sec[len(blocks_list[0])]
        return [s] * repeats, [s] * repeats, [2 * s] * repeats

    monkeypatch.setattr(bench, "time_tpu_slope", fake_slope)
    monkeypatch.setattr(bench, "time_tpu", lambda *a, **k: 1e-3)
    rc, data = run_bench(capsys, ["--batch", "8", "--sweep", "2,4",
                                  "--oracle-blocks", "1"])
    assert rc == 0
    assert data["scaling"]["verdict"] == (
        "floor_limited_above_2" if floor else "linear")
    assert data["headline_batch"] == 8
    assert data["value"] == round(8 * (16384 - 4920) / sec[8], 1)
    fit = data["scaling"]["fit_all_sizes"]
    assert fit["fixed_cost_s"] == pytest.approx(1e-3 if floor else 0.0,
                                                abs=1e-9)


# tests/test_bench.py::test_scaling_verdict_unit's inputs.
VERDICT_CASES = [
    {64: 1.0, 128: 2.1, 256: 3.9, 512: 7.8},
    {64: 1.0, 128: 1.9, 256: 2.0, 512: 2.1},
    {64: 1.0, 128: 1.0, 256: 1.0},
    {64: 1.0, 128: 1.0, 256: 2.0},
    {64: 0.329, 128: 0.460, 256: 0.718, 512: 1.690},
    {64: 1.0, 128: 1.2, 256: 1.44},
    {64: 64e-5, 128: 128e-5, 256: 256e-5, 300: 300e-5, 512: 512e-5},
    {64: 1.0, 256: 1.39},
]


@pytest.mark.parametrize("case", range(len(VERDICT_CASES)))
def test_scaling_verdict_matches_jax(case):
    """The port's scaling_verdict is the root bench.py's, to the last
    key, on every input of the JAX unit test."""
    sys.path.insert(0, ROOT)
    import bench as jax_bench

    sec = VERDICT_CASES[case]
    assert bench.scaling_verdict(sec) == jax_bench.scaling_verdict(sec)


def test_scaling_verdict_unit():
    """tests/test_bench.py's verdict assertions, on the port's copy."""
    v = bench.scaling_verdict(VERDICT_CASES[0])
    assert v["verdict"] == "linear" and v["linear_up_to"] == 512
    v = bench.scaling_verdict(VERDICT_CASES[1])
    assert v["verdict"] == "floor_limited_above_128"
    assert bench.scaling_verdict(VERDICT_CASES[2])["linear_up_to"] == 64
    assert bench.scaling_verdict(VERDICT_CASES[3])["linear_up_to"] == 64
    v = bench.scaling_verdict(VERDICT_CASES[4])
    assert v["verdict"] == "scale_economy" and v["linear_up_to"] == 512
    assert v["fixed_cost_s"] > 0 and v["slope_s_per_block"] > 0
    v = bench.scaling_verdict(VERDICT_CASES[5])
    assert v["verdict"] == "floor_limited_above_64"
    v = bench.scaling_verdict(VERDICT_CASES[6])
    assert v["verdict"] == "linear" and v["linear_up_to"] == 512
    v = bench.scaling_verdict(VERDICT_CASES[7])
    assert v["verdict"] == "floor_limited_above_64"


def test_bench_c64_and_modes(capsys):
    rc, data = run_bench(capsys, ["--batch", "8", "--iters", "2",
                                  "--skip-baseline", "--input", "c64",
                                  "--sync-mode", "integer", "--scan-k", "2",
                                  "--sweep", "none"])
    assert rc == 0
    check_contract(data)
    assert data["input"] == "c64" and data["sync_mode"] == "integer"


def test_bench_stream_program(capsys):
    """--program stream makes a gloo world of one, times the rank
    program on a (1, 1) mesh and tears the world down."""
    import torch.distributed as dist

    rc, data = run_bench(capsys, ["--batch", "8", "--iters", "2",
                                  "--skip-baseline", "--program", "stream"])
    assert rc == 0
    check_contract(data)
    assert data["program"] == "stream"
    assert data["method"] == "wallclock_chain"
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind,unfold", [("raw", False), ("raw", True),
                                         ("card", False), ("ingest", False),
                                         ("ingest", True)])
def test_bench_e2e_program(capsys, kind, unfold):
    rc, data = run_bench(capsys, ["--program", "e2e", "--batch", "8",
                                  "--e2e-bytes", "3e6", "--input", kind,
                                  "--skip-baseline", "--repeats", "2"]
                         + (["--device-unfold"] if unfold else []))
    assert rc == 0
    assert data["metric"] == "e2e_throughput_" + kind
    assert data["unit"] == "IQ_samples/s"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0
    assert data["device_unfold"] is unfold
    assert len(data["runs_samples_per_s"]) == 2
    assert data["drain"] == ("device-only" if kind == "ingest" else "host")
    chunks = int(3e6) // (8 * NEW_BYTES)
    if kind == "card":
        # Whole batches of .card lines until the file holds 3e6 bytes.
        assert data["blocks"] > 0 and data["blocks"] % 8 == 0
        assert data["file_bytes"] >= 3e6
    else:
        # The JAX test's exact count: 3e6 bytes // (8-block chunks of
        # 2*new_len bytes each) -> 16 chunks of 8 blocks.
        assert data["blocks"] == 8 * chunks == 128


def test_bench_ingest_feeds_aggregate(capsys):
    """--feeds N: N parallel per-receiver feed pumps, aggregate host
    ingest; block accounting exact per feed."""
    rc, data = run_bench(capsys, ["--program", "e2e", "--input", "ingest",
                                  "--feeds", "2", "--e2e-bytes", "6e6",
                                  "--batch", "8", "--skip-baseline"])
    assert rc == 0
    assert data["metric"] == "ingest_throughput_aggregate"
    assert data["unit"] == "IQ_samples/s"
    assert data["feeds"] == 2
    assert data["value"] > 0
    chunks = int(3e6) // (8 * NEW_BYTES)  # per-feed bytes // chunk
    assert data["blocks_per_feed"] == [8 * chunks] * 2


def test_bench_serve_program(capsys):
    rc, data = run_bench(capsys, ["--program", "serve", "--repeats", "1"])
    assert rc == 0
    assert data["metric"] == "serve_throughput"
    assert data["unit"] == "fixes/s"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0
    assert data["device"] == "cpu"


def test_bench_serve_matches_jax():
    """bench_serve's scenario through the port's server (solver on the
    CPU) gives the JAX bench_serve's fix count."""
    sys.path.insert(0, ROOT)
    import bench as jax_bench

    _, _, fixes = bench.bench_serve(num_detections=3000, device="cpu")
    assert fixes == jax_bench.bench_serve(num_detections=3000)[2]


def test_skip_baseline_reads_the_stored_oracle_rate(capsys, monkeypatch,
                                                    lastgood):
    """The first run measures the float64 oracle and stores its rate;
    --skip-baseline then reuses it instead of measuring."""
    calls = []
    real = bench.time_oracle

    def counted(oracle, blocks):
        calls.append(len(blocks))
        return real(oracle, blocks)

    monkeypatch.setattr(bench, "time_oracle", counted)
    args = ["--batch", "8", "--iters", "1", "--scan-k", "1", "--repeats",
            "1", "--oracle-blocks", "1", "--sweep", "none"]
    assert run_bench(capsys, args + ["--skip-baseline"])[0] == 0
    assert calls == [1]  # nothing stored yet: measured
    with open(lastgood) as f:
        stored = json.load(f)[bench._oracle_key()]
    rc, data = run_bench(capsys, args + ["--skip-baseline"])
    assert rc == 0 and calls == [1]
    assert data["vs_baseline"] == round(data["value"] / stored, 2)


def test_profile_writes_a_trace(capsys, tmp_path):
    rc, data = run_bench(capsys, ["--batch", "8", "--iters", "1",
                                  "--oracle-blocks", "1", "--profile",
                                  str(tmp_path / "prof")])
    assert rc == 0 and data["runs_sec_per_batch"][0] > 0
    with open(tmp_path / "prof" / "bench_trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cuda_without_a_card_raises(monkeypatch):
    """--device cuda (the default) on a machine without a card raises
    before any work; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp.launches = 0
    with pytest.raises(RuntimeError, match="cuda"):
        main(["bench", "--batch", "8"])
    assert pp.launches == 0


def test_bench_never_imports_jax(tmp_path):
    """In a fresh interpreter where neither jax nor the JAX package can
    be imported, the port's bench runs its batch program with a sweep,
    the selfcheck and the knee abcheck, and loads neither."""
    runs = [["bench", "--device", "cpu", "--batch", "8", "--iters", "1",
             "--scan-k", "1", "--repeats", "1", "--oracle-blocks", "1",
             "--sweep", "4,8"],
            ["bench", "--device", "cpu", "--program", "selfcheck",
             "--batch", "8"],
            ["bench", "--device", "cpu", "--program", "abcheck",
             "--batch", "16", "--ab", "gate_capacity=4", "--ab-knee"]]
    code = (
        "import sys\n"
        "for name in ('thrifty_tpu', 'jax', 'jaxlib'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "from thrifty_tpu_torch import bench\n"
        "bench._lastgood_path = lambda: {store!r}\n"
        "from thrifty_tpu_torch.cli import main\n"
        "for args in {runs!r}:\n"
        "    assert main(args) == 0, args\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and k.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                     'thrifty_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')\n").format(
            runs=runs, store=str(tmp_path / "lastgood.json"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert [d["metric"] for d in lines] == [
        "detect_throughput", "pallas_xla_selfcheck", "config_abcheck_knee"]
    assert all(d["value"] > 0 for d in lines)
    assert proc.stdout.strip().endswith("NO_JAX")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_default_batch_program_on_the_card(cuda_device, capsys,
                                           monkeypatch):
    """The batch program at its defaults but a short chain and sweep, on
    the card: CUDA events, 2 power/peak launches a batch plus 1 for each
    gate overflow (the auto gate at batch // 2 holds the bench mix's 128
    carriers)."""
    from thrifty_tpu_torch.dsp.detector import BatchDetector

    queued = []
    detect_batch = BatchDetector._detect_batch

    def counted(self, blocks):
        queued.append(detect_batch(self, blocks))
        return queued[-1]

    monkeypatch.setattr(BatchDetector, "_detect_batch", counted)
    pp.launches = 0
    rc, data = run_bench(capsys, ["--repeats", "2", "--scan-k", "2",
                                  "--iters", "4", "--sweep", "none"],
                         device="cuda")
    assert rc == 0
    check_contract(data)
    assert data["device"].startswith("cuda:")
    assert data["clock"] == "cuda_events" and data["gate"] == 128
    assert data["headline_batch"] == 256
    # warm-ups 1 + 1, K and 2K chains twice, the dispatch chain 1 + 4
    assert len(queued) >= 2 + 2 * (2 + 4) + 5
    assert pp.launches == 2 * len(queued) + sum(
        bool(p.overflowed) for p in queued)
