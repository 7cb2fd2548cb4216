"""The port's operator tools against the JAX package's.

The four analyses, ``gold``, ``template_generate``, ``scope`` and
``track`` are numpy on the host, copies of the JAX package's modules;
``template_extract`` runs the port's detector on ``--device`` and
``doctor`` checks the torch/CUDA stack.  Each command runs through the
port's CLI and through the JAX package's on the same files: stdout and
written arrays equal (``.npz``/``.npy`` bit for bit where the work is
host numpy), the extracted template within 1e-5 relative of JAX's, and
the same winning block.

The JAX package is imported inside the tests, so the ``cuda`` tests at
the end run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_tools.py``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.dsp import iq  # noqa: E402
from thrifty_tpu_torch.dsp import power_peak as pp  # noqa: E402
from thrifty_tpu_torch.io import card  # noqa: E402
from thrifty_tpu_torch.pipeline import doctor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
INPUT = os.path.join(GOLDEN, "input")
FS = 2.4e6
# tests/test_analysis.py's world: three receivers, a beacon and a mobile.
RX_POS = {0: np.array([0.0, 0.0]), 1: np.array([9000.0, 500.0]),
          2: np.array([4000.0, 8000.0])}
BEACON_POS = {9: np.array([4500.0, 3000.0])}
MOBILE_POS = {3: np.array([6000.0, 2500.0])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_analysis.py's files, made with the port on the CPU."""
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.io import toad
    from thrifty_tpu_torch.pipeline import kitchen_sink, tdoa

    d = tmp_path_factory.mktemp("tools")
    tpl = sim.make_template()
    schedule = [(9, t) for t in np.arange(0.02, 0.36, 0.05)]
    schedule += [(3, t) for t in (0.085, 0.185, 0.285)]
    caps = sim.synth_rx_captures(
        RX_POS, {**BEACON_POS, **MOBILE_POS}, {9: 30, 3: 70}, schedule,
        template=tpl, num_blocks=80, amplitude=0.6, noise_std=0.04,
        clock_offsets={1: 777.25, 2: -123.5},
        clock_drifts={1: 3e-6, 2: -2e-6}, seed=11)
    detector = BatchDetector(tpl, DetectorConfig(carrier_window=(7, 110)),
                             device="cpu")
    detections = kitchen_sink.detect_all(
        {r: (c.timestamps, c.indices, c.blocks) for r, c in caps.items()},
        detector, batch_size=16)
    settings = kitchen_sink.PostdetectSettings(
        freqmap={r: {9: (25.0, 35.0), 3: (65.0, 75.0)} for r in RX_POS},
        match_window=0.02, tdoa_est_window=8.0, rx_pos=RX_POS,
        beacon_pos=BEACON_POS, sample_rate=FS)
    result = kitchen_sink.postdetect(detections, settings)
    toad.save(str(d / "data.toads"), result.toads, with_rxid=True,
              with_txid=True)
    tdoa.save_tdoa_groups(str(d / "data.tdoa"), result.tdoas)
    card.write_card(str(d / "rx0.card"), caps[0].timestamps,
                    caps[0].indices, iq.iq_to_raw(caps[0].blocks))
    np.save(str(d / "template.npy"), tpl)
    return d


def run_both(command, args, capsys):
    """(port stdout, JAX stdout, port rc, JAX rc) of one command."""
    from thrifty_tpu import cli as jax_cli

    port_rc = main([command] + args)
    port = capsys.readouterr().out
    jax_rc = jax_cli.main([command] + args)
    return port, capsys.readouterr().out, port_rc, jax_rc


@pytest.mark.parametrize("command,args,expect", [
    ("analyze_toads", ["{d}/data.toads", "--per-rxtx"],
     "Number of detections: 30"),
    ("analyze_tdoa", ["{d}/data.tdoa", "--rx0", "0", "--rx1", "1", "--tx",
                      "3"], "Number of TDOAs: 3"),
    ("analyze_tdoa", ["{d}/data.tdoa", "--rx0", "1", "--rx1", "2"],
     "Number of TDOAs:"),
    ("analyze_beacon", ["{d}/data.toads", "0", "1", "9", "-w", "0.02"],
     "Number of detection groups: 7"),
    ("analyze_beacon", ["{d}/data.toads", "1", "2", "9", "-w", "0.02", "-d",
                        "1"], "Number of detection groups:"),
], ids=["toads", "tdoa_tx3", "tdoa_all", "beacon", "beacon_deg1"])
def test_analyses_match_jax(world, capsys, command, args, expect):
    """The analyses' printed statistics equal JAX's on the same files."""
    args = [a.format(d=world) for a in args]
    port, ref, port_rc, jax_rc = run_both(command, args, capsys)
    assert expect in ref
    assert port == ref
    assert port_rc == (jax_rc or 0)


@pytest.mark.parametrize("mode", [["--blocks", "2,3,4,5"],
                                  ["--blocks", "2,3,4,5", "--fastdet"],
                                  ["--blocks", "0,1,4", "--force"], []],
                         ids=["blocks", "fastdet", "force", "detected"])
def test_detect_analysis_matches_jax(world, capsys, tmp_path, mode):
    """``analyze_detect`` on the float64 oracle: the per-block summaries
    and every ``--save-npz`` array equal JAX's."""
    from thrifty_tpu import cli as jax_cli

    args = [str(world / "rx0.card"), "--template",
            str(world / "template.npy"), "--carrier-window", "7 - 110"] + mode
    outs = {}
    for name, run in (("port", main), ("jax", jax_cli.main)):
        npz = str(tmp_path / (name + ".npz"))
        run(["analyze_detect"] + args + ["--save-npz", npz])
        outs[name] = capsys.readouterr().out.replace(npz, "NPZ")
    assert outs["port"] == outs["jax"]
    assert "block 4: carrier: yes" in outs["jax"]
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and "b4_corr_mag" in got
    for name in want.files:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class Axes:
    """Records every call a plot method makes on its axes: the method's
    name and its positional arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args))
            return self
        return record


def test_detect_analysis_views_match_jax(world):
    """Every view of ``analyze_detect`` draws JAX's data; the peak-filter
    view runs the port's float32 filter on a CPU tensor, within float32
    rounding of JAX's."""
    from thrifty_tpu.analysis import detect_analysis as jax_da
    from thrifty_tpu.oracle import numpy_ref as jax_ref
    from thrifty_tpu_torch.analysis import detect_analysis as da
    from thrifty_tpu_torch.oracle import numpy_ref

    tpl = np.load(world / "template.npy")
    _, _, blocks = card.read_card_blocks(str(world / "rx0.card"))
    block = blocks[4].astype(complex)
    port = da.BlockDiagnostics(numpy_ref.OracleDetector(
        tpl, carrier_window=(7, 110)), block, tpl)
    ref = jax_da.BlockDiagnostics(jax_ref.OracleDetector(
        tpl, carrier_window=(7, 110)), block, tpl)
    assert port.summary() == ref.summary()
    assert da.PLOTS == jax_da.PLOTS
    drawn = 0
    for name in da.PLOTS:
        got, want = Axes(), Axes()
        port.plot(name, got)
        ref.plot(name, want)
        assert [c[0] for c in got.calls] == [c[0] for c in want.calls], name
        for (_, g), (_, w) in zip(got.calls, want.calls):
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                if not isinstance(b, (np.ndarray, list, tuple)):
                    assert a == b, name
                elif name == "filtered_fft":
                    np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=name)
                drawn += isinstance(b, np.ndarray) and b.size > 100
    assert drawn >= len(da.PLOTS)


@pytest.mark.parametrize("args", [["5", "2", "--stats"], ["7", "3"],
                                  ["11", "0", "--stats"], ["6"]],
                         ids=["5_2_stats", "7_3", "11_0_stats", "6"])
def test_gold_matches_jax(capsys, args):
    port, ref, _, _ = run_both("gold", args, capsys)
    assert port == ref and len(ref) > 10


@pytest.mark.parametrize("args", [
    ["11", "0", "--sample-rate", "2.4M", "--chip-rate", "0.999707M"],
    ["7", "3", "--sample-rate", "2.5M", "--chip-rate", "1M"]],
    ids=["golden", "7_3"])
def test_template_generate_matches_jax(tmp_path, capsys, args):
    """``template_generate``: the same .npy as JAX's (and, for the golden
    geometry, as the reference's tests/golden/tools template)."""
    from thrifty_tpu import cli as jax_cli

    outs = {}
    for name, run in (("port", main), ("jax", jax_cli.main)):
        assert run(["template_generate"] + args + [
            "-o", str(tmp_path / (name + ".npy"))]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    got = np.load(tmp_path / "port.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax.npy"))
    if args[0] == "11":
        np.testing.assert_array_equal(got, np.load(os.path.join(
            GOLDEN, "tools", "template_generated.npy")))


def extract(run, path, out, extra=()):
    return run(["template_extract", path, "-o", str(out),
                "--carrier-window", "7-110", "--template",
                os.path.join(INPUT, "template.npy")] + list(extra))


def best_block(stdout):
    line = [ln for ln in stdout.splitlines() if ln.startswith("Captured")]
    assert len(line) == 1, stdout
    return line[0].split("#")[1].split()[0]


def assert_template_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("capture,batch", [("golden", 256), ("golden", 16),
                                           ("world", 8)])
def test_template_extract_matches_jax(world, tmp_path, capsys, capture,
                                      batch):
    """``template_extract --device cpu`` in batches of ``batch`` blocks
    against JAX's one call on the whole capture: the same block, the
    template within 1e-5 relative (and the reference's golden cut on
    rx0.card)."""
    from thrifty_tpu import cli as jax_cli

    path = os.path.join(INPUT, "rx0.card") if capture == "golden" \
        else str(world / "rx0.card")
    assert extract(main, path, tmp_path / "p.npy", [
        "--device", "cpu", "--batch-size", str(batch)]) == 0
    port = capsys.readouterr().out
    assert extract(jax_cli.main, path, tmp_path / "j.npy") == 0
    ref = capsys.readouterr().out
    assert best_block(port) == best_block(ref)
    got, want = np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy")
    assert_template_close(got, want)
    if capture == "golden":
        np.testing.assert_allclose(got, np.load(os.path.join(
            GOLDEN, "tools", "template_extracted.npy")), rtol=0, atol=1e-12)


def test_template_extract_no_detection(tmp_path, capsys):
    """A capture without a burst (and an empty one) prints JAX's message
    and exits 1."""
    cap = sim.synth_capture(num_blocks=4, bursts_every=2, amplitude=0.0,
                            template=sim.make_template(), seed=5)
    for name, sl in (("quiet", slice(None)), ("empty", slice(0, 0))):
        path = str(tmp_path / (name + ".card"))
        card.write_card(path, cap.timestamps[sl], cap.indices[sl],
                        iq.iq_to_raw(cap.blocks[sl]))
        assert extract(main, path, tmp_path / "x.npy",
                       ["--device", "cpu"]) == 1
        assert "no suitable detection found" in capsys.readouterr().out
    assert not (tmp_path / "x.npy").exists()


def test_template_extract_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        extract(main, os.path.join(INPUT, "rx0.card"), tmp_path / "x.npy")
    assert not (tmp_path / "x.npy").exists()


def scope_stream(tmp_path, amplitude, name):
    """tests/test_scope.py's raw stream: 8 blocks, a burst every 2."""
    cap = sim.synth_capture(
        num_blocks=8, bursts_every=2, template=sim.make_template(),
        amplitude=amplitude, noise_std=0.02, seed=3)
    path = tmp_path / name
    iq.iq_to_raw(cap.blocks[:, 4920:].reshape(-1)).tofile(str(path))
    return str(path)


@pytest.mark.parametrize("amplitude,extra,rc", [
    (0.8, ["--frames", "3", "--trigger-time", "0.4"], 0),
    (0.01, ["--trigger-time", "0.9", "--trigger-freq", "5"], 1),
    (0.01, ["--frames", "2", "--trigger-time", "0.9", "--free-run"], 0)],
    ids=["triggered", "quiet", "free_run"])
def test_scope_frames_match_jax(tmp_path, monkeypatch, capsys, amplitude,
                                extra, rc):
    """``scope --export``: the same frames (I, Q, |x|, spectrum and the
    waterfall at each export) and the same files as JAX's."""
    from thrifty_tpu import cli as jax_cli
    from thrifty_tpu.pipeline import scope as jax_scope
    from thrifty_tpu_torch.pipeline import scope

    raw = scope_stream(tmp_path, amplitude, "s.bin")
    frames = {}
    for name, module, run in (("port", scope, main),
                              ("jax", jax_scope, jax_cli.main)):
        seen = frames.setdefault(name, [])
        render = module.ScopeState.render

        def spy(state, fig, seen=seen, render=render):
            seen.append({**state.frame, "waterfall": state.waterfall.copy()})
            return render(state, fig)

        monkeypatch.setattr(module.ScopeState, "render", spy)
        prefix = str(tmp_path / (name + "_"))
        assert run(["scope", raw, "--export", prefix] + extra) == rc
        out = capsys.readouterr()
        frames[name + "_out"] = (out.out.replace(prefix, "P"),
                                 out.err)
        frames[name + "_files"] = sorted(
            f[len(name) + 1:] for f in os.listdir(tmp_path)
            if f.startswith(name + "_"))
    assert frames["port_out"] == frames["jax_out"]
    assert frames["port_files"] == frames["jax_files"]
    assert len(frames["port"]) == len(frames["jax"]) == (0 if rc else len(
        frames["jax_files"]))
    for got, ref in zip(frames["port"], frames["jax"]):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


CHECKS = ("versions", "devices", "native", "kernel-build", "detector",
          "pipeline")


def test_doctor_cpu_all_ok(capsys):
    """``doctor --device cpu --json``: every check ok, exit 0."""
    assert main(["doctor", "--device", "cpu", "--json"]) == 0
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [d["check"] for d in data] == list(CHECKS)
    assert all(d["ok"] for d in data), data
    assert "ran on cpu" in data[4]["detail"]


def test_doctor_without_card_fails(monkeypatch, capsys):
    """Default ``doctor`` asks for the card: without one the device
    checks FAIL and the run exits 1 (no fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["doctor"]) == 1
    captured = capsys.readouterr()
    lines = {ln.split()[0]: ln for ln in captured.out.splitlines()}
    assert set(lines) == set(CHECKS)
    for check in ("devices", "kernel-build", "detector", "pipeline"):
        assert "FAIL" in lines[check] and "cuda" in lines[check]
    for check in ("versions", "native"):
        assert "FAIL" not in lines[check]
    assert "doctor: FAILED: devices" in captured.err


def test_doctor_json_contract(capsys):
    """``--no-device --json``: host checks only, JAX's JSON shape."""
    assert doctor._main(["--no-device", "--json", "--device", "cpu"]) == 0
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {d["check"] for d in data} == set(CHECKS[:4])
    assert all(d["ok"] and set(d) == {"check", "ok", "detail"}
               for d in data)


def test_doctor_reports_failure(monkeypatch, capsys):
    def broken():
        raise RuntimeError("lib exploded")

    monkeypatch.setattr(doctor, "_native", broken)
    assert doctor._main(["--no-device", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "FAIL" in captured.out and "lib exploded" in captured.out
    assert "native" in captured.err


def test_doctor_selfcheck_needs_the_card(capsys):
    """The selfcheck holds the card's kernel against its plain version,
    so on the CPU it FAILs rather than compare the plain version with
    itself."""
    assert doctor._main(["--no-device", "--selfcheck", "--device",
                         "cpu"]) == 1
    assert "selfcheck      FAIL" in capsys.readouterr().out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 16])
def test_template_extract_on_the_card(cuda_device, tmp_path, capsys, batch):
    """``template_extract --device cuda`` against ``--device cpu`` on
    rx0.card: the same block, the template within 1e-5 relative, and two
    power/peak launches per batch."""
    n = len(card.read_card(os.path.join(INPUT, "rx0.card"))[0])
    pp.launches = 0
    assert extract(main, os.path.join(INPUT, "rx0.card"), tmp_path / "g.npy",
                   ["--device", "cuda", "--batch-size", str(batch)]) == 0
    assert pp.launches == 2 * -(-n // batch)
    gpu = capsys.readouterr().out
    assert extract(main, os.path.join(INPUT, "rx0.card"), tmp_path / "c.npy",
                   ["--device", "cpu", "--batch-size", str(batch)]) == 0
    assert best_block(gpu) == best_block(capsys.readouterr().out)
    assert_template_close(np.load(tmp_path / "g.npy"),
                          np.load(tmp_path / "c.npy"))


@pytest.mark.cuda
def test_doctor_selfcheck_on_the_card(cuda_device, capsys):
    """``doctor --selfcheck --batch 256 --json`` on the card: every check
    ok, and the kernel launched by the detector, pipeline and selfcheck
    checks."""
    pp.launches = 0
    assert main(["doctor", "--selfcheck", "--batch", "256", "--json"]) == 0
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [d["check"] for d in data] == list(CHECKS) + ["selfcheck"]
    assert all(d["ok"] for d in data), data
    assert pp.launches == 8
