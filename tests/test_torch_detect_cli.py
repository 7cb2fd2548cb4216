"""The port's detect CLI on the CPU against the reference goldens.

``python -m thrifty_tpu_torch.cli detect`` with ``--device cpu`` runs
the committed captures tests/golden/input/rx{0,1,2}.card and must meet
tests/golden/rx{0,1,2}.toad under the tolerances of
tests/test_golden_reference.py (the JAX package's own bar): the
same detections, integer columns equal, floats within ``TOAD_TOLS``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_golden_reference import TOAD_INT_COLS, TOAD_TOLS  # noqa: E402
from thrifty_tpu.pipeline import detect as jax_detect  # noqa: E402
from thrifty_tpu_torch import device as device_mod  # noqa: E402
from thrifty_tpu_torch.cli import main  # noqa: E402
from thrifty_tpu_torch.pipeline import detect as port_detect  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
INPUT = os.path.join(GOLDEN, "input")


def detect_args(rxid, out, batch_size=64, extra=()):
    return ["detect", os.path.join(INPUT, "rx%d.card" % rxid), "-o", str(out),
            "-c", os.path.join(INPUT, "detector.cfg"),
            "--template", os.path.join(INPUT, "template.npy"),
            "--rxid", str(rxid), "--batch-size", str(batch_size),
            "--device", "cpu"] + list(extra)


def assert_toad_matches(got_path, ref_path):
    ref = np.atleast_2d(np.loadtxt(ref_path))
    got = np.atleast_2d(np.loadtxt(got_path))
    assert got.shape == ref.shape, "different detection count"
    for col in TOAD_INT_COLS:
        np.testing.assert_array_equal(got[:, col], ref[:, col],
                                      err_msg="toad col %d" % col)
    for col, tol in TOAD_TOLS.items():
        np.testing.assert_allclose(got[:, col], ref[:, col],
                                   err_msg="toad col %d" % col, **tol)


# rx0 also at batch 16: several batches in flight and a padded last one.
@pytest.mark.parametrize("rxid,batch_size", [(0, 64), (1, 64), (2, 64),
                                             (0, 16)])
def test_golden_cards(tmp_path, rxid, batch_size):
    out = tmp_path / "rx.toad"
    assert main(detect_args(rxid, out, batch_size, ["--quiet"])) == 0
    assert_toad_matches(out, os.path.join(GOLDEN, "rx%d.toad" % rxid))


def test_summary_and_card_out(tmp_path, capsys):
    """Summary lines are printed per block and corr-detected blocks are
    teed to --card-out."""
    from thrifty_tpu.io import card

    out, teed = tmp_path / "rx.toad", tmp_path / "det.card"
    assert main(detect_args(0, out, extra=["--card-out", str(teed)])) == 0
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith("blk=")]
    ts, idx, raw = card.read_card(str(teed))
    toad_rows = np.atleast_2d(np.loadtxt(out))
    assert len(lines) == len(card.read_card(
        os.path.join(INPUT, "rx0.card"))[0])
    np.testing.assert_array_equal(idx, toad_rows[:, 2])
    assert "detections" in text and "IQ samples/s" in text


def test_summary_formatter_matches_jax():
    out = {"carrier_bin": np.array([30, 16300], np.int32),
           "carrier_offset": np.array([-0.25, 0.125], np.float32),
           "carrier_detect": np.array([True, False]),
           "carrier_energy": np.array([1480.1, 5.0], np.float32),
           "carrier_noise": np.array([25.4, 4.0], np.float32),
           "detected": np.array([True, False]),
           "corr_sample": np.array([7107, 0], np.int32),
           "corr_offset": np.array([0.3, 0.0], np.float32),
           "corr_energy": np.array([1399.8, 0.0], np.float32),
           "corr_noise": np.array([12.4, 0.0], np.float32)}
    port = port_detect.SummaryFormatter(2.4e6, 16384)
    ref = jax_detect.SummaryFormatter(2.4e6, 16384)
    for i in range(2):
        assert port(7, out, i) == ref(7, out, i)


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = detect_args(0, tmp_path / "rx.toad")
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(args)
    assert not (tmp_path / "rx.toad").exists()


ENTRY_POINTS = ("BatchDetector", "from_numpy_state", "CarrierGate",
                "solve_groups_batched", "solve_batched", "PositioningServer",
                "template_extract", "doctor_detector")


def entry_point_calls(tmp_path):
    """Each entry point with a ``device`` argument, called without it."""
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu_torch.pipeline import capture, doctor, pos, server, tdoa
    from thrifty_tpu_torch.pipeline import template_extract

    tpl = np.ones(64)
    cfg = DetectorConfig(block_len=512, history_len=128,
                         carrier_window=(3, 12))
    rx = {0: np.zeros(2), 1: np.array([900.0, 0.0]),
          2: np.array([0.0, 800.0])}
    rows = np.zeros(2, dtype=tdoa.TDOA_DTYPE)
    rows["rx0"], rows["rx1"], rows["snr"] = 0, [1, 2], 10.0
    group = tdoa.TdoaGroup(group_id=0, timestamp=0.0, tx=1, tdoas=rows)
    return {
        "BatchDetector": lambda: BatchDetector(tpl, cfg),
        "from_numpy_state": lambda: BatchDetector.from_numpy_state(
            tpl, cfg, BatchDetector.numpy_state(tpl, cfg)),
        "CarrierGate": lambda: capture.CarrierGate(512, (3, 12),
                                                   (0.0, 15.0, 0.0)),
        "solve_groups_batched": lambda: pos.solve_groups_batched(
            np.zeros((1, 3)), np.ones((1, 3), bool), np.zeros((1, 3, 2)),
            np.ones((1, 3, 2)), (np.full(2, -1e4), np.full(2, 1e4))),
        "solve_batched": lambda: pos.solve_batched([group], rx),
        "PositioningServer": lambda: server.PositioningServer(
            rx, {9: np.zeros(2)}),
        "template_extract": lambda: template_extract._main([
            os.path.join(INPUT, "rx0.card"), "-o",
            str(tmp_path / "tpl.npy"), "--carrier-window", "7-110"]),
        "doctor_detector": lambda: doctor._detector(2),
    }


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, name):
    """Without ``device=`` every entry point asks for the card, and on a
    machine without one that raises instead of running on the CPU."""
    call = entry_point_calls(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        call()
    assert not os.listdir(tmp_path)


def test_resolve_device():
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="unknown device"):
        device_mod.resolve_device("gpu")


TRANSFORM_FLAGS = {  # flag: (config field, JAX default, choices)
    "--pallas": ("use_pallas", "auto", ("auto", "on", "off")),
    "--fft-impl": ("fft_impl", "auto", ("auto", "matmul", "matmul3", "xla")),
    "--fft-precision": ("fft_precision", "highest",
                        ("highest", "high", "default")),
}


@pytest.mark.parametrize("flag", sorted(TRANSFORM_FLAGS))
def test_transform_flags_accepted_and_validated(tmp_path, monkeypatch,
                                                flag):
    """The JAX CLI's transform knobs: every choice reaches the
    detector's config (the default when the flag is absent), and a value
    outside the choices is a usage error."""
    field, default, choices = TRANSFORM_FLAGS[flag]
    seen = []

    class Stop(Exception):
        pass

    def fake_detector(template, config, device):
        seen.append(config)
        raise Stop

    monkeypatch.setattr(port_detect, "BatchDetector", fake_detector)
    for extra in [[]] + [[flag, v] for v in choices]:
        with pytest.raises(Stop):
            main(detect_args(0, tmp_path / "x.toad", extra=extra))
    assert [getattr(c, field) for c in seen] == [default] + list(choices)
    assert getattr(port_detect.DetectorConfig(), field) == default
    with pytest.raises(SystemExit):
        main(detect_args(0, tmp_path / "x.toad", extra=[flag, "bogus"]))


# The JAX detector's three sub-knobs of the matmul transforms (the
# full-FFT carrier stage, a carrier-only precision, the full ramp): the
# port always runs their 'auto' and has neither the fields nor the flags.
RETIRED = {"--carrier-fast": "carrier_fast",
           "--carrier-precision": "carrier_precision",
           "--ramp-fast": "ramp_fast"}


@pytest.mark.parametrize("command", ["detect", "bench"])
@pytest.mark.parametrize("flag", sorted(RETIRED))
def test_retired_transform_knobs_refused(tmp_path, capsys, command, flag):
    """``detect`` and ``bench`` refuse each flag as a usage error before
    they run, ``bench --ab`` refuses its field, and ``DetectorConfig``
    has no such field."""
    field = RETIRED[flag]
    out = tmp_path / "x.toad"
    argv = detect_args(0, out) if command == "detect" else [
        "bench", "--program", "abcheck", "--ab", "fft_impl=xla",
        "--batch", "8", "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        main(argv + [flag, "auto"])
    assert exc.value.code == 2
    assert "unrecognized arguments: {} auto".format(flag) \
        in capsys.readouterr().err
    assert not out.exists()
    if command == "bench":
        with pytest.raises(SystemExit) as exc:
            main(["bench", "--program", "abcheck", "--ab", field + "=auto",
                  "--device", "cpu"])
        assert exc.value.code == 2
        assert "unknown DetectorConfig field {!r}".format(field) \
            in capsys.readouterr().err
    with pytest.raises(TypeError, match=field):
        port_detect.DetectorConfig(**{field: "auto"})


def test_pallas_off_refused_on_the_card(tmp_path, capsys):
    """--pallas off with --device cuda is a usage error, raised before
    the device is resolved: the card has no plain reduction path."""
    with pytest.raises(SystemExit) as exc:
        main(detect_args(0, tmp_path / "x.toad",
                         extra=["--pallas", "off", "--device", "cuda"]))
    assert exc.value.code == 2
    assert "--pallas off runs the plain reductions, which only --device " \
        "cpu runs" in capsys.readouterr().err
    assert not (tmp_path / "x.toad").exists()


KITCHEN_SINK = """
import functools
from thrifty_tpu_torch.io import tpl
from thrifty_tpu_torch.pipeline import identify, tdoa
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu_torch.pipeline import kitchen_sink, pos
det = BatchDetector(tpl.load_template({inp!r} + '/template.npy'),
                    DetectorConfig(carrier_window=(7, 110)), device='cpu')
dets = kitchen_sink.detect_all(
    {{i: {inp!r} + '/rx%d.card' % i for i in range(3)}}, det, batch_size=64)
with open({inp!r} + '/freq-map.cfg') as f:
    freqmap = identify.load_freqmap(f)
settings = kitchen_sink.PostdetectSettings(
    freqmap=freqmap, match_window=0.02, tdoa_est_window=8.0,
    rx_pos=tdoa.load_pos_config({inp!r} + '/pos-rx.cfg'),
    beacon_pos=tdoa.load_pos_config({inp!r} + '/pos-beacon.cfg'),
    sample_rate=2.4e6)
res = kitchen_sink.postdetect(dets, settings, pos_estimator=functools.partial(
    pos.solve_batched, device='cpu'))
assert len(res.pos) == {fixes}, len(res.pos)
"""


def test_cli_never_imports_jax(tmp_path):
    """In a fresh interpreter (the test session itself has jax loaded)
    where neither jax nor the JAX package can be imported, running the
    port's detect
    CLI (.card input; raw input with --device-unfold, --gate-capacity
    and integer sync; a template bank with --emit-txid; the maximise
    interpolator), its capture CLI (host and device unfold), identify
    -> match -> tdoa -> pos --batched on the golden chain, serve --once
    --track on the golden .toad files, track, the four analyses, gold,
    template_generate, template_extract, scope, doctor, help for every
    command, and kitchen_sink, then importing the port's live-source
    modules and every port module, works and loads neither."""
    from thrifty_tpu import sim
    from thrifty_tpu.dsp import iq
    from thrifty_tpu.dsp import template as template_mod
    from thrifty_tpu.io import card

    out = tmp_path / "rx.toad"
    raw = os.path.join(GOLDEN, "fastdet", "input", "rx0.raw")
    tpl = os.path.join(INPUT, "template.npy")
    bank = template_mod.generate_bank(5, [0, 1, 2], 2.0)
    np.save(tmp_path / "bank.npy", bank)
    cap = sim.synth_capture(num_blocks=8, bursts_every=2, template=bank[1],
                            block_len=2048, history_len=256,
                            carrier_bin=40.25, amplitude=0.8,
                            noise_std=0.05, seed=3)
    card.write_card(str(tmp_path / "bank.card"), cap.timestamps,
                    cap.indices, iq.iq_to_raw(cap.blocks))
    runs = [detect_args(1, out, 64, ["--quiet"]),
            ["detect", raw, "--raw", "--device-unfold", "--gate-capacity",
             "8", "--sync-mode", "integer", "--template", tpl,
             "--carrier-window", "7-110", "--batch-size", "16", "--quiet",
             "-o", str(tmp_path / "raw.toad"), "--device", "cpu"],
            ["detect", str(tmp_path / "bank.card"), "--emit-txid",
             "--template", str(tmp_path / "bank.npy"), "--block-size",
             "2048", "--history", "256", "--carrier-window", "7-110",
             "--batch-size", "8", "--quiet", "-o",
             str(tmp_path / "bank.toads"), "--device", "cpu"]]
    runs += [detect_args(i, tmp_path / ("rx%d.toad" % i), 64,
                         ["--quiet"] + (["--corr-interp", "maximise"]
                                        if i == 0 else []))
             for i in range(3)]
    chain = str(tmp_path)
    runs += [["identify"] + [chain + "/rx%d.toad" % i for i in range(3)]
             + ["-o", chain + "/rx.toads", "-m", INPUT + "/freq-map.cfg"],
             ["match", chain + "/rx.toads", "-o", chain + "/rx.match",
              "-w", "0.02"],
             ["tdoa", chain + "/rx.toads", chain + "/rx.match", "-o",
              chain + "/data.tdoa", "-r", INPUT + "/pos-rx.cfg", "-b",
              INPUT + "/pos-beacon.cfg"],
             ["pos", chain + "/data.tdoa", "-o", chain + "/data.pos", "-r",
              INPUT + "/pos-rx.cfg", "--batched", "--device", "cpu"]]
    for extra in ([], ["--device-unfold"]):
        runs.append(["capture", "--raw-in", raw, "--carrier-window",
                     "7-110", "--batch-size", "16", "--quiet", "-o",
                     str(tmp_path / "gated.card"), "--device", "cpu"]
                    + extra)
    golden = [os.path.join(GOLDEN, "rx%d.toad" % i) for i in range(3)]
    runs += [["serve"] + golden + [
                 "-o", chain + "/live.pos", "--track", chain + "/live.track",
                 "-r", INPUT + "/pos-rx.cfg", "-b", INPUT + "/pos-beacon.cfg",
                 "-m", INPUT + "/freq-map.cfg", "--match-window", "0.02",
                 "--once", "--device", "cpu"],
             ["track", chain + "/live.pos", "-o", chain + "/data.track"],
             ["analyze_toads", GOLDEN + "/rx.toads", "--per-rxtx"],
             ["analyze_tdoa", GOLDEN + "/data.tdoa"],
             ["analyze_beacon", GOLDEN + "/rx.toads", "0", "1", "9", "-w",
              "0.02"],
             ["analyze_detect", INPUT + "/rx0.card", "--blocks", "60",
              "--template", tpl, "--carrier-window", "7-110", "--save-npz",
              chain + "/diag.npz"],
             ["gold", "5", "2", "--stats"],
             ["template_generate", "5", "0", "-o", chain + "/gen.npy"],
             ["template_extract", INPUT + "/rx0.card", "-o",
              chain + "/ext.npy", "--carrier-window", "7-110", "--template",
              tpl, "--device", "cpu"],
             ["scope", raw, "--export", chain + "/frame", "--frames", "1",
              "--block-size", "2048", "--free-run"],
             ["doctor", "--device", "cpu"]]
    fixes = len(np.atleast_2d(np.loadtxt(os.path.join(GOLDEN, "data.pos"))))
    code = (
        "import pkgutil, sys, importlib\n"
        "for name in ('thrifty_tpu', 'jax', 'jaxlib'):\n"
        "    sys.modules[name] = None  # any import of them raises\n"
        "from thrifty_tpu_torch.cli import COMMANDS, main\n"
        "for args in {runs!r}:\n"
        "    assert main(args) == 0, args\n"
        "for command in COMMANDS:\n"
        "    try:\n"
        "        main(['help', command])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, command\n"
        "{sink}\n"
        "import thrifty_tpu_torch.io.rtl_tcp, thrifty_tpu_torch.io.rtlsdr\n"
        "import thrifty_tpu_torch\n"
        "for m in pkgutil.walk_packages(thrifty_tpu_torch.__path__,\n"
        "                               'thrifty_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and k.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                     'thrifty_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')\n").format(
            runs=runs, sink=KITCHEN_SINK.format(inp=INPUT, fixes=fixes))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX" in proc.stdout
    assert_toad_matches(out, os.path.join(GOLDEN, "rx1.toad"))
    txids = np.atleast_2d(np.loadtxt(tmp_path / "bank.toads"))[:, 1]
    assert len(txids) == len(cap.bursts) and np.all(txids == 1)
    assert len(np.atleast_2d(np.loadtxt(tmp_path / "data.pos"))) == fixes
    # serve on the golden .toad files: the golden chain's fixes.
    live = np.atleast_2d(np.loadtxt(tmp_path / "live.pos"))
    ref = np.atleast_2d(np.loadtxt(os.path.join(GOLDEN, "data.pos")))
    assert live.shape == ref.shape
    np.testing.assert_array_equal(live[:, :3], ref[:, :3])
    np.testing.assert_allclose(live[:, 5:], ref[:, 5:], rtol=0, atol=1e-6)
    assert len(np.loadtxt(tmp_path / "data.track", ndmin=2)) == fixes
    assert np.load(tmp_path / "ext.npy").shape == (4914,)
    assert (tmp_path / "frame0000.png").exists()


def _jax_package_names(path):
    """Modules of the JAX package that ``path`` imports, or names in a
    string (a dotted module path such as ``cli.COMMANDS`` holds, or the
    argument of an ``import_module`` call); docstrings are prose and
    may name a counterpart."""
    import ast
    import re

    def is_jax_package(name):
        return name == "thrifty_tpu" or name.startswith("thrifty_tpu.")

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__"):
            names = [node.args[0].value]
        elif isinstance(node, ast.Constant) and isinstance(
                node.value, str) and id(node) not in docstrings:
            names = [node.value.strip()] if re.fullmatch(
                r"thrifty_tpu(\.\w+)+", node.value.strip()) else []
        else:
            continue
        for name in names:
            if is_jax_package(name):
                yield name


@pytest.mark.parametrize("rel", sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, fs in os.walk(os.path.join(ROOT, "thrifty_tpu_torch"))
     for f in fs if f.endswith(".py")]
    + ["chip_smoke.py", os.path.join("scripts", "profile_torch_detect.py"),
       os.path.join("scripts", "network_demo_torch.py"),
       os.path.join("scripts", "accuracy_sweep_torch.py"),
       os.path.join("scripts", "tf32_drift_torch.py")]
    + [os.path.join("scripts", name) for name in (
        "validation_sweep_torch.py", "card_golden_check_torch.py",
        "card_ab_time_torch.py", "scaling_sweep_torch.py",
        "chip_rate_search_torch.py")]))
def test_port_imports_only_host_modules(rel):
    """The port and its card scripts import nothing of the JAX package,
    not even its numpy host modules (the port keeps its own copies),
    and name none of its modules for a later import (checked in the
    source)."""
    bad = sorted(set(_jax_package_names(os.path.join(ROOT, rel))))
    assert not bad, bad


def test_source_check_finds_jax_package_names(tmp_path):
    """The source check above flags an import, a module path held in a
    string and an import_module call, and passes a docstring that names
    a counterpart."""
    src = tmp_path / "m.py"
    src.write_text(
        '"""Counterpart of ``thrifty_tpu.io.card``."""\n'
        "import importlib\n"
        "from thrifty_tpu.io import card\n"
        "import thrifty_tpu.sim\n"
        "COMMANDS = {'tdoa': 'thrifty_tpu.pipeline.tdoa'}\n"
        "importlib.import_module('thrifty_tpu')\n"
        "PATH = 'thrifty_tpu/dsp/pallas_kernels.py:163'\n")
    assert sorted(_jax_package_names(str(src))) == [
        "thrifty_tpu", "thrifty_tpu.io", "thrifty_tpu.pipeline.tdoa",
        "thrifty_tpu.sim"]


def test_detect_batches_drops_padding():
    """A short batch is padded with zero-signal rows that never reach the
    records, and every batch is drained."""
    from thrifty_tpu.io import card
    from thrifty_tpu.io import tpl as tpl_io
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    ts, idx, raw = card.read_card(os.path.join(INPUT, "rx2.card"))

    det = BatchDetector(tpl_io.load_template(
        os.path.join(INPUT, "template.npy")),
        DetectorConfig(carrier_window=(7, 110)), device="cpu")
    batches = [(ts[:5], idx[:5], raw[:5]), (ts[5:0], idx[5:0], raw[5:0]),
               (ts[5:], idx[5:], raw[5:])]
    recs = list(port_detect.detect_batches(det, iter(batches), 32, rxid=2))
    assert len(recs) == 2
    got = np.concatenate(recs)
    assert np.all(got["rxid"] == 2)
    ref = np.atleast_2d(np.loadtxt(os.path.join(GOLDEN, "rx2.toad")))
    np.testing.assert_array_equal(got["block"], ref[:, 2])


def test_raw_input_matches_jax_cli(tmp_path):
    """--raw (host unfold through StreamPump, --t0 stamps, --skip) gives
    the JAX CLI's records on the same stream, under TOAD_TOLS."""
    from thrifty_tpu import sim
    from thrifty_tpu.cli import main as jax_main
    from thrifty_tpu.dsp import iq
    from thrifty_tpu.dsp import template as template_mod

    tpl = template_mod.generate(5, 0, 2.0)
    np.save(tmp_path / "t.npy", tpl)
    bursts = [{"position": p, "carrier_bin": 40.25, "amplitude": 0.8,
               "phase": 0.3} for p in (2500.0, 6100.0, 9700.0, 15000.0)]
    stream = sim.synth_stream(18000, bursts, tpl, block_len=2048, seed=4)
    (tmp_path / "s.bin").write_bytes(iq.iq_to_raw(stream).tobytes())
    outs = {}
    for name, run, extra in (("jax", jax_main, []),
                             ("port", main, ["--device", "cpu"])):
        outs[name] = tmp_path / (name + ".toad")
        assert run(["detect", str(tmp_path / "s.bin"), "--raw", "--quiet",
                    "-o", str(outs[name]), "--t0", "1.5e9", "--skip", "1",
                    "--template", str(tmp_path / "t.npy"),
                    "--block-size", "2048", "--history", "256",
                    "--carrier-window", "7-110", "--batch-size", "4"]
                   + extra) == 0
    assert len(np.atleast_2d(np.loadtxt(outs["jax"]))) >= 3
    assert_toad_matches(outs["port"], outs["jax"])
