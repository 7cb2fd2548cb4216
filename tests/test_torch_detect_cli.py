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


def test_resolve_device():
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="unknown device"):
        device_mod.resolve_device("gpu")


def test_unported_flags_are_absent(tmp_path):
    for flag in ("--peak-filter=-1", "--emit-txid", "--pallas=on",
                 "--corr-interp=gaussian", "--carrier-interp=dirichlet"):
        with pytest.raises(SystemExit):
            main(detect_args(0, tmp_path / "x.toad", extra=[flag]))


def test_cli_never_imports_jax(tmp_path):
    """In a fresh interpreter (the test session itself has jax loaded),
    running the port's detect CLI (.card input; raw input with
    --device-unfold, --gate-capacity and integer sync) and capture CLI
    (host and device unfold), importing the live-source host modules
    and every port module leaves jax out of sys.modules."""
    out = tmp_path / "rx.toad"
    raw = os.path.join(GOLDEN, "fastdet", "input", "rx0.raw")
    tpl = os.path.join(INPUT, "template.npy")
    runs = [detect_args(1, out, 64, ["--quiet"]),
            ["detect", raw, "--raw", "--device-unfold", "--gate-capacity",
             "8", "--sync-mode", "integer", "--template", tpl,
             "--carrier-window", "7-110", "--batch-size", "16", "--quiet",
             "-o", str(tmp_path / "raw.toad"), "--device", "cpu"]]
    for extra in ([], ["--device-unfold"]):
        runs.append(["capture", "--raw-in", raw, "--carrier-window",
                     "7-110", "--batch-size", "16", "--quiet", "-o",
                     str(tmp_path / "gated.card"), "--device", "cpu"]
                    + extra)
    code = (
        "import pkgutil, sys, importlib\n"
        "from thrifty_tpu_torch.cli import main\n"
        "for args in {runs!r}:\n"
        "    assert main(args) == 0, args\n"
        "import thrifty_tpu.io.rtl_tcp, thrifty_tpu.io.rtlsdr\n"
        "import thrifty_tpu_torch\n"
        "for m in pkgutil.walk_packages(thrifty_tpu_torch.__path__,\n"
        "                               'thrifty_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')\n").format(runs=runs)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX" in proc.stdout
    assert_toad_matches(out, os.path.join(GOLDEN, "rx1.toad"))


# The numpy host modules of the JAX package that the port may reuse.
HOST_MODULES = {"thrifty_tpu.io.card", "thrifty_tpu.io.toad",
                "thrifty_tpu.io.tpl", "thrifty_tpu.io.blocks",
                "thrifty_tpu.io.stream", "thrifty_tpu.io.rtl_tcp",
                "thrifty_tpu.io.rtlsdr", "thrifty_tpu.config.settings",
                "thrifty_tpu.config.parsers", "thrifty_tpu.dsp.util",
                "thrifty_tpu.sim"}


def _jax_package_imports(path):
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            # `from pkg import mod` may name a module or an attribute.
            names = [node.module] + ["{}.{}".format(node.module, a.name)
                                     for a in node.names]
            names = [n for n in names if n in HOST_MODULES] or names[:1]
        else:
            continue
        for name in names:
            if name == "thrifty_tpu" or name.startswith("thrifty_tpu."):
                yield name


@pytest.mark.parametrize("rel", sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, fs in os.walk(os.path.join(ROOT, "thrifty_tpu_torch"))
     for f in fs if f.endswith(".py")]
    + ["chip_smoke.py", os.path.join("scripts", "profile_torch_detect.py")]))
def test_port_imports_only_host_modules(rel):
    """The port and its card scripts import, from the JAX package, only its
    numpy host modules (checked in the source, since those modules may
    pull in further numpy-only modules of their own)."""
    bad = sorted(set(_jax_package_imports(os.path.join(ROOT, rel)))
                 - HOST_MODULES)
    assert not bad, bad


def test_detect_batches_drops_padding():
    """A short batch is padded with zero-signal rows that never reach the
    records, and every batch is drained."""
    from thrifty_tpu.io import card
    from thrifty_tpu.io import tpl as tpl_io
    from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig

    ts, idx, raw = card.read_card(os.path.join(INPUT, "rx2.card"))

    det = BatchDetector(tpl_io.load_template(
        os.path.join(INPUT, "template.npy")),
        DetectorConfig(carrier_window=(7, 110)))
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
