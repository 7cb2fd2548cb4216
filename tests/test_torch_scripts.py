"""The port's counterparts of the JAX package's tool scripts, on the CPU:
scripts/validation_sweep_torch.py, card_golden_check_torch.py,
card_ab_time_torch.py, scaling_sweep_torch.py and
chip_rate_search_torch.py, each held against its JAX script
(tests/test_scripts.py's contracts) on the same seed and inputs.

Every run of a port script happens in a fresh interpreter in which
neither jax nor the JAX package can be imported (a ``sitecustomize`` on
``PYTHONPATH`` refuses them in that process and in every process it
spawns).
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CARD = os.path.join(REPO, "tests", "golden", "input", "rx0.card")
# Installed as sitecustomize: every interpreter started with it on
# PYTHONPATH refuses jax and the JAX package, and records its pid.
BLOCKER = """\
import os, sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "thrifty_tpu"):
            raise ImportError("refused in this interpreter: " + name)
        return None
sys.meta_path.insert(0, _Refuse())
with open(os.environ["NO_JAX_PIDS"], "a") as f:
    f.write("%d\\n" % os.getpid())
"""


def run_port(name, args, tmp_path, timeout=300):
    """Run a port script with jax and the JAX package unimportable;
    returns (CompletedProcess, interpreters started)."""
    hook = tmp_path / "no_jax"
    hook.mkdir(exist_ok=True)
    (hook / "sitecustomize.py").write_text(BLOCKER)
    pids = tmp_path / "no_jax_pids"
    pids.write_text("")
    env = dict(os.environ, NO_JAX_PIDS=str(pids),
               PYTHONPATH=str(hook) + os.pathsep + REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name)] + args,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=timeout)
    return proc, len(pids.read_text().split())


def run_jax(name, args, tmp_path, env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name)] + args,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)


def json_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(SCRIPTS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_blocker_refuses_the_jax_package(tmp_path):
    """The import check is live: under the blocker, importing the JAX
    package fails and the port still imports."""
    hook = tmp_path / "no_jax"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(BLOCKER)
    env = dict(os.environ, NO_JAX_PIDS=str(tmp_path / "pids"),
               PYTHONPATH=str(hook) + os.pathsep + REPO)
    code = ("import thrifty_tpu_torch.cli\n"
            "try:\n    import thrifty_tpu\nexcept ImportError:\n"
            "    print('REFUSED')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "REFUSED"


def test_validation_sweep_matches_jax(tmp_path):
    """Seed 0, 3 trials: the port's sweep and the JAX sweep visit the
    same geometries (trial, block and comparison counts agree suite by
    suite), both are clean, and the host suites print identical lines."""
    proc, interpreters = run_port("validation_sweep_torch.py",
                                  ["--device", "cpu", "--trials", "3"],
                                  tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert interpreters == 1
    ref = run_jax("validation_sweep.py", ["--platform", "cpu", "--trials",
                                          "3"], tmp_path)
    assert ref.returncode == 0, ref.stderr[-2000:]
    got = {d["suite"]: d for d in json_lines(proc.stdout)}
    want = {d["suite"]: d for d in json_lines(ref.stdout)}
    assert sorted(got) == sorted(want) == \
        ["detector", "matchmaker", "pos", "tdoa"]
    for suite, d in got.items():
        assert d["ok"] and want[suite]["ok"], (d, want[suite])
        for key in ("trials", "blocks", "comparisons"):
            assert d.get(key) == want[suite].get(key), (suite, key)
    assert got["detector"]["divergences"] == 0
    assert got["detector"]["blocks"] > 0
    assert got["pos"]["gn_worse_100m_wellposed"] == 0
    for suite in ("matchmaker", "tdoa"):
        assert got[suite] == want[suite]


def test_validation_sweep_fastdet_skips_without_the_reference(tmp_path):
    """The opt-in fastdet suite prints a "skipped" line, ok, where the
    reference tree is absent."""
    proc, _ = run_port("validation_sweep_torch.py",
                       ["--device", "cpu", "--suite", "fastdet",
                        "--trials", "1"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (line,) = json_lines(proc.stdout)
    assert line["suite"] == "fastdet" and line["ok"]
    if not os.path.isdir(os.environ.get("THRIFTY_REFERENCE",
                                        "/root/reference")):
        assert line["skipped"] == "reference tree not available"
        assert line["trials"] == 0


@pytest.mark.parametrize("extra", [[], ["--detect-arg=--gate-capacity",
                                        "--detect-arg=8"]],
                         ids=["plain", "gated"])
def test_golden_check_passes_on_the_cpu(tmp_path, extra):
    """The golden check (integer sync vs fastdet, the chain through
    data.pos) passes through the port's CLI on the CPU, plain and on the
    carrier-gated path."""
    proc, _ = run_port("card_golden_check_torch.py",
                       ["--device", "cpu"] + extra, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = json_lines(proc.stdout)
    summary = lines[-1]
    assert summary["metric"] == "card_golden_check"
    assert summary["value"] == 1.0 and summary["backend"] == "cpu"
    assert summary["detect_args"] == [a.split("=", 1)[1] for a in extra]
    stages = [(d["stage"], d.get("rx")) for d in lines[:-1]]
    assert stages == [("detect-integer", 0), ("detect-integer", 1),
                      ("detect-integer", 2), ("detect", 0), ("detect", 1),
                      ("detect", 2), ("positions", None)]
    assert lines[-2]["fixes"] == 7


def test_golden_check_tolerances_match_jax():
    """The column maps and tolerances are the JAX script's."""
    port = load_script("card_golden_check_torch.py")
    ref = load_script("tpu_golden_check.py")
    assert port.INT_COLS == ref.INT_COLS
    assert port.FLOAT_TOLS == ref.FLOAT_TOLS
    assert port.PY_FLOAT_TOLS == ref.PY_FLOAT_TOLS


def test_ab_time_contract(tmp_path):
    """The paired A/B timer on the CPU emits the config_ab_time line; a
    run whose slopes were non-positive must call itself unresolved."""
    proc, _ = run_port("card_ab_time_torch.py",
                       ["--device", "cpu", "--batch", "8", "--scan-k", "2",
                        "--rounds", "3", "--ab", "fft_impl=xla"], tmp_path)
    data = json_lines(proc.stdout)[-1]
    assert data["metric"] == "config_ab_time"
    assert data["b"] == {"fft_impl": "xla"} and data["a"] == {}
    if proc.returncode != 0:
        assert data["verdict"] == "unresolved", data
        return
    assert data["verdict"] in ("a_faster", "b_faster", "parity")
    assert data["device"] == "cpu"
    assert 2 <= len(data["rounds"]) <= 3
    assert all({"a", "b", "ratio_b_over_a"} <= set(r)
               for r in data["rounds"])
    assert data["invalid_rounds"] + len(data["rounds"]) == 3
    ratios = sorted(r["ratio_b_over_a"] for r in data["rounds"])
    want = ("b_faster" if ratios[-1] < 1.0 else
            "a_faster" if ratios[0] > 1.0 else "parity")
    assert data["verdict"] == want
    assert data["a_samples_per_s"] == pytest.approx(
        8 * (16384 - 4920) / data["a_sec_per_batch_median"], rel=1e-5)


def test_ab_time_rejects_bad_override(tmp_path):
    proc, _ = run_port("card_ab_time_torch.py",
                       ["--device", "cpu", "--ab", "nonsense"], tmp_path)
    assert proc.returncode != 0
    assert "K=V" in proc.stderr


def test_ab_time_sync_mode_override(tmp_path):
    """sync_mode is a str field: --ab sync_mode=integer builds B in
    integer sync (dataclasses.replace), no duplicate-keyword TypeError."""
    proc, _ = run_port("card_ab_time_torch.py",
                       ["--device", "cpu", "--batch", "8", "--scan-k", "2",
                        "--rounds", "2", "--sync-mode", "fractional",
                        "--ab", "sync_mode=integer"], tmp_path)
    assert "TypeError" not in proc.stderr
    data = json_lines(proc.stdout)[-1]
    assert data["b"] == {"sync_mode": "integer"}


def test_scaling_sweep_spawns_a_world_per_shape(tmp_path):
    """Worlds of 1 (in process) and 2 spawned gloo ranks at the tiny
    geometry: rows for 1 and 2 ranks, efficiency 1.0 on the first."""
    out = tmp_path / "sweep.json"
    proc, interpreters = run_port(
        "scaling_sweep_torch.py",
        ["--device", "cpu", "--geometry", "tiny", "--shapes", "1x1,1x2",
         "--iters", "2", "--json", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # This one, the 1x2 world's two ranks, and multiprocessing's
    # resource tracker.
    assert interpreters >= 3
    data = json.load(open(out))
    assert data["platform"] == "cpu" and data["geometry"] == "tiny"
    rows = data["results"]
    assert [r["mesh"] for r in rows] == ["1x1", "1x2"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["samples_per_s"] > 0 and r["sec_per_step"] > 0
               for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert "# device=cpu cards=0 geometry=tiny" in proc.stderr


def test_scaling_sweep_parse_shapes_is_jax():
    port = load_script("scaling_sweep_torch.py")
    ref = load_script("scaling_sweep.py")
    for text, n in ((None, 1), (None, 8), (None, 16), ("1x1,2X2,4x1", 1)):
        assert port.parse_shapes(text, n) == ref.parse_shapes(text, n)


def test_chip_rate_search_matches_jax(tmp_path):
    """The same best chip rate as the JAX script on rx0.card, within
    1 Hz."""
    proc, _ = run_port("chip_rate_search_torch.py", [CARD], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = run_jax("chip_rate_search.py", [CARD], tmp_path)
    assert ref.returncode == 0, ref.stderr[-2000:]

    def best(stdout):
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("best chip rate:")][-1]
        return float(line.split()[3])

    assert abs(best(proc.stdout) - best(ref.stdout)) <= 1.0


@pytest.mark.parametrize("name,args", [
    ("validation_sweep_torch.py", ["--trials", "1"]),
    ("card_golden_check_torch.py", []),
    ("card_ab_time_torch.py", ["--ab", "fft_impl=xla", "--batch", "8"]),
    ("scaling_sweep_torch.py", ["--geometry", "tiny", "--shapes", "1x1"]),
])
def test_default_device_is_the_card(tmp_path, name, args):
    """Without --device the scripts run on the card; without one they
    raise rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run there")
    proc, _ = run_port(name, args, tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert not json_lines(proc.stdout)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_detector_suite_on_the_card(cuda_device, tmp_path):
    """The detector suite on the card at 5 trials: the power/peak kernel
    at the sweep's small and odd shapes, 0 divergences."""
    proc, _ = run_port("validation_sweep_torch.py",
                       ["--device", "cuda", "--suite", "detector",
                        "--trials", "5"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (line,) = json_lines(proc.stdout)
    assert line["ok"] and line["divergences"] == 0 and line["blocks"] > 0
