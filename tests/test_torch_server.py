"""The port's live positioning server against the JAX package's.

``thrifty_tpu_torch.pipeline.server`` is the JAX package's server on the
port's numpy stages, with the batched solver on torch.  On
tests/test_server.py's scenarios (incremental, full rescan, a late
receiver, random feed order, ``keep_txid``, the feed sanitisation) both
servers get the same detections in the same chunks and must give the
same fixes: (timestamp, tx, group id, snr) exact, x/y within 1e-6 m and
dop within 1e-6 relative (the bar of tests/test_torch_pos.py).  The
tailer, ``serve --once`` (with ``--track``) and ``track`` are held
against their originals too.

The JAX package is imported inside the tests, so the ``cuda`` tests at
the end run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_server.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.io import toad  # noqa: E402
from thrifty_tpu_torch.pipeline import pos as pos_mod  # noqa: E402
from thrifty_tpu_torch.pipeline import server  # noqa: E402
from thrifty_tpu_torch.pipeline import track  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2.4e6
RX_POS = {0: np.array([0.0, 0.0]), 1: np.array([10000.0, 0.0]),
          2: np.array([5000.0, 7000.0])}
BEACON_POS = {9: np.array([5000.0, 2000.0])}
MOBILE_POS = {3: np.array([7000.0, 1000.0])}
# sim.synth_network stamps carrier_bin = 10 + 15*txid.
FREQMAP = {r: {9: (140.0, 150.0), 3: (50.0, 60.0)} for r in RX_POS}


def scenario(duration=40.0):
    """tests/test_server.py's network: a beacon every second, the mobile
    every 2 s, drifting receiver clocks."""
    schedule = [(9, t) for t in np.arange(0.5, duration, 1.0)]
    schedule += [(3, t) for t in np.arange(4.0, duration - 2, 2.0)]
    return sim.synth_network(
        RX_POS, {**BEACON_POS, **MOBILE_POS}, schedule, FS,
        clock_offsets={1: 123.0, 2: -77.0},
        clock_drifts={1: 2e-6, 2: -1e-6}, soa_noise=0.01)


def chunked(det, step, end):
    return [((det["timestamp"] >= t0) & (det["timestamp"] < t0 + step),
             t0 + step) for t0 in np.arange(0.0, end, step)]


def late_receiver():
    """rx 2 delivers everything 20 s late."""
    det = scenario(60.0)
    det = det[np.argsort(det["timestamp"], kind="stable")]
    late = det["rxid"] == 2
    chunks = []
    for t0 in np.arange(0.0, 84.0, 4.0):
        sel = (~late & (det["timestamp"] >= t0)
               & (det["timestamp"] < t0 + 4.0))
        sel |= (late & (det["timestamp"] >= t0 - 20.0)
                & (det["timestamp"] < t0 - 16.0))
        chunks.append((sel, t0 + 4.0))
    return det, chunks


def random_order(trial):
    """Per-record arrival lag and a random chunk length (seed 7)."""
    rng = np.random.default_rng(7)
    det = scenario(50.0)
    for _ in range(trial + 1):
        arrival = det["timestamp"] + rng.uniform(0, 3.0, size=len(det))
        edges = np.arange(0.0, 56.0, float(rng.uniform(2.0, 6.0)))
    return det, [((arrival >= a) & (arrival < b), b)
                 for a, b in zip(edges[:-1], edges[1:])]


def sanitisation(which):
    """feed()'s rejections: a receiver missing from the coordinates, a
    far-future clock glitch, a historical replay."""
    det = scenario(15.0)
    if which == "unknown_rx":
        bad = det[:5].copy()
        bad["rxid"] = 7
        return np.concatenate([det, bad]), {}
    if which == "future":
        glitch = det[:1].copy()
        glitch["timestamp"] = det["timestamp"].max() + 1e9
        return np.concatenate([det, glitch]), {"clock": lambda: 20.0}
    return det, {"clock": lambda: 1.8e9}


def scenario_case(name):
    """(detections, [(selection, now)], server keywords) of each of
    tests/test_server.py's scenarios."""
    if name == "incremental":
        det = scenario()
        return det, chunked(det, 5.0, 42.0), {}
    if name in ("frozen_prefix", "full_rescan"):
        det = scenario(60.0)
        return det, chunked(det, 5.0, 62.0), {
            "incremental": name == "frozen_prefix"}
    if name.startswith("late_arrival"):
        det, chunks = late_receiver()
        return det, chunks, {"incremental": name.endswith("incremental")}
    if name.startswith("random_order"):
        det, chunks = random_order(int(name[-1]))
        return det, chunks, {}
    if name.startswith("keep_txid"):
        det = scenario(60.0)
        return det, chunked(det, 5.0, 62.0), {
            "freqmap": None, "keep_txid": True,
            "incremental": name.endswith("incremental")}
    det, kw = sanitisation(name)
    return det, [(np.ones(len(det), bool), None)], kw


SCENARIOS = ["incremental", "frozen_prefix", "full_rescan",
             "late_arrival_incremental", "late_arrival_rescan",
             "random_order_0", "random_order_1", "random_order_2",
             "keep_txid_incremental", "keep_txid_rescan", "unknown_rx",
             "future", "replay"]


def run_server(module, det, chunks, **kw):
    kw = {"freqmap": FREQMAP, **kw}
    srv = module.PositioningServer(
        rx_pos=RX_POS, beacon_pos=BEACON_POS, sample_rate=FS,
        match_window=0.2, tdoa_est_window=8.0, window_s=30.0,
        settle_s=1.0, **kw)
    fixes = []
    for sel, now in chunks:
        srv.feed(det[sel])
        fixes.append(srv.step(now=now))
    return srv, np.concatenate(fixes)


def assert_same_fixes(got, ref, xy_atol=1e-6, dop_rtol=1e-6):
    """(timestamp, tx) sets equal, group id and snr exact, x/y within
    ``xy_atol`` metres, dop within ``dop_rtol``."""
    assert got.dtype == ref.dtype
    key = lambda f: np.lexsort((f["tx"], f["timestamp"]))
    got, ref = got[key(got)], ref[key(ref)]
    assert len(got) == len(ref)
    for col in ("timestamp", "tx", "group_id", "snr"):
        np.testing.assert_array_equal(got[col], ref[col], err_msg=col)
    for col in ("x", "y"):
        np.testing.assert_allclose(got[col], ref[col], rtol=0, atol=xy_atol,
                                   err_msg=col)
    np.testing.assert_allclose(got["dop"], ref["dop"], rtol=dop_rtol,
                               err_msg="dop")


@pytest.mark.parametrize("name", SCENARIOS)
def test_server_matches_jax(name, capsys):
    """The port's server on the CPU against JAX's on the same feed:
    equal fix sets, equal warnings, and the same frozen state."""
    from thrifty_tpu.pipeline import server as jax_server

    det, chunks, kw = scenario_case(name)
    srv, got = run_server(server, det, chunks, device="cpu", **kw)
    port_err = capsys.readouterr().err
    jsrv, ref = run_server(jax_server, det, chunks, **kw)
    assert port_err == capsys.readouterr().err
    assert len(ref) > 0
    assert_same_fixes(got, ref)
    assert srv.incremental == jsrv.incremental
    assert len(srv._frz_rows) == len(jsrv._frz_rows)
    assert sorted(srv._solved) == sorted(jsrv._solved)
    if name in ("frozen_prefix", "keep_txid_incremental"):
        assert len(srv._frz_rows) > 0  # the freeze engaged


def test_scipy_solver_matches_jax():
    """solver='scipy' is the host solver on both sides (no device)."""
    from thrifty_tpu.pipeline import server as jax_server

    det, chunks, _ = scenario_case("incremental")
    srv, got = run_server(server, det, chunks, solver="scipy")
    assert srv.device is None
    _, ref = run_server(jax_server, det, chunks, solver="scipy")
    assert_same_fixes(got, ref, xy_atol=1e-9, dop_rtol=1e-12)


def test_empty_and_single_group_steps():
    """A step with nothing to solve returns JAX's empty fix array, a
    step with one group one fix, and the solver sees no device error."""
    from thrifty_tpu.pipeline import server as jax_server

    det = scenario(12.0)
    det = det[np.argsort(det["timestamp"], kind="stable")]
    first = det["timestamp"] < 5.3   # beacons plus one mobile burst (4 s)
    for module, kw in ((server, {"device": "cpu"}), (jax_server, {})):
        srv = module.PositioningServer(
            rx_pos=RX_POS, beacon_pos=BEACON_POS, freqmap=FREQMAP,
            sample_rate=FS, match_window=0.2, window_s=30.0, settle_s=1.0,
            **kw)
        empty = srv.step(now=1.0)
        srv.feed(det[first])
        one = srv.step(now=5.3)
        if module is server:
            got = (empty, one)
        else:
            ref = (empty, one)
    assert got[0].dtype == ref[0].dtype and len(got[0]) == len(ref[0]) == 0
    assert len(ref[1]) == 1
    assert_same_fixes(got[1], ref[1])


def test_unknown_solver_and_device():
    with pytest.raises(ValueError, match="unknown solver"):
        server.PositioningServer(RX_POS, BEACON_POS, solver="lm")
    with pytest.raises(ValueError, match="unknown device"):
        server.PositioningServer(RX_POS, BEACON_POS, device="meta")


def test_batched_server_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the batched server asks for the card in its
    constructor and raises where there is none; the scipy server needs
    no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for solver in ("auto", "batched"):
        with pytest.raises(RuntimeError, match="cuda"):
            server.PositioningServer(RX_POS, BEACON_POS, solver=solver)
    assert server.PositioningServer(RX_POS, BEACON_POS,
                                    solver="scipy").device is None


def tailer_lines(module, tmp_path, name):
    """tests/test_server.py's tailer cases: a partial line completed
    later, a same-size rotation, a file with no newline yet."""
    det = scenario(3.0)
    polls = []
    path = tmp_path / (name + ".toad")
    full = toad.format_line(det[0]) + "\n"
    partial = toad.format_line(det[1])
    path.write_text(full + partial[:20])
    tailer = module.ToadTailer([str(path)])
    polls.append(tailer.poll())
    with open(path, "a") as f:
        f.write(partial[20:] + "\n")
    polls.append(tailer.poll())
    rotated = tmp_path / (name + ".new")
    rotated.write_text(full + partial + "\n" + toad.format_line(det[2])
                       + "\n")
    rotated.replace(path)
    polls.append(tailer.poll())
    empty = tmp_path / (name + ".empty")
    empty.write_text("0 1.5")
    quiet = module.ToadTailer([str(empty), str(tmp_path / "missing")])
    polls += [quiet.poll(), quiet.poll()]
    return polls


def test_toad_tailer_matches_jax(tmp_path):
    from thrifty_tpu.pipeline import server as jax_server

    got = tailer_lines(server, tmp_path, "port")
    ref = tailer_lines(jax_server, tmp_path, "jax")
    assert [len(p) for p in got] == [1, 1, 3, 0, 0]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def write_serve_inputs(d, det):
    for rxid in RX_POS:
        toad.save(str(d / "rx{}.toad".format(rxid)), det[det["rxid"] == rxid])
    (d / "pos-rx.cfg").write_text("".join(
        "{}: {} {}\n".format(r, p[0], p[1]) for r, p in RX_POS.items()))
    (d / "pos-beacon.cfg").write_text("9: 5000.0 2000.0\n")
    (d / "freq-map.cfg").write_text(
        "9: 140 - 150\n3: 50 - 60\n@0: 0\n@1: 0\n@2: 0\n")


def serve_args(d, out, trk):
    return [str(d / "rx{}.toad".format(r)) for r in RX_POS] + [
        "-o", str(out), "--track", str(trk),
        "-r", str(d / "pos-rx.cfg"), "-b", str(d / "pos-beacon.cfg"),
        "-m", str(d / "freq-map.cfg"), "--once"]


def test_serve_once_cli_matches_jax(tmp_path, capsys):
    """``serve --once --track`` through the port's CLI on tailed .toad
    files: the .pos and the track file as JAX's ``serve`` writes them
    (fixes within 1e-6 m; each track line's numbers within 1e-6)."""
    from thrifty_tpu.pipeline import server as jax_server
    from thrifty_tpu_torch.cli import main

    write_serve_inputs(tmp_path, scenario(20.0))
    assert main(["serve"] + serve_args(tmp_path, tmp_path / "port.pos",
                                       tmp_path / "port.track")
                + ["--device", "cpu"]) == 0
    port_err = capsys.readouterr().err
    assert jax_server._main(serve_args(tmp_path, tmp_path / "jax.pos",
                                       tmp_path / "jax.track")) is None
    jax_err = capsys.readouterr().err
    assert port_err.count("fix:") == jax_err.count("fix:") >= 5
    got = pos_mod.load_positions(str(tmp_path / "port.pos"))
    ref = pos_mod.load_positions(str(tmp_path / "jax.pos"))
    assert_same_fixes(got, ref)
    for row in got:
        assert np.hypot(row["x"] - 7000.0, row["y"] - 1000.0) < 30.0
    got = np.loadtxt(tmp_path / "port.track", ndmin=2)
    ref = np.loadtxt(tmp_path / "jax.track", ndmin=2)
    assert got.shape == ref.shape and len(ref) >= 5
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_serve_interval_usage_error(tmp_path):
    from thrifty_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["serve", str(tmp_path / "rx.toad"), "--interval", "40",
              "--device", "cpu"])


def test_serve_without_card_raises(tmp_path, monkeypatch):
    """``serve`` asks for the card by default and raises without one,
    before it opens its output."""
    from thrifty_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_serve_inputs(tmp_path, scenario(6.0))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["serve"] + serve_args(tmp_path, tmp_path / "live.pos",
                                    tmp_path / "live.track"))
    assert not (tmp_path / "live.pos").exists()


def moving_target_fixes(n=60, noise=8.0, seed=0):
    """tests/test_track.py's target: 3 m/s east, 1 m/s north, one fix a
    second with Gaussian noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    out = np.zeros(n, dtype=pos_mod.position_dtype(2))
    out["group_id"] = np.arange(n)
    out["timestamp"], out["tx"], out["dop"], out["snr"] = t, 3, 1.0, 100.0
    out["x"] = 1000.0 + 3.0 * t + rng.normal(0, noise, n)
    out["y"] = 2000.0 + 1.0 * t + rng.normal(0, noise, n)
    return out


def track_cases():
    fixes = moving_target_fixes()
    other = moving_target_fixes(n=10, seed=1)
    other["tx"], other["x"] = 7, other["x"] + 5000.0
    singular = moving_target_fixes(n=10)
    singular["x"][4] += 1e6
    singular["dop"][4] = -1.0
    gap = moving_target_fixes(n=20, seed=2)
    gap["timestamp"][10:] += 120.0
    return {"noise": (fixes, dict(accel_std=0.5, meas_std=8.0)),
            "velocity": (moving_target_fixes(noise=2.0),
                         dict(accel_std=0.2, meas_std=2.0)),
            "two_tx": (np.concatenate([fixes[:10], other]), {}),
            "singular": (singular, {}),
            "gap": (gap, {})}


@pytest.mark.parametrize("case", sorted(track_cases()))
def test_track_matches_jax(case):
    """track_positions, update_states and live_update on
    tests/test_track.py's cases: equal tracks."""
    from thrifty_tpu.pipeline import track as jax_track

    fixes, kw = track_cases()[case]
    got = track.track_positions(fixes, **kw)
    ref = jax_track.track_positions(fixes, **kw)
    assert got.dtype == ref.dtype and len(ref) > 0
    np.testing.assert_array_equal(got, ref)
    got = [(tx, t, s.tolist()) for tx, t, s in track.update_states({}, fixes)]
    ref = [(tx, t, s.tolist()) for tx, t, s in
           jax_track.update_states({}, fixes)]
    assert got == ref
    trackers, jax_trackers = {}, {}
    for lo in range(0, len(fixes), 7):
        assert list(track.live_update(trackers, fixes[lo:lo + 7])) \
            == list(jax_track.live_update(jax_trackers, fixes[lo:lo + 7]))


def test_track_cli_matches_jax(tmp_path):
    """``track`` through the port's CLI on a made-up .pos file and on
    tests/golden/data.pos: byte-equal track files."""
    from thrifty_tpu.pipeline import track as jax_track
    from thrifty_tpu_torch.cli import main

    made = str(tmp_path / "data.pos")
    pos_mod.save_positions(made, moving_target_fixes(n=12))
    for k, posfile in enumerate((made, os.path.join(ROOT, "tests", "golden",
                                                    "data.pos"))):
        port, ref = tmp_path / "port{}".format(k), tmp_path / "jax{}".format(k)
        assert main(["track", posfile, "-o", str(port)]) == 0
        jax_track._main([posfile, "-o", str(ref)])
        assert port.read_text() == ref.read_text()
        assert len(port.read_text().splitlines()) >= 3
    assert len((tmp_path / "port0").read_text().splitlines()) == 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["incremental", "full_rescan",
                                  "late_arrival_incremental",
                                  "keep_txid_incremental"])
def test_server_card_matches_cpu(cuda_device, name):
    """The batched solver on the card against the same server on the
    CPU: the same (timestamp, tx) fix sets, x/y within 1e-4 m."""
    det, chunks, kw = scenario_case(name)
    srv, got = run_server(server, det, chunks, device=cuda_device, **kw)
    assert srv.device.type == "cuda"
    _, ref = run_server(server, det, chunks, device="cpu", **kw)
    assert len(ref) > 0
    assert_same_fixes(got, ref, xy_atol=1e-4, dop_rtol=1e-4)


@pytest.mark.cuda
def test_serve_once_cli_on_the_card(cuda_device, tmp_path):
    """``serve --once --track`` on the card in a subprocess (as an
    operator runs it) against the same command on the CPU."""
    write_serve_inputs(tmp_path, scenario(20.0))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for dev in ("cuda", "cpu"):
        proc = subprocess.run(
            [sys.executable, "-m", "thrifty_tpu_torch.cli", "serve"]
            + serve_args(tmp_path, tmp_path / (dev + ".pos"),
                         tmp_path / (dev + ".track"))
            + ["--device", dev], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
    got = pos_mod.load_positions(str(tmp_path / "cuda.pos"))
    ref = pos_mod.load_positions(str(tmp_path / "cpu.pos"))
    assert len(ref) >= 5
    assert_same_fixes(got, ref, xy_atol=1e-4, dop_rtol=1e-4)
