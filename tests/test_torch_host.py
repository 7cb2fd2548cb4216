"""The port's copies of the JAX package's numpy host modules against
their originals, on the same inputs.

The port keeps its own ``config``, ``io``, ``native``, ``dsp.{util,
gold,template}``, ``dsp.iq.raw_to_iq_host``, ``stats``, ``sim``,
``pipeline.{identify,matchmaker,tdoa,track,scope}``, the host half of
``pipeline.pos``, ``oracle.numpy_ref`` and the four ``analysis``
modules, so that it imports nothing of ``thrifty_tpu``.  Each
case below runs a copy and its original on the same input: arrays equal
(bit for bit where the function is deterministic numpy), files
byte-equal, the host position solver within 1e-9 m.
"""

import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import thrifty_tpu.config as jconfig  # noqa: E402
import thrifty_tpu_torch.config as tconfig  # noqa: E402
from test_pos import PAIRS4, RX4, forward_tdoas  # noqa: E402
from thrifty_tpu import sim as jsim  # noqa: E402
from thrifty_tpu import stats as jstats  # noqa: E402
from thrifty_tpu.analysis import beacon_analysis as jbeacon  # noqa: E402
from thrifty_tpu.analysis import tdoa_analysis as jtdoa_an  # noqa: E402
from thrifty_tpu.analysis import toads_analysis as jtoads_an  # noqa: E402
from thrifty_tpu.dsp import gold as jgold  # noqa: E402
from thrifty_tpu.dsp import iq as jiq  # noqa: E402
from thrifty_tpu.dsp import template as jtemplate  # noqa: E402
from thrifty_tpu.dsp import util as jutil  # noqa: E402
from thrifty_tpu.io import blocks as jblocks  # noqa: E402
from thrifty_tpu.io import card as jcard  # noqa: E402
from thrifty_tpu.io import stream as jstream  # noqa: E402
from thrifty_tpu.io import toad as jtoad  # noqa: E402
from thrifty_tpu.io import tpl as jtpl  # noqa: E402
from thrifty_tpu.oracle import numpy_ref as joracle  # noqa: E402
from thrifty_tpu.pipeline import identify as jidentify  # noqa: E402
from thrifty_tpu.pipeline import matchmaker as jmatch  # noqa: E402
from thrifty_tpu.pipeline import pos as jpos  # noqa: E402
from thrifty_tpu.pipeline import scope as jscope  # noqa: E402
from thrifty_tpu.pipeline import tdoa as jtdoa  # noqa: E402
from thrifty_tpu.pipeline import track as jtrack  # noqa: E402
from thrifty_tpu_torch import sim as tsim  # noqa: E402
from thrifty_tpu_torch import stats as tstats  # noqa: E402
from thrifty_tpu_torch.analysis import beacon_analysis as tbeacon  # noqa: E402
from thrifty_tpu_torch.analysis import tdoa_analysis as ttdoa_an  # noqa: E402
from thrifty_tpu_torch.analysis import toads_analysis as ttoads_an  # noqa: E402
from thrifty_tpu_torch.dsp import gold as tgold  # noqa: E402
from thrifty_tpu_torch.dsp import iq as tiq  # noqa: E402
from thrifty_tpu_torch.dsp import template as ttemplate  # noqa: E402
from thrifty_tpu_torch.dsp import util as tutil  # noqa: E402
from thrifty_tpu_torch.io import blocks as tblocks  # noqa: E402
from thrifty_tpu_torch.io import card as tcard  # noqa: E402
from thrifty_tpu_torch.io import stream as tstream  # noqa: E402
from thrifty_tpu_torch.io import toad as ttoad  # noqa: E402
from thrifty_tpu_torch.io import tpl as ttpl  # noqa: E402
from thrifty_tpu_torch.oracle import numpy_ref as toracle  # noqa: E402
from thrifty_tpu_torch.pipeline import identify as tidentify  # noqa: E402
from thrifty_tpu_torch.pipeline import matchmaker as tmatch  # noqa: E402
from thrifty_tpu_torch.pipeline import pos as tpos  # noqa: E402
from thrifty_tpu_torch.pipeline import scope as tscope  # noqa: E402
from thrifty_tpu_torch.pipeline import tdoa as ttdoa  # noqa: E402
from thrifty_tpu_torch.pipeline import track as ttrack  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
INPUT = os.path.join(GOLDEN, "input")
FASTDET = os.path.join(GOLDEN, "fastdet")
RAW0 = os.path.join(FASTDET, "input", "rx0.raw")
CARDS = [os.path.join(INPUT, "rx%d.card" % i) for i in range(3)] + [
    os.path.join(FASTDET, name) for name in ("gated.card", "tee.card")]


def native_modules():
    """(port, JAX) native engines; the test needs g++, as the JAX
    package's own native tests do."""
    try:
        from thrifty_tpu import native as jnative
        from thrifty_tpu_torch import native as tnative
    except ImportError as e:
        pytest.skip("native host engine not built: {}".format(e))
    return tnative, jnative


def assert_same(got, ref, what=""):
    """Equal structure and bit-equal arrays (NaNs compare equal)."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref), what
        for k, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, "{}[{}]".format(what, k))
    elif isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            assert_same(got[k], ref[k], "{}[{!r}]".format(what, k))
    elif isinstance(ref, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == ref.dtype and got.shape == ref.shape, what
        if ref.dtype.names:
            for name in ref.dtype.names:
                assert_same(got[name], ref[name], what + "." + name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        assert got == ref, what


def with_native(monkeypatch, native):
    """Both card modules on the native engine or on the numpy path."""
    if native:
        native_modules()
    else:
        monkeypatch.setattr(tcard, "_native_mod", False)
        monkeypatch.setattr(jcard, "_native_mod", False)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("path", CARDS, ids=os.path.basename)
def test_card_reading(monkeypatch, path, native):
    """read_card, read_card_blocks and iter_card_batches: arrays equal."""
    with_native(monkeypatch, native)
    assert_same(tcard.read_card(path, native=native),
                jcard.read_card(path, native=native), "read_card")
    assert_same(tcard.read_card_blocks(path), jcard.read_card_blocks(path),
                "read_card_blocks")
    with open(path) as f:
        got = list(tcard.iter_card_batches(f, 7))
    with open(path) as f:
        ref = list(jcard.iter_card_batches(f, 7))
    assert_same(got, ref, "iter_card_batches")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_write_card(monkeypatch, tmp_path, native):
    """write_card: byte-equal files, header included."""
    with_native(monkeypatch, native)
    ts, idx, raw = jcard.read_card(CARDS[0], native=False)
    for name, mod in (("port", tcard), ("jax", jcard)):
        mod.write_card(str(tmp_path / name), ts, idx, raw,
                       header="capture\nsecond line")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_toad_io(tmp_path):
    """.toad and .toads load/save: arrays equal, files byte-equal."""
    for i in range(3):
        path = os.path.join(GOLDEN, "rx%d.toad" % i)
        assert_same(ttoad.load_toad(path), jtoad.load_toad(path))
    toads = os.path.join(GOLDEN, "rx.toads")
    det = jtoad.load_toads(toads)
    assert_same(ttoad.load_toads(toads), det)
    for with_txid in (False, True):
        got, ref = io.StringIO(), io.StringIO()
        ttoad.save(got, det, with_txid=with_txid)
        jtoad.save(ref, det, with_txid=with_txid)
        assert got.getvalue() == ref.getvalue()


def test_template_io(tmp_path):
    """load_template (.npy) and the .tpl format: arrays equal."""
    path = os.path.join(INPUT, "template.npy")
    tpl = jtpl.load_template(path)
    assert_same(ttpl.load_template(path), tpl)
    ttpl.save_tpl(str(tmp_path / "port.tpl"), tpl)
    jtpl.save_tpl(str(tmp_path / "jax.tpl"), tpl)
    assert (tmp_path / "port.tpl").read_bytes() \
        == (tmp_path / "jax.tpl").read_bytes()
    assert_same(ttpl.load_template(str(tmp_path / "port.tpl")),
                jtpl.load_template(str(tmp_path / "jax.tpl")))


def pump_batches(mod, source, contiguous):
    with open(RAW0, "rb") as f:
        stream = f if source == "mmap" else io.BytesIO(f.read())
        pump = mod.StreamPump(stream, 2048, 256, 8, t0=0.0)
        try:
            it = pump.batches_contiguous() if contiguous else pump.batches()
            return [tuple(np.array(a) for a in batch) for batch in it]
        finally:
            pump.close()


@pytest.mark.parametrize("contiguous", [False, True],
                         ids=["batches", "batches_contiguous"])
@pytest.mark.parametrize("source", ["mmap", "ring"])
def test_stream_pump(source, contiguous):
    """StreamPump on fastdet's rx0.raw, from a mapped file and through
    the ring buffer: the same batches."""
    native_modules()
    got = pump_batches(tstream, source, contiguous)
    assert got
    assert_same(got, pump_batches(jstream, source, contiguous))


def test_raw_batches():
    """io.blocks.raw_batches with the t0 stamper (no native engine)."""
    def run(mod):
        stamper = mod.make_t0_stamper(0.0, 2048, 256, 2.4e6)
        with open(RAW0, "rb") as f:
            return list(mod.raw_batches(f, 2048, 256, 8, stamper))
    assert_same(run(tblocks), run(jblocks))


def test_native_engine():
    """The native engine's base64, .card scan, LUT conversion, unfold
    and copy_rows: equal outputs."""
    tnative, jnative = native_modules()
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, size=(9, 300), dtype=np.uint8)
    enc = [tnative.b64encode(r) for r in rows]
    assert enc == [jnative.b64encode(r) for r in rows]
    assert_same(tnative.b64decode_batch(enc), jnative.b64decode_batch(enc))
    junk = enc[:4] + ["not base64!", enc[0][:40]] + enc[4:]
    assert_same(tnative.b64decode_batch_tolerant(junk),
                jnative.b64decode_batch_tolerant(junk))
    with open(CARDS[0], "rb") as f:
        text = f.read()
    assert_same(tnative.card_scan(text), jnative.card_scan(text))
    assert_same(tnative.parse_card_bytes(text),
                jnative.parse_card_bytes(text))
    assert_same(tnative.raw_to_iq_f32(rows), jnative.raw_to_iq_f32(rows))
    stream = rng.integers(0, 256, size=5000, dtype=np.uint8)
    for hist in (0, 100, 250):
        assert_same(tnative.unfold(stream, 400, hist, 14, fill=128),
                    jnative.unfold(stream, 400, hist, 14, fill=128))
    outs = [np.empty((6, 333), np.uint8) for _ in range(2)]
    tnative.copy_rows(stream, 17, outs[0], 401)
    jnative.copy_rows(stream, 17, outs[1], 401)
    assert_same(outs[0], outs[1])


def test_config_parsing():
    """detector.cfg through load_settings, and the threshold and
    frequency parsers: equal values."""
    path = os.path.join(INPUT, "detector.cfg")
    with open(path) as f:
        lines = f.readlines()
    assert_same(tconfig.settings.parse_kv_config(lines),
                jconfig.settings.parse_kv_config(lines))
    got = tconfig.settings.load_settings(config_file=lines)
    ref = jconfig.settings.load_settings(config_file=lines)
    assert got == ref and len(ref) > 10
    for s in ("15 * snr", "3 + 15s + 2d", "15s+2d", "40"):
        assert tconfig.parsers.threshold(s) == jconfig.parsers.threshold(s)
    for s in ("7 - 110", "-100--10", "1.2k-3.4k Hz", "433.8M"):
        try:
            ref = jconfig.parsers.freq_range(s)
        except ValueError:
            with pytest.raises(ValueError):
                tconfig.parsers.freq_range(s)
            continue
        assert tconfig.parsers.freq_range(s) == ref
    for s in ("2.4M", "999.707k", "1e3", "12"):
        assert tconfig.parsers.metric_float(s) \
            == jconfig.parsers.metric_float(s)
    with pytest.raises(tconfig.settings.UnknownSettingError):
        tconfig.settings.load_settings(config_file=["no_such_key: 1\n"])


def chain(identify, match, tdoa, toad):
    det = np.concatenate([toad.load_toad(os.path.join(
        GOLDEN, "rx%d.toad" % i)) for i in range(3)])
    with open(os.path.join(INPUT, "freq-map.cfg")) as f:
        freqmap = identify.load_freqmap(f)
    toads = identify.integrate(det, freqmap)
    matches, misses, collisions = match.match_detections(toads, 0.02)
    groups, failures = tdoa.estimate_tdoas(
        toads, matches, 8.0,
        tdoa.load_pos_config(os.path.join(INPUT, "pos-beacon.cfg")),
        tdoa.load_pos_config(os.path.join(INPUT, "pos-rx.cfg")), 2.4e6)
    return (toads, [list(m) for m in matches], list(misses),
            [list(c) for c in collisions],
            [(g.group_id, g.timestamp, g.tx, g.tdoas) for g in groups],
            failures)


def test_identify_match_tdoa_chain():
    """identify -> match -> tdoa on the golden .toad files: equal
    detections, matches and TDOA groups."""
    got = chain(tidentify, tmatch, ttdoa, ttoad)
    ref = chain(jidentify, jmatch, jtdoa, jtoad)
    assert len(ref[4]) > 0
    assert_same(got, ref)


RX5 = {0: np.array([0.0, 0.0, 0.0]), 1: np.array([9000.0, 500.0, 50.0]),
       2: np.array([4000.0, 8000.0, 120.0]),
       3: np.array([-2000.0, 6000.0, 10.0]),
       4: np.array([3000.0, -4000.0, 200.0])}
PAIRS5 = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4)]


def pos_groups():
    """tests/test_pos.py's cases: (rx_pos, groups, weighted)."""
    noisy = forward_tdoas(np.array([5000.0, 3000.0]), RX4, PAIRS4,
                          snr=10000.0)
    noisy["tdoa"][2] += 300.0 / tpos.SPEED_OF_LIGHT
    noisy["snr"][2] = 1.0
    cases = []
    for k, tx in enumerate(([3000.0, 3000.0], [7500.0, 2500.0],
                            [-500.0, 4000.0], [4810.5, 5213.25],
                            [6000.0, 3500.0])):
        cases.append((RX4, forward_tdoas(np.array(tx), RX4, PAIRS4), k))
    cases += [(RX4, noisy, 5),
              (RX5, forward_tdoas(np.array([3500.0, 2500.0, 300.0]), RX5,
                                  PAIRS5), 6),
              (RX4, forward_tdoas(np.array([1.0, 2.0]), RX4, [(0, 1)]), 7)]
    return [(rx, [jtdoa.TdoaGroup(group_id=k, timestamp=float(k), tx=3,
                                  tdoas=t)], w)
            for rx, t, k in cases for w in (False, True)]


@pytest.mark.parametrize("case", range(16))
def test_host_position_solver(case):
    """solve (solve_group and DOP inside), on tests/test_pos.py's
    cases, weighted and not: fixes within 1e-9 m, DOP and the
    underdetermined skip equal."""
    rx_pos, groups, weighted = pos_groups()[case]
    got = tpos.solve(groups, rx_pos, weighted=weighted, verbose=False)
    ref = jpos.solve(groups, rx_pos, weighted=weighted, verbose=False)
    assert got.dtype == ref.dtype and len(got) == len(ref)
    for name in ref.dtype.names:
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=1e-9, err_msg=name)


def test_host_position_helpers(tmp_path):
    """solve_1d, dop, the batched DOP and the .pos I/O."""
    rx1 = {0: np.array([0.0]), 1: np.array([10000.0])}
    t1 = forward_tdoas(np.array([3000.0]), rx1, [(0, 1)])
    assert_same(tpos.solve_1d(t1, rx1), jpos.solve_1d(t1, rx1))
    for p in ([4000.0, 4000.0], [40000.0, 40000.0]):
        assert tpos.dop(p, RX4, PAIRS4) == jpos.dop(p, RX4, PAIRS4)
    rng = np.random.default_rng(2)
    positions = rng.uniform(-2000, 9000, (5, 2))
    r0 = np.array([[RX4[a] for a, _ in PAIRS4]] * 5)
    r1 = np.array([[RX4[b] for _, b in PAIRS4]] * 5)
    mask = np.ones((5, len(PAIRS4)), bool)
    mask[1, 3:] = False
    assert_same(tpos._dop_batched(positions, r0, r1, mask),
                jpos._dop_batched(positions, r0, r1, mask))
    _, groups, _ = pos_groups()[0]
    fixes = jpos.solve(groups, RX4)
    tpos.save_positions(str(tmp_path / "port.pos"), fixes)
    jpos.save_positions(str(tmp_path / "jax.pos"), fixes)
    assert (tmp_path / "port.pos").read_bytes() \
        == (tmp_path / "jax.pos").read_bytes()
    assert_same(tpos.load_positions(str(tmp_path / "port.pos")),
                jpos.load_positions(str(tmp_path / "jax.pos")))


def capture_fields(cap):
    return (cap.timestamps, cap.indices, cap.blocks, cap.template,
            [tuple(vars(b).values()) for b in cap.bursts])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim(seed):
    """synth_capture and synth_rx_captures: bit-equal captures and
    ground truth for three seeds."""
    tpl = jtemplate.generate(5, 0, 2.0)
    kw = dict(num_blocks=6, bursts_every=2, template=tpl, block_len=2048,
              history_len=256, seed=seed, frac_jitter=seed == 1)
    assert_same(capture_fields(tsim.synth_capture(**kw)),
                capture_fields(jsim.synth_capture(**kw)))
    net = dict(rx_pos={0: np.zeros(2), 1: np.array([900.0, 50.0])},
               tx_pos={0: np.array([300.0, 400.0])}, tx_bins={0: 40},
               tx_schedule=[(0, 0.0004), (0, 0.0031)], template=tpl,
               num_blocks=6, block_len=2048, history_len=256,
               clock_offsets={1: 7.25}, clock_drifts={1: 2e-6}, seed=seed)
    got = tsim.synth_rx_captures(**net)
    ref = jsim.synth_rx_captures(**net)
    assert set(got) == set(ref)
    for rx in ref:
        assert_same(capture_fields(got[rx]), capture_fields(ref[rx]))
    sched = [(0, 0.001), (0, 0.002)]
    assert_same(tsim.synth_network(net["rx_pos"], net["tx_pos"], sched,
                                   seed=seed),
                jsim.synth_network(net["rx_pos"], net["tx_pos"], sched,
                                   seed=seed))


def test_codes_templates_and_small_helpers():
    """Gold codes, templates and banks, raw_to_iq_host, stats and
    dsp.util: equal."""
    for bits in (5, 7, 11):
        for index in (0, 3):
            assert_same(tgold.gold(bits, index), jgold.gold(bits, index))
    assert_same(ttemplate.generate_bank(11, [0, 1, 2], 2.4e6 / 0.999707e6),
                jtemplate.generate_bank(11, [0, 1, 2], 2.4e6 / 0.999707e6))
    assert_same(ttemplate.generate(7, 2, 2.5), jtemplate.generate(7, 2, 2.5))
    assert_same(tsim.make_template(), jsim.make_template())
    raw = np.arange(512, dtype=np.uint16).astype(np.uint8).reshape(2, 256)
    assert_same(tiq.raw_to_iq_host(raw), jiq.raw_to_iq(raw))
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(size=50), [40.0, -35.0]])
    assert_same(tstats.is_outlier(pts), jstats.is_outlier(pts))
    x = np.sort(rng.uniform(0, 10, 200))
    y = np.sin(x) + rng.normal(0, 0.1, 200)
    assert_same(tstats.lowess(x, y, 0.1), jstats.lowess(x, y, 0.1))
    assert tutil.snr_db(10.0, 2.0) == jutil.snr_db(10.0, 2.0)
    assert [tutil.fft_bin(i, 16) for i in range(16)] \
        == [jutil.fft_bin(i, 16) for i in range(16)]


@pytest.mark.parametrize("fastdet", [False, True], ids=["python", "fastdet"])
def test_oracle(fastdet):
    """OracleDetector and FastdetOracleDetector on synthetic blocks (a
    burst, noise, a peak filter): equal results and soa."""
    tpl = jtemplate.generate(5, 0, 2.0)
    cap = jsim.synth_capture(num_blocks=4, bursts_every=2, template=tpl,
                             block_len=2048, history_len=256,
                             carrier_bin=40.25, seed=2)
    weights = np.array([0.3, 0.6, 1.0, 0.6, 0.3])
    results = {}
    for name, mod in (("port", toracle), ("jax", joracle)):
        cls = mod.FastdetOracleDetector if fastdet else mod.OracleDetector
        for pf in (None, weights / np.linalg.norm(weights)):
            det = cls(tpl, block_len=2048, history_len=256,
                      carrier_window=(7, 110), peak_filter=pf)
            out = [vars(det.detect_block(b)) for b in cap.blocks]
            out.append(det.soa(np.arange(4), np.array([3, 40, 500, 9]),
                               np.array([0.1, -0.3, 0.0, 0.49])))
            results.setdefault(name, []).append(out)
    assert_same(results["port"], results["jax"])
    assert any(r["detected"] for r in results["jax"][0][:4])
    x = np.linspace(-40, 40, 161)
    assert_same(toracle.dirichlet_kernel(x, 2048, 300),
                joracle.dirichlet_kernel(x, 2048, 300))


def test_track_copy():
    """KalmanTracker on fixes out of timestamp order (no extrapolation
    backwards), and the .track text: equal states, equal lines."""
    rng = np.random.default_rng(3)
    times = rng.uniform(0, 60, 30)
    xy = rng.normal(0, 50, (30, 2))
    dops = rng.uniform(0.05, 3.0, 30)
    states = {}
    for name, mod in (("port", ttrack), ("jax", jtrack)):
        tracker = mod.KalmanTracker(accel_std=0.3, meas_std=9.0)
        states[name] = [tracker.update(t, p, d)
                        for t, p, d in zip(times, xy, dops)]
        states[name].append(tracker.cov)
    assert_same(states["port"], states["jax"])
    fixes = np.zeros(30, dtype=jpos.position_dtype(2))
    fixes["timestamp"], fixes["tx"], fixes["dop"] = times, 3, dops
    fixes["x"], fixes["y"] = xy[:, 0], xy[:, 1]
    tracks = jtrack.track_positions(fixes)
    got, ref = io.StringIO(), io.StringIO()
    ttrack.save_tracks(got, tracks)
    jtrack.save_tracks(ref, tracks)
    assert got.getvalue() == ref.getvalue() and len(ref.getvalue()) > 0
    assert ttrack.TRACK_FIELDS == jtrack.TRACK_FIELDS


def test_analysis_helpers():
    """The analyses' statistics on the golden rx.toads and data.tdoa:
    equal printed stats, per-(rx, tx) splits, beacon pairs and clock-model
    reports, TDOA stats."""
    det = jtoad.load_toads(os.path.join(GOLDEN, "rx.toads"))
    got, ref = io.StringIO(), io.StringIO()
    ttoads_an.print_stats(det, file=got)
    jtoads_an.print_stats(det, file=ref)
    assert got.getvalue() == ref.getvalue()
    assert_same({str(k): v for k, v in ttoads_an.split_rxtx(det).items()},
                {str(k): v for k, v in jtoads_an.split_rxtx(det).items()})
    beacon = int(np.bincount(det["txid"]).argmax())
    for rx0, rx1 in ((0, 1), (1, 2)):
        sel, pairs = tbeacon.beacon_match_pairs(det, rx0, rx1, beacon, 0.02)
        ref_sel, ref_pairs = jbeacon.beacon_match_pairs(det, rx0, rx1,
                                                        beacon, 0.02)
        assert_same((sel, pairs), (ref_sel, ref_pairs))
        assert len(pairs) > 3
        assert_same(tbeacon.analyze(sel, pairs), jbeacon.analyze(sel, pairs))
    sdoa = np.concatenate([np.arange(10.0), 500 + np.arange(5.0)])
    assert_same(tbeacon.find_discontinuities(sdoa),
                jbeacon.find_discontinuities(sdoa))
    groups = jtdoa.load_tdoa_groups(os.path.join(GOLDEN, "data.tdoa"))
    for kw in ({}, {"tx": int(groups[0].tx)},
               {"timestamp_range": (groups[0].timestamp,
                                    groups[-1].timestamp - 1.0)}):
        assert_same(ttdoa_an.tdoa_stats(groups, 0, 1, **kw),
                    jtdoa_an.tdoa_stats(groups, 0, 1, **kw))


def test_scope_copy():
    """iter_blocks over short reads and the scope's trigger state: the
    same blocks, triggers, frames and waterfall."""
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=2 * 1024 * 5 + 100, dtype=np.uint8)
    raw[2 * 1024 * 2:2 * 1024 * 2 + 64] = 255  # a hot block

    class Trickle(io.BytesIO):
        def read(self, n=-1):
            return super().read(min(n, 700))

    out = {}
    for name, mod in (("port", tscope), ("jax", jscope)):
        blocks = list(mod.iter_blocks(Trickle(raw.tobytes()), 1024))
        state = mod.ScopeState(1024, 2.4e6, trigger_time=0.9,
                               trigger_freq=-20.0, waterfall_rows=8)
        trig = [state.feed(b) for b in blocks]
        out[name] = (blocks, trig, state.frame, state.waterfall, state.freqs)
    assert_same(out["port"], out["jax"])
    assert len(out["jax"][0]) == 5 and any(out["jax"][1])
