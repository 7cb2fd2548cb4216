"""The port's sharded detection (thrifty_tpu_torch.parallel), in one
process on the CPU, against the JAX package's sharded programs.

The rank program (``sharded._local_detect``) runs for every rank of an
(rx, time) grid, each rank's halo handed over from its time neighbour's
tail as the halo exchange would, and the stitched table is held against
JAX's ``make_stream_detector`` / ``make_stream_detector_gspmd`` on
conftest's 8-device CPU mesh at the same (rx, time) shape, on the cases
of tests/test_sharded.py, tests/test_window_edges.py's rank-boundary
edge and seeded random geometries.  Decisions, ``carrier_bin``,
``corr_sample``, ``template_idx`` and ``block_idx`` exact; the offsets
within 2e-4 (tests/test_sharded.py's tolerance); energies and noise
within 1e-4 relative (the port's detector against JAX's,
tests/test_torch_detector.py).  The spawned multi-rank worlds are in
tests/test_torch_multirank.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import template  # noqa: E402
from thrifty_tpu.dsp.detector import BatchDetector as JaxDetector  # noqa
from thrifty_tpu.dsp.detector import DetectorConfig as JaxConfig  # noqa
from thrifty_tpu.io import toad  # noqa: E402
from thrifty_tpu.parallel import mesh as jax_mesh  # noqa: E402
from thrifty_tpu.parallel import sharded as jax_sharded  # noqa: E402
from thrifty_tpu.pipeline import identify  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, \
    DetectorConfig  # noqa: E402
from thrifty_tpu_torch.parallel import distributed, mesh, \
    sharded  # noqa: E402

BLOCK, HISTORY = 1024, 160
NEW = BLOCK - HISTORY
TPL = template.generate(5, 0, 2.0)  # 62 samples
CFG = dict(block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110))
EXACT = ("detected", "carrier_detect", "carrier_bin", "corr_sample",
         "template_idx", "block_idx")
TOLS = {"carrier_offset": dict(atol=2e-4), "corr_offset": dict(atol=2e-4),
        "carrier_energy": dict(rtol=1e-4), "carrier_noise": dict(rtol=1e-4),
        "corr_energy": dict(rtol=1e-4), "corr_noise": dict(rtol=1e-4)}


def pair(tpl, **cfg):
    """(JAX detector, the port's on the CPU) of one configuration."""
    return (JaxDetector(tpl, JaxConfig(**cfg)),
            BatchDetector(tpl, DetectorConfig(**cfg), device="cpu"))


def small_capture(num_blocks, seed=0, bursts_every=3, tpl=TPL):
    return sim.synth_capture(
        num_blocks=num_blocks, bursts_every=bursts_every, template=tpl,
        block_len=BLOCK, history_len=HISTORY, carrier_bin=40.25,
        amplitude=0.8, noise_std=0.05, seed=seed, quantize=False)


def new_samples(caps, history):
    """The contiguous new-sample streams [R, L] of host-unfolded captures."""
    return np.stack([c.blocks[:, history:].reshape(-1)
                     for c in caps]).astype(np.complex64)


def run_ranks(det, streams, num_rx, num_time, per_shard):
    """Every rank's ``_local_detect`` on its chunk, the halo handed over
    from the previous time rank's tail (zeros at t = 0); the [R, total]
    table stitched as the gather would."""
    history = det.config.history_len
    rows, length = streams.shape
    rr, ll = rows // num_rx, length // num_time
    table = {}
    for r in range(num_rx):
        halo = torch.zeros((rr, history), dtype=torch.complex64)
        parts = []
        for t in range(num_time):
            chunk = torch.from_numpy(np.ascontiguousarray(
                streams[r * rr:(r + 1) * rr, t * ll:(t + 1) * ll]))
            parts.append(sharded._local_detect(det, chunk, halo, t,
                                               per_shard))
            halo = chunk[:, chunk.shape[1] - history:]
        for k in parts[0]:
            table.setdefault(k, []).append(torch.cat([p[k] for p in parts],
                                                     dim=1))
    return {k: torch.cat(v).numpy() for k, v in table.items()}


def jax_stream(jdet, streams, num_rx, num_time, per_shard, gspmd=False):
    m = jax_mesh.make_mesh(num_rx=num_rx, num_time=num_time)
    if gspmd:
        fn = jax_sharded.make_stream_detector_gspmd(
            jdet, num_time * per_shard, m)
    else:
        fn = jax_sharded.make_stream_detector(jdet, num_rx, per_shard, m)
    return {k: np.asarray(v)
            for k, v in fn(jax_sharded.shard_stream(streams, m)).items()}


def assert_tables_match(got, ref, what=""):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = np.asarray(got[k])
        assert g.dtype == r.dtype and g.shape == r.shape, (what, k)
        if k in EXACT:
            np.testing.assert_array_equal(g, r, err_msg="{} {}".format(
                what, k))
        else:
            np.testing.assert_allclose(g, r, err_msg="{} {}".format(what, k),
                                       **TOLS[k])


def single_device(jdet, blocks):
    return {k: np.asarray(v) for k, v in jdet(blocks).items()}


# -- the mesh -----------------------------------------------------------------

def test_mesh_construction():
    m = mesh.make_mesh(num_rx=2, devices=list(range(8)), device="cpu")
    assert m.shape == {"rx": 2, "time": 4}
    m2 = mesh.make_mesh(num_rx=1, num_time=8, devices=list(range(8)),
                        device="cpu")
    assert m2.shape == {"rx": 1, "time": 8}
    with pytest.raises(ValueError):
        mesh.make_mesh(num_rx=3, devices=list(range(8)), device="cpu")


def test_mesh_grid_and_errors():
    m = mesh.make_mesh(num_rx=2, num_time=3, devices=list(range(8)),
                       device="cpu")
    # rx outer: rank r*T + t sits at (r, t); the mesh takes the first R*T.
    np.testing.assert_array_equal(m.grid, [[0, 1, 2], [3, 4, 5]])
    assert m.coords(4) == (1, 1) and m.coords(6) is None
    assert m.coords() == (0, 0) and m.member and m.size == 6
    assert m.device == torch.device("cpu")
    assert m.time_group is None and m.rx_group is None
    with pytest.raises(ValueError, match="larger than device count"):
        mesh.make_mesh(num_rx=2, num_time=5, devices=list(range(8)),
                       device="cpu")
    # No world: the mesh is this one process.
    assert mesh.make_mesh(device="cpu").shape == {"rx": 1, "time": 1}
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(num_rx=2, device="cpu")
    # A mesh of several ranks cannot run without its world.
    det = BatchDetector(TPL, DetectorConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="world"):
        sharded.shard_stream(np.zeros((2, 8 * NEW), np.complex64), m)
    with pytest.raises(ValueError, match="world"):
        sharded.make_stream_detector(det, 2, 1, m)(
            np.zeros((1, NEW), np.complex64))


def test_stream_detector_validation():
    det = BatchDetector(TPL, DetectorConfig(**CFG), device="cpu")
    one = mesh.make_mesh(device="cpu")
    two = mesh.make_mesh(num_rx=2, devices=list(range(8)), device="cpu")
    with pytest.raises(ValueError, match="num_rx"):
        sharded.make_stream_detector(det, 2, 1, one)
    with pytest.raises(ValueError, match="blocks_per_shard"):
        sharded.make_stream_detector(det, 1, 0, one)
    wide = BatchDetector(TPL, DetectorConfig(
        block_len=256, history_len=200, carrier_window=(4, 60)),
        device="cpu")
    with pytest.raises(ValueError, match="history"):
        sharded.make_stream_detector(wide, 1, 1, one)
    with pytest.raises(ValueError, match="history"):
        sharded.make_stream_detector_gspmd(wide, 4, one)
    with pytest.raises(ValueError, match="total_blocks"):
        sharded.make_stream_detector_gspmd(det, 7, two)
    with pytest.raises(ValueError, match="chunk"):
        sharded.make_stream_detector(det, 1, 2, one)(
            np.zeros((1, NEW), np.complex64))


def test_shard_stream_one_rank():
    streams = (np.arange(12) + 1j).reshape(2, 6)
    got = sharded.shard_stream(streams, mesh.make_mesh(device="cpu"))
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), streams.astype(np.complex64))


# -- the rank program against JAX's programs ----------------------------------

@pytest.fixture(scope="module")
def detectors():
    return pair(TPL, **CFG)


def test_stream_halo_exchange_matches_jax(detectors):
    """tests/test_sharded.py::test_stream_halo_exchange_matches_host_unfold
    and ::test_gspmd_stream_matches_shard_map: the (2, 4) grid equals
    JAX's shard_map and GSPMD programs and the single-device detector."""
    jdet, det = detectors
    num_rx, num_time, s_loc = 2, 4, 4
    total = num_time * s_loc
    caps = [small_capture(total, seed=i) for i in range(num_rx)]
    streams = new_samples(caps, HISTORY)
    got = run_ranks(det, streams, num_rx, num_time, s_loc)
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc), "shard_map")
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc, gspmd=True), "gspmd")
    for r, cap in enumerate(caps):
        ref = single_device(jdet, cap.blocks)
        np.testing.assert_array_equal(got["block_idx"][r], np.arange(total))
        assert_tables_match({k: got[k][r] for k in ref}, ref, "single")


def test_stream_detects_bursts(detectors):
    jdet, det = detectors
    num_rx, num_time, s_loc = 1, 8, 3
    total = num_time * s_loc
    cap = small_capture(total, seed=5)
    streams = new_samples([cap], HISTORY)
    got = run_ranks(det, streams, num_rx, num_time, s_loc)
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc))
    soa = det.soa(got["block_idx"][0], got["corr_sample"][0],
                  got["corr_offset"][0])
    for burst in cap.bursts:
        assert got["detected"][0][burst.block_idx]
        assert abs(soa[burst.block_idx] - burst.expected_soa) < 0.05


def test_stream_gather_replicates(detectors):
    """Two receivers that saw the same stream detect the same blocks."""
    _, det = detectors
    cap = small_capture(16)
    streams = new_samples([cap, cap], HISTORY)
    got = run_ranks(det, streams, 2, 4, 4)
    assert got["detected"].shape == (2, 16)
    np.testing.assert_array_equal(got["detected"][0], got["detected"][1])


def test_full_geometry_halo():
    """tests/test_sharded.py::test_full_geometry_halo: 16384/4920/4914 on
    a (1, 2) grid, the time rank 1's blocks on rank 0's halo."""
    tpl = sim.make_template()
    jdet, det = pair(tpl, carrier_window=(7, 110))
    num_time, per_shard = 2, 4
    total = num_time * per_shard
    cap = sim.synth_capture(num_blocks=total, bursts_every=3, template=tpl,
                            quantize=False, seed=2)
    streams = new_samples([cap], 4920)
    got = run_ranks(det, streams, 1, num_time, per_shard)
    assert_tables_match(got, jax_stream(jdet, streams, 1, num_time,
                                        per_shard))
    ref = single_device(jdet, cap.blocks)
    np.testing.assert_array_equal(got["detected"][0], ref["detected"])
    np.testing.assert_array_equal(got["corr_sample"][0], ref["corr_sample"])
    soa = det.soa(got["block_idx"][0], got["corr_sample"][0],
                  got["corr_offset"][0])
    for burst in cap.bursts:
        i = burst.block_idx
        if i >= 0 and ref["detected"][i]:
            assert abs(soa[i] - burst.expected_soa) < 0.05


def random_geometries():
    """tests/test_sharded.py::test_random_geometry_sharded_equality's
    seeded geometries: (template, block, history, grid, blocks per
    shard, captures)."""
    rng = np.random.default_rng(20260820)
    mesh_shapes = [(2, 4), (1, 8), (4, 2)]
    trials = []
    while len(trials) < 3:
        bits = int(rng.integers(5, 7))
        tpl = template.generate(bits, 0, float(rng.uniform(1.8, 2.4)))
        block = int(2 ** rng.integers(9, 12))
        lo, hi = len(tpl) + 1, block // 2
        if lo >= hi:
            continue
        hist = int(rng.integers(lo, hi))
        num_rx, num_time = mesh_shapes[len(trials)]
        s_loc = int(rng.integers(2, 4))
        try:
            caps = [sim.synth_capture(
                num_blocks=num_time * s_loc, bursts_every=2, template=tpl,
                block_len=block, history_len=hist,
                carrier_bin=float(min(40, block // 30)) + 0.25,
                amplitude=0.8, noise_std=0.05, seed=100 + r,
                quantize=False) for r in range(num_rx)]
        except ValueError:
            continue  # burst placement infeasible at this geometry
        trials.append((tpl, block, hist, num_rx, num_time, s_loc, caps))
    return trials


@pytest.mark.parametrize("trial", range(3))
def test_random_geometry_matches_jax(trial):
    tpl, block, hist, num_rx, num_time, s_loc, caps = \
        random_geometries()[trial]
    jdet, det = pair(tpl, block_len=block, history_len=hist,
                     carrier_window=(3, max(block // 20, 5)))
    streams = new_samples(caps, hist)
    geom = "block={} hist={} mesh={}x{}".format(block, hist, num_rx,
                                                num_time)
    got = run_ranks(det, streams, num_rx, num_time, s_loc)
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc), geom)
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc, gspmd=True), geom + " gspmd")
    for r, cap in enumerate(caps):
        ref = single_device(jdet, cap.blocks)
        np.testing.assert_array_equal(got["detected"][r], ref["detected"],
                                      err_msg=geom)
        np.testing.assert_array_equal(got["corr_sample"][r],
                                      ref["corr_sample"], err_msg=geom)


def test_stream_detector_with_template_bank():
    """tests/test_sharded.py::test_stream_detector_with_template_bank: the
    winning template survives the rx/time sharding."""
    bank = np.stack([template.generate(5, i, 2.0) for i in (0, 1, 2)])
    jdet, det = pair(bank, **CFG)
    num_rx, num_time, s_loc = 1, 8, 3
    cap = small_capture(num_time * s_loc, seed=9, tpl=bank[1])
    streams = new_samples([cap], HISTORY)
    got = run_ranks(det, streams, num_rx, num_time, s_loc)
    assert_tables_match(got, jax_stream(jdet, streams, num_rx, num_time,
                                        s_loc))
    for burst in cap.bursts:
        assert got["detected"][0][burst.block_idx]
        assert got["template_idx"][0][burst.block_idx] == 1


def test_rank_boundary_edge(detectors):
    """tests/test_window_edges.py::test_sharded_stream_agrees_at_edges: a
    peak at the first unique lag of time rank 1's first block, its data
    partly in the halo; after dedup one detection survives there."""
    from thrifty_tpu.dsp import xcorr

    jdet, det = detectors
    num_time, per_shard = 4, 2
    total = num_time * per_shard
    wstart, _ = xcorr.corr_window(BLOCK, HISTORY, len(TPL))
    block_idx = per_shard
    expected_soa = block_idx * NEW + wstart
    stream = sim.synth_stream(
        total * NEW, [{"position": expected_soa - HISTORY,
                       "carrier_bin": 40.0, "amplitude": 0.8,
                       "phase": 0.3}],
        TPL, BLOCK, noise_std=0.02, seed=0)[None, :].astype(np.complex64)
    got = run_ranks(det, stream, 1, num_time, per_shard)
    assert_tables_match(got, jax_stream(jdet, stream, 1, num_time,
                                        per_shard))
    soas = det.soa(got["block_idx"][0], got["corr_sample"][0],
                   got["corr_offset"][0])
    out = {k: v[0] for k, v in got.items() if k != "block_idx"}
    records = toad.from_detector_output(
        np.arange(total, dtype=np.float64), np.arange(total), soas, out,
        rxid=0)
    records["txid"] = 1
    survivors = records[identify.duplicate_mask(records)]
    assert len(survivors) == 1
    assert int(survivors[0]["block"]) == block_idx
    assert float(survivors[0]["soa"]) == pytest.approx(expected_soa,
                                                       abs=0.1)


# -- distributed.initialize ---------------------------------------------------

@pytest.mark.parametrize("msg", [
    "trying to initialize the default process group twice!",
    "default process group is already initialized",
])
def test_repeat_init_swallowed(monkeypatch, msg):
    def boom(**kw):
        raise ValueError(msg)

    monkeypatch.setattr(distributed.dist, "init_process_group", boom)
    distributed.initialize(device="cpu")  # must not raise


def test_genuine_failure_raises(monkeypatch):
    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(distributed.dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        distributed.initialize(device="cpu")


def test_initialize_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    distributed.initialize("127.0.0.1:1234", 2, 1, device="cpu")
    assert seen == {"backend": "gloo", "init_method": "tcp://127.0.0.1:1234",
                    "world_size": 2, "rank": 1}
    seen.clear()
    distributed.initialize(backend="gloo", init_method="file:///x",
                           device="cpu")
    assert seen == {"backend": "gloo", "init_method": "file:///x"}
    with pytest.raises(ValueError, match="not both"):
        distributed.initialize("h:1", init_method="file:///x", device="cpu")


def test_initialize_needs_a_card_by_default(monkeypatch):
    """The default is the card and NCCL; without a card it raises and
    never goes on over gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: pytest.fail("initialised without a "
                                                 "card"))
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.initialize(backend="gloo")


def test_coordinator_and_pod_mesh_without_a_world():
    assert distributed.is_coordinator()
    assert distributed.pod_mesh(device="cpu").shape == {"rx": 1, "time": 1}


# -- a gloo world of one, in process ------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    distributed.initialize(
        init_method="file://" + str(tmp_path / "store"), num_processes=1,
        process_id=0, backend="gloo", device="cpu")
    try:
        yield
    finally:
        distributed.dist.destroy_process_group()


def test_world_of_one(world_of_one, detectors):
    """In a gloo world of one: the 1x1 pod mesh, batch_detect_sharded and
    the stream program (gathered and not) equal the detector."""
    jdet, det = detectors
    assert distributed.is_coordinator()
    m = distributed.pod_mesh(device="cpu")
    assert m.shape == {"rx": 1, "time": 1} and m.time_group is not None
    cap = small_capture(8, seed=4)
    ref = {k: v.numpy() for k, v in det(cap.blocks).items()}
    got = sharded.batch_detect_sharded(det, m)(cap.blocks)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    streams = new_samples([cap], HISTORY)
    chunk = sharded.shard_stream(streams, m)
    for gather in (False, True):
        out = sharded.make_stream_detector(det, 1, 8, m, gather=gather)(
            chunk)
        np.testing.assert_array_equal(out["block_idx"].numpy(),
                                      np.arange(8)[None])
        for k in ref:
            np.testing.assert_array_equal(out[k][0].numpy(), ref[k],
                                          err_msg=k)
    twin = sharded.make_stream_detector_gspmd(det, 8, m)(chunk)
    assert_tables_match({k: v.numpy() for k, v in twin.items()},
                        jax_stream(jdet, streams, 1, 1, 8))
