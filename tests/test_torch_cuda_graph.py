"""The detector's CUDA graphs (``BatchDetector.submit_raw`` on a CUDA
device, gated or not, and a gated batch's overflow re-run): the rule
that decides whether a batch is graphed, the output packing, the re-run
program against the eager re-run and the graphs' bookkeeping (with a
stand-in graph) on the CPU, a CPU detector that never touches
``torch.cuda``, and, marked ``cuda``, the replayed programs against the
eager ones at the rx_example configuration (block 16384, history 4920,
carrier window 7-110, batches of 256) and rx_fastdet's (integer sync,
parabolic carrier fit).
"""

import contextlib
import ctypes
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.dsp import detector as detector_mod  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet, iq, power_peak, \
    xcorr  # noqa: E402
from thrifty_tpu_torch.dsp import template as template_mod  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig, \
    gated, graph_step, pack_outputs, unpack_outputs  # noqa: E402

RAW = (256, 32768)
HALF = (128, 32768)
GRAPH = object()  # stands for a captured graph


@pytest.mark.parametrize("device,shape,graphs,step", [
    ("cpu", RAW, {}, "eager"),
    ("cpu", RAW, {RAW: None}, "eager"),
    ("cpu", RAW, {RAW: GRAPH}, "eager"),
    ("cuda", RAW, {}, "first"),
    ("cuda", RAW, {RAW: None}, "capture"),
    ("cuda", RAW, {RAW: GRAPH}, "replay"),
    ("cuda", HALF, {RAW: GRAPH}, "first"),
    ("cuda", HALF, {RAW: GRAPH, HALF: None}, "capture"),
    ("cuda", HALF, {RAW: None, HALF: GRAPH}, "replay"),
])
def test_graph_step(device, shape, graphs, step):
    """CPU: eager; CUDA: the first batch of a shape eager, the second
    captured, then replays, whatever the gate (the program's graphs and
    the re-run's follow the same rule, each with its own dict)."""
    assert graph_step(device, torch.Size(shape), graphs) == step


@pytest.mark.parametrize("cap,rows,want", [
    (0, 8, False), (8, 8, False), (9, 8, False), (7, 8, True),
    (1, 256, True)])
def test_gated(cap, rows, want):
    assert gated(cap, rows) is want


def test_pack_round_trip():
    """Every field comes back bit-equal, with its dtype, shape and key
    order, from one buffer in which each offset suits its dtype."""
    g = torch.Generator().manual_seed(5)
    out = {"detected": torch.rand(7, generator=g) > 0.5,
           "carrier_bin": torch.randint(-9, 9, (7,), dtype=torch.int32,
                                        generator=g),
           "carrier_offset": torch.randn(7, generator=g),
           "corr_sample": torch.randint(0, 99, (7, 3), dtype=torch.int64,
                                        generator=g)[:, 1],
           "corr_noise": torch.randn(7, generator=g),
           "per_template": torch.randn(7, 3, generator=g)}
    packed, layout = pack_outputs(out)
    assert packed.dtype == torch.uint8 and packed.dim() == 1
    assert packed.numel() == sum(t.numel() * t.element_size()
                                 for t in out.values())
    copy = packed.clone()
    got = unpack_outputs(copy, layout)
    assert list(got) == list(out)
    for key, t in out.items():
        assert got[key].dtype == t.dtype and got[key].shape == t.shape
        offset = got[key].data_ptr() - copy.data_ptr()
        assert offset % t.element_size() == 0, key
        assert got[key].numpy().tobytes() == t.numpy().tobytes(), key


BLOCK, HISTORY, BATCH = 2048, 256, 8
SMALL_TPL = template_mod.generate(5, 0, 2.0)


def small_raw(batches, seed=3):
    cap = sim.synth_capture(num_blocks=batches * BATCH, bursts_every=3,
                            template=SMALL_TPL, block_len=BLOCK,
                            history_len=HISTORY, seed=seed)
    return iq.iq_to_raw(cap.blocks)


def small_detector(**kw):
    return BatchDetector(SMALL_TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110),
        **kw), device="cpu")


def test_cpu_detector_never_touches_cuda(monkeypatch):
    """A CPU detector, ungated or gated over its capacity, runs every
    batch eagerly (its re-runs reuse the batch's intermediates),
    captures nothing and makes no ``torch.cuda`` call."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda touched by a CPU detector")

    raw = small_raw(3)
    dets = [small_detector(), small_detector(gate_capacity=1)]
    want = [[det.detect_raw(raw[k:k + BATCH])
             for k in range(0, len(raw), BATCH)] for det in dets]
    assert dets[1].gate_overflows == 3
    for name in ("CUDAGraph", "Stream", "current_stream", "device",
                 "stream", "synchronize", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for det, refs in zip(dets, want):
        for k, ref in zip(range(0, len(raw), BATCH), refs):
            got = det.submit_raw(raw[k:k + BATCH]).result()
            for key in ref:
                assert torch.equal(got[key], ref[key]), key
        assert det.graph_captures == det.graph_replays == 0
        assert det.redo_replays == 0
        assert det._graphs == det._redo_graphs == {}
    assert dets[1].gate_overflows == 6


@pytest.mark.parametrize("bad", ["float", "flat", "width"])
def test_submit_raw_refuses_other_input(bad):
    """Only uint8 [B, 2N] is a raw batch, before any step is chosen."""
    det = BatchDetector(SMALL_TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY), device="cpu")
    raw = small_raw(1)
    raw = {"float": raw.astype(np.float32), "flat": raw.reshape(-1),
           "width": raw[:, :-2]}[bad]
    with pytest.raises(ValueError, match="uint8"):
        det.submit_raw(raw)
    assert det._graphs == {}


# The configurations of the graphed gated programs: rx_example's and
# rx_fastdet's numerics, a bank, the windowed carrier stage, the two
# correlation fits with kernels of their own, preshift, stddev terms.
SMALL_BANK = np.stack([template_mod.generate(5, k, 2.0) for k in range(3)])
PROGRAMS = {
    "example": {},
    "fastdet": dict(sync_mode="integer", carrier_interp="parabolic"),
    "bank": dict(bank=True),
    "windowed": dict(fft_impl="matmul"),
    "autocorr": dict(corr_interp="autocorr"),
    "maximise": dict(corr_interp="maximise"),
    "preshift": dict(sync_mode="preshift"),
    "stats": dict(carrier_thresh=(0.0, 15.0, 2.0),
                  corr_thresh=(0.0, 15.0, 2.0)),
}


def program_detector(case, **kw):
    kw = dict(PROGRAMS[case], **kw)
    tmpl = SMALL_BANK if kw.pop("bank", False) else SMALL_TPL
    return BatchDetector(tmpl, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110),
        **kw), device="cpu")


def assert_bit_equal(got, want, what):
    assert list(got) == list(want), what
    for key in want:
        assert got[key].dtype == want[key].dtype, (what, key)
        assert got[key].cpu().numpy().tobytes() \
            == want[key].cpu().numpy().tobytes(), (what, key)


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_redo_program_is_the_eager_redo(case):
    """The re-run of an overflowed gated batch from its raw bytes (the
    carrier stage again, then the full correlation) gives the eager
    re-run's outputs, which reuse the batch's intermediates, bit for
    bit; with the gate's masking, so it is not the ungated program."""
    raw = torch.from_numpy(small_raw(1, seed=7))
    det = program_detector(case, gate_capacity=1)
    pending = det.submit_raw(raw)
    want = pending.result()
    assert pending.overflowed and det.gate_overflows == 1
    got = det._redo_program(raw)
    assert_bit_equal(got, want, case)
    assert det.gate_overflows == 1
    ungated = program_detector(case).detect_raw(raw)
    neg = ~want["carrier_detect"]
    assert neg.any() and not want["detected"][neg].any()
    assert (want["corr_energy"][neg] == 0).all()
    assert (ungated["corr_energy"][neg] != 0).any()


class StandInGraph:
    """A captured graph as the detector sees one, on the CPU: a replay
    copies the batch into the one static input, runs the program there
    and packs and unpacks its outputs as ``_GraphedProgram`` does.  A
    re-run that read the graph's buffers instead of its own batch would
    read the last replay's."""

    def __init__(self, program, raw):
        self.input = torch.empty_like(raw)
        self._program = program

    def replay(self, raw):
        self.input.copy_(raw)
        packed, layout = pack_outputs(self._program(self.input))
        return unpack_outputs(packed.clone(), layout)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """A CPU detector's submit_raw takes the card's path, with
    StandInGraph for the CUDA graph; yields the programs it captured."""
    captured = []

    def capture(self, program, raw):
        captured.append(program.__name__)
        return StandInGraph(program, raw)

    monkeypatch.setattr(detector_mod, "graph_step",
                        lambda device, shape, graphs: graph_step(
                            "cuda", shape, graphs))
    monkeypatch.setattr(BatchDetector, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return captured


@pytest.mark.parametrize("case", ["example", "fastdet", "bank"])
@pytest.mark.parametrize("cap,overflows", [(0, 0), (1, 5), (2, 3),
                                           (BATCH - 1, 0)])
@pytest.mark.parametrize("in_flight", [1, 3])
def test_graphed_batches_are_the_eager_program(stand_in_graphs, case, cap,
                                               overflows, in_flight):
    """Five batches through submit_raw's graph path, ``in_flight`` of
    them queued before the first is resolved: each batch's outputs are a
    second detector's eager outputs bit for bit, without the flag; the
    program's graph is captured on the second batch, and the re-run's
    on the second overflow of a replayed batch (the first batch is
    eager, its re-run too; capacity 2 overflows on three batches, the
    first among them; 0 is ungated); every overflow re-runs once."""
    raw = torch.from_numpy(small_raw(5, seed=11))
    batches = [raw[k:k + BATCH] for k in range(0, len(raw), BATCH)]
    det = program_detector(case, gate_capacity=cap)
    ref = program_detector(case, gate_capacity=cap)
    refs = [ref.submit(iq.raw_to_iq(b)) for b in batches]
    want = [p.result() for p in refs]
    assert ref.gate_overflows == overflows
    replayed = sum(bool(p.overflowed) for p in refs[1:])
    pending, got = [], []
    for b in batches:
        pending.append(det.submit_raw(b))
        if len(pending) == in_flight:
            got.append(pending.pop(0).result())
    got += [p.result() for p in pending]
    for k, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g, w, "batch {}".format(k))
    assert det.graph_captures == 1 and det.graph_replays == len(batches) - 1
    assert det.gate_overflows == overflows
    assert det.redo_replays == max(replayed - 1, 0)
    assert stand_in_graphs == ["_raw_program"] + (
        ["_redo_program"] if replayed > 1 else [])
    assert set(det._redo_graphs) == ({tuple(batches[0].shape)}
                                     if replayed else set())


# -- on the card -------------------------------------------------------------

FULL = 256
EXAMPLE = dict(carrier_window=(7, 110))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def example_raw():
    """Three full batches of rx_example-sized blocks and a last batch of
    100 blocks padded with byte 128, as ``detect_batches`` pads."""
    cap = sim.synth_capture(num_blocks=3 * FULL + 100, bursts_every=4,
                            seed=3, frac_jitter=True)
    raw = iq.iq_to_raw(cap.blocks)
    pad = np.full((FULL - 100, raw.shape[1]), 128, np.uint8)
    raw = np.concatenate([raw, pad])
    return [raw[k:k + FULL] for k in range(0, len(raw), FULL)]


def launches():
    """The launch counters: the calls of the kernels' launchers."""
    return [power_peak.launches, dirichlet.launches,
            xcorr.autocorr_launches, xcorr.maximise_launches]


KERNELS = ("power_peak_kernel", "dirichlet_fit_kernel",
           "autocorr_fit_kernel", "maximise_kernel")


def kernel_runs(fn):
    """(fn's result, the runs on the card of each of KERNELS while fn
    runs, counted by name in a torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, [sum(k in name for name in names) for k in KERNELS]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda's graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(graph):
    """The kernel nodes of each of KERNELS in a captured
    ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``, by the
    kernel's name, read through libcuda's graph API: what one replay runs
    on the card."""
    cuda = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        res = getattr(cuda, fn)(*args)
        assert res == 0, "{}: CUresult {}".format(fn, res)

    def names(handle):
        count = ctypes.c_size_t(0)
        call("cuGraphGetNodes", ctypes.c_void_p(handle), None,
             ctypes.byref(count))
        nodes = (ctypes.c_void_p * count.value)()
        call("cuGraphGetNodes", ctypes.c_void_p(handle), nodes,
             ctypes.byref(count))
        found = []
        for node in map(ctypes.c_void_p, nodes):
            kind = ctypes.c_int()
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            if kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                params = _KernelNodeParams()
                call("cuGraphKernelNodeGetParams_v2", node,
                     ctypes.byref(params))
                name = ctypes.c_char_p()
                if not params.func or cuda.cuFuncGetName(
                        ctypes.byref(name), ctypes.c_void_p(params.func)):
                    call("cuKernelGetName", ctypes.byref(name),
                         ctypes.c_void_p(params.kern))
                found.append(name.value.decode())
            elif kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", node,
                     ctypes.byref(child))
                found += names(child.value)
        return found

    found = names(graph.raw_cuda_graph())
    return [sum(k in name for name in found) for k in KERNELS]


def card_runs(det, called):
    """The runs on the card of each of KERNELS under a graphed detector
    whose launchers were called ``called`` times since it was made: each
    call of an eager run ran once, a capture's calls ran nothing (one a
    kernel node of its graph), and each replay ran its graph's kernel
    nodes.  Counted from the graphs themselves, since a profiler trace
    can lose a kernel's record."""
    runs = list(called)
    for graphs, replays in ((det._graphs, det.graph_replays),
                            (det._redo_graphs, det.redo_replays)):
        captured = [g for g in graphs.values() if g is not None]
        assert len(captured) <= 1, "one graphed shape"
        for g in captured:
            nodes = graph_kernels(g._graph)
            runs = [r + (replays - 1) * n for r, n in zip(runs, nodes)]
    return runs


def eager(det, raw):
    """The eager program's outputs of a raw batch (``submit`` never
    replays a graph)."""
    return det.submit(iq.raw_to_iq(raw)).result()


def run_both(device, batches, tmpl=None, traced=True, **kw):
    """(graphed outputs, eager outputs, graphed detector, the launch
    counters' advance under each, the kernels' runs on the card under
    each) of the same batches on two detectors of one configuration;
    not ``traced``, no trace and no runs (None)."""
    tmpl = sim.make_template() if tmpl is None else tmpl
    cfg = DetectorConfig(**dict(EXAMPLE, **kw))
    graphed = BatchDetector(tmpl, cfg, device=device)
    ref = BatchDetector(tmpl, cfg, device=device)
    dev_batches = [torch.from_numpy(b).to(device) for b in batches]
    count = kernel_runs if traced else (lambda fn: (fn(), None))
    torch.cuda.synchronize()
    before = launches()
    got, graphed_runs = count(
        lambda: [graphed.submit_raw(b).result() for b in dev_batches])
    mid = launches()
    want, eager_runs = count(
        lambda: [eager(ref, b) for b in dev_batches])
    after = launches()
    return got, want, graphed, (
        [b - a for a, b in zip(before, mid)],
        [b - a for a, b in zip(mid, after)]), (graphed_runs, eager_runs)


@pytest.fixture
def kept_graphs(monkeypatch):
    """CUDA graphs captured in the test keep their cudaGraph_t, whose
    kernel nodes :func:`graph_kernels` reads."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", functools.partial(
        torch.cuda.CUDAGraph, keep_graph=True))


@pytest.mark.cuda
def test_replay_is_the_eager_program(cuda_device, example_raw):
    """Four batches, the last one padded: bit-equal to a second
    detector's eager outputs; the first batch eager, the second
    captured, three replays; the card runs the kernels as under eager,
    and the launchers are called for the first batch and the capture
    only."""
    got, want, det, (graphed_n, eager_n), (graphed_runs, eager_runs) = \
        run_both(cuda_device, example_raw)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g, w, "batch {}".format(k))
    assert det.graph_captures == 1
    assert det.graph_replays == len(example_raw) - 1
    # power_peak twice a batch, the Dirichlet fit once
    assert graphed_runs == eager_runs == [2 * len(example_raw),
                                          len(example_raw), 0, 0]
    assert eager_n == eager_runs
    assert graphed_n == [4, 2, 0, 0]
    assert sum(int(w["detected"].sum()) for w in want) > 0


@pytest.mark.cuda
def test_batches_in_flight_keep_their_outputs(cuda_device, example_raw):
    """Three batches queued before any ``result()``: each returns its
    own outputs, not the last replay's."""
    det = BatchDetector(sim.make_template(), DetectorConfig(**EXAMPLE),
                        device=cuda_device)
    ref = BatchDetector(sim.make_template(), DetectorConfig(**EXAMPLE),
                        device=cuda_device)
    dev_batches = [torch.from_numpy(b).to(cuda_device)
                   for b in example_raw]
    det.submit_raw(dev_batches[3]).result()  # eager
    det.submit_raw(dev_batches[3]).result()  # the capture
    pending = [det.submit_raw(b) for b in dev_batches[:3]]
    got = [p.result() for p in pending]
    assert det.graph_replays == 4
    for k, g in enumerate(got):
        assert_bit_equal(g, eager(ref, dev_batches[k]),
                         "in flight {}".format(k))
    assert not torch.equal(got[0]["carrier_energy"],
                           got[1]["carrier_energy"])


# rx_fastdet's numerics; the gated programs' capacities on example_raw,
# whose full batches hold 128 carrier rows and the padded one 50: every
# batch overflows 8, all but the padded one 100, none 160.
FASTDET = dict(sync_mode="integer", carrier_interp="parabolic")
GATES = [8, 100, 160]


@pytest.mark.cuda
@pytest.mark.parametrize("numerics", ["example", "fastdet"])
@pytest.mark.parametrize("cap", GATES)
def test_gated_replay_is_the_eager_program(cuda_device, example_raw,
                                           kept_graphs, numerics, cap):
    """Four gated batches, the last one padded: bit-equal to a second
    detector's eager gated program, re-runs included; the first batch
    eager (its re-run too), the program's graph captured on the second,
    the re-run's on the second overflow of a replayed batch; on the card
    the eager kernels run, and a replayed batch's re-run also the
    carrier stage's again (1 power/peak, and the Dirichlet fit where the
    carrier fit is Dirichlet's); the launchers are called for the eager
    runs and the captures only.  The runs on the card are counted from
    the graphs' kernel nodes (:func:`card_runs`): a profiler trace loses
    a kernel's record now and then."""
    kw = dict(FASTDET if numerics == "fastdet" else {}, gate_capacity=cap)
    got, want, det, (graphed_n, eager_n), _ = \
        run_both(cuda_device, example_raw, traced=False, **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g, w, "gated batch {}".format(k))
    over = [int(w["carrier_detect"].sum()) > cap for w in want]
    assert sum(over) == {8: 4, 100: 3, 160: 0}[cap] and over[0] == (cap < 128)
    replayed = sum(over[1:])           # re-runs from the batch's bytes
    assert det.gate_overflows == sum(over)
    assert det.graph_captures == 1
    assert det.graph_replays == len(example_raw) - 1
    assert det.redo_replays == max(replayed - 1, 0)
    fit = int(numerics == "example")   # Dirichlet's carrier fit
    # eager: 2 power/peak a batch and the carrier fit; +1 a re-run
    assert eager_n == [2 * len(example_raw) + sum(over),
                       fit * len(example_raw), 0, 0]
    # either graph: the carrier stage and a correlation
    for graphs in (det._graphs, det._redo_graphs):
        for graph in filter(None, graphs.values()):
            assert graph_kernels(graph._graph) == [2, fit, 0, 0]
    assert card_runs(det, graphed_n) == [eager_n[0] + replayed,
                                         eager_n[1] + fit * replayed, 0, 0]
    redo_runs = min(replayed, 2)       # the re-run's eager run, capture
    assert graphed_n == [4 + over[0] + 2 * redo_runs,
                         fit * (2 + redo_runs), 0, 0]


@pytest.mark.cuda
def test_gated_batches_in_flight_keep_their_outputs(cuda_device,
                                                    example_raw):
    """Three gated batches that overflow, queued before any
    ``result()``: each re-runs from its own bytes after the later ones
    have replayed, and returns its own outputs."""
    cfg = DetectorConfig(**dict(EXAMPLE, gate_capacity=8))
    det = BatchDetector(sim.make_template(), cfg, device=cuda_device)
    ref = BatchDetector(sim.make_template(), cfg, device=cuda_device)
    dev_batches = [torch.from_numpy(b).to(cuda_device)
                   for b in example_raw]
    # eager; the capture, the eager re-run; a replay, the re-run's capture
    for _ in range(3):
        det.submit_raw(dev_batches[3]).result()
    assert det.graph_captures == 1 and det.redo_replays == 1
    pending = [det.submit_raw(b) for b in dev_batches[:3]]
    got = [p.result() for p in pending]
    assert [p.overflowed for p in pending] == [True] * 3
    assert det.graph_replays == 5 and det.redo_replays == 4
    assert det.gate_overflows == 6
    for k, g in enumerate(got):
        assert_bit_equal(g, eager(ref, dev_batches[k]),
                         "in flight {}".format(k))
    assert not torch.equal(got[0]["corr_energy"], got[1]["corr_energy"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bank", "windowed", "maximise",
                                  "polyfit"])
def test_replay_on_other_programs(cuda_device, example_raw, case):
    """A 3-template bank, the windowed carrier stage (matmul transforms),
    the maximise search and the polyfit carrier fit (whose constant the
    graph reads by address): replays bit-equal to eager, the kernels run
    on the card as under eager."""
    tmpl, kw, batches = None, {}, example_raw[:3]
    if case == "bank":
        tmpl = template_mod.generate_bank(11, [0, 1, 2], 2.4e6 / 0.999707e6)
        cap = sim.synth_capture(num_blocks=2 * FULL, bursts_every=4,
                                template=tmpl[1], seed=1)
        raw = iq.iq_to_raw(cap.blocks)
        batches = [raw[:FULL], raw[FULL:]]
    elif case == "windowed":
        kw = dict(fft_impl="matmul")
    elif case == "maximise":
        kw = dict(corr_interp="maximise")
    else:
        kw = dict(carrier_interp="polyfit")
    got, want, det, (graphed_n, eager_n), (graphed_runs, eager_runs) = \
        run_both(cuda_device, batches, tmpl, **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g, w, "{} batch {}".format(case, k))
    assert det.graph_captures == 1
    assert det.graph_replays == len(batches) - 1
    assert graphed_runs == eager_runs == eager_n
    # power_peak: 1 a batch where the carrier stage is the windowed DFT
    pp_each = 1 if case == "windowed" else 2
    assert graphed_runs[0] == pp_each * len(batches)
    assert graphed_runs[3] == (len(batches) if case == "maximise" else 0)
    # the launchers: the first batch and the capture
    assert graphed_n == [n * 2 // len(batches) for n in eager_n]
    assert (det._carrier_win is not None) == (case == "windowed")
