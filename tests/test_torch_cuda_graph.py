"""The detector's CUDA graph (``BatchDetector.submit_raw`` on a CUDA
device, ungated): the rule that decides whether a batch is graphed and
the output packing on the CPU, a CPU detector that never touches
``torch.cuda``, and, marked ``cuda``, the replayed program against the
eager one at the rx_example configuration (block 16384, history 4920,
carrier window 7-110, batches of 256).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thrifty_tpu_torch import sim  # noqa: E402
from thrifty_tpu_torch.dsp import dirichlet, iq, power_peak, \
    xcorr  # noqa: E402
from thrifty_tpu_torch.dsp import template as template_mod  # noqa: E402
from thrifty_tpu_torch.dsp.detector import BatchDetector, DetectorConfig, \
    gated, graph_step, pack_outputs, unpack_outputs  # noqa: E402

RAW = (256, 32768)
HALF = (128, 32768)
GRAPH = object()  # stands for a captured graph


@pytest.mark.parametrize("device,cap,shape,graphs,step", [
    ("cpu", 0, RAW, {}, "eager"),
    ("cpu", 0, RAW, {RAW: None}, "eager"),
    ("cuda", 8, RAW, {}, "eager"),
    ("cuda", 255, RAW, {RAW: GRAPH}, "eager"),
    ("cuda", 0, RAW, {}, "first"),
    ("cuda", 256, RAW, {}, "first"),
    ("cuda", 0, RAW, {RAW: None}, "capture"),
    ("cuda", 512, RAW, {RAW: None}, "capture"),
    ("cuda", 512, RAW, {RAW: GRAPH}, "replay"),
    ("cuda", 0, RAW, {RAW: GRAPH}, "replay"),
    ("cuda", 0, HALF, {RAW: GRAPH}, "first"),
    ("cuda", 0, HALF, {RAW: GRAPH, HALF: None}, "capture"),
])
def test_graph_step(device, cap, shape, graphs, step):
    """CPU: eager; gated below the batch: eager; ungated on CUDA: the
    first batch of a shape eager, the second captured, then replays."""
    assert graph_step(device, cap, torch.Size(shape), graphs) == step


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


def test_cpu_detector_never_touches_cuda(monkeypatch):
    """A CPU detector runs every batch eagerly, captures nothing and
    makes no ``torch.cuda`` call."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda touched by a CPU detector")

    det = BatchDetector(SMALL_TPL, DetectorConfig(
        block_len=BLOCK, history_len=HISTORY, carrier_window=(7, 110)),
        device="cpu")
    raw = small_raw(3)
    want = [det.detect_raw(raw[k:k + BATCH])
            for k in range(0, len(raw), BATCH)]
    for name in ("CUDAGraph", "Stream", "current_stream", "device",
                 "stream", "synchronize", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for k, ref in zip(range(0, len(raw), BATCH), want):
        got = det.submit_raw(raw[k:k + BATCH]).result()
        for key in ref:
            assert torch.equal(got[key], ref[key]), key
    assert det.graph_captures == det.graph_replays == 0
    assert det._graphs == {}


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


def eager(det, raw):
    """The eager program's outputs of a raw batch (``submit`` never
    replays a graph)."""
    return det.submit(iq.raw_to_iq(raw)).result()


def assert_bit_equal(got, want, what):
    assert list(got) == list(want), what
    for key in want:
        assert got[key].dtype == want[key].dtype, (what, key)
        assert got[key].cpu().numpy().tobytes() \
            == want[key].cpu().numpy().tobytes(), (what, key)


def run_both(device, batches, tmpl=None, **kw):
    """(graphed outputs, eager outputs, graphed detector, the launch
    counters' advance under each, the kernels' runs on the card under
    each) of the same batches on two detectors of one configuration."""
    tmpl = sim.make_template() if tmpl is None else tmpl
    cfg = DetectorConfig(**dict(EXAMPLE, **kw))
    graphed = BatchDetector(tmpl, cfg, device=device)
    ref = BatchDetector(tmpl, cfg, device=device)
    dev_batches = [torch.from_numpy(b).to(device) for b in batches]
    torch.cuda.synchronize()
    before = launches()
    got, graphed_runs = kernel_runs(
        lambda: [graphed.submit_raw(b).result() for b in dev_batches])
    mid = launches()
    want, eager_runs = kernel_runs(
        lambda: [eager(ref, b) for b in dev_batches])
    after = launches()
    return got, want, graphed, (
        [b - a for a, b in zip(before, mid)],
        [b - a for a, b in zip(mid, after)]), (graphed_runs, eager_runs)


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


@pytest.mark.cuda
def test_gated_detector_stays_eager(cuda_device, example_raw):
    """Capacity 8 overflows on this traffic: nothing is captured and the
    outputs are the eager gated program's, the overflow re-run
    included."""
    got, want, det, (graphed_n, eager_n), (graphed_runs, eager_runs) = \
        run_both(cuda_device, example_raw[:3], gate_capacity=8)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_bit_equal(g, w, "gated batch {}".format(k))
    assert det.graph_captures == det.graph_replays == 0 and not det._graphs
    assert det.gate_overflows == 3
    assert graphed_n == eager_n == graphed_runs == eager_runs


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
