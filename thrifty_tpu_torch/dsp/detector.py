"""The batched detector on PyTorch (counterpart of thrifty_tpu.dsp.detector).

A whole batch of blocks [B, N] goes through the detect program at once:

  carrier FFT -> fused power/peak reduction (windowed carrier argmax,
  peak power, spectrum energy[, magnitude stats]) -> noise / threshold
  -> sub-bin fit -> carrier removal + despread -> IFFT -> fused
  power/peak reduction (windowed correlation argmax, peak power[,
  magnitude stats]) -> noise / threshold -> sub-sample offset

which is the JAX package's kernel program (``_detect_batch_pallas``,
run there under ``use_pallas='on'``).  On a CUDA device both reductions
are the hand-written kernel of ``csrc/power_peak.cu``; on the CPU they
are its plain PyTorch version.  Every decision is computed as a tensor
and masked, with no data-dependent host control flow, so a batch is
queued on the card without a synchronisation.

Carrier syncs: ``fractional`` (the Python reference: phase ramp +
second FFT, offsets clipped to +-0.6), ``integer`` (fastdet: a roll of
the carrier FFT, parabolic carrier fit and offsets clipped to +-0.5)
and ``preshift`` (the integer roll plus a bank of ``num_preshift``
fractionally pre-shifted template spectra, one picked per block).

A [T, L] template bank correlates every block with every template; the
[B, T, N] correlation goes through the reduction as [B*T, N] rows and
each block keeps the template with the largest peak (``template_idx``).

Interpolators: carrier ``dirichlet`` (12-step Gauss-Newton fit),
``parabolic``, ``polyfit``, ``gaussian``, ``cosine``, ``none``;
correlation ``gaussian``, ``parabolic``, ``cosine``, ``autocorr``
(10-step fit of the template's autocorrelation shape), ``none`` and
``maximise`` (34-step golden-section search over the correlation
spectrum).  Stddev threshold terms come from the reduction's magnitude
sums in the same launch: over all N bins for the carrier, over the
first ``corr_len`` lags for the correlation.

The carrier peak filter (``peak_filter_len``) is the one stage that
does not use the kernel: its argmax runs over FIR-filtered magnitudes,
which a power reduction cannot search, so the carrier search then runs
as torch ops on the detector's device (JAX ``carrier.detect``; the JAX
kernel program refuses this option).  The correlation still goes
through the kernel: one launch per batch.

With ``gate_capacity`` C the correlation runs only on the batch's first
C carrier-positive rows, compacted into a contiguous [C, N] tensor; see
:meth:`BatchDetector._corr_stage_gated` and :class:`PendingBatch` for
the overflow contract.

The transforms are :mod:`mxu_fft`'s under ``fft_impl`` (``torch.fft``,
cuFFT on the card, by default; the matmul family on request) at
``fft_precision``.  With a matmul impl, fractional sync, a carrier window
and no peak filter or carrier stddev term, the carrier stage is a DFT at
the window's bins only (:func:`carrier.detect_windowed`) whose argmax
runs as torch ops over [B, W]; the correlation still launches the
kernel: one launch per batch.  The fractional-sync ramp is the
separable one wherever the four-step runs (``mxu_fft.fft_ramped``).
``use_pallas='off'`` (the plain reductions) is for a CPU detector only:
on a CUDA device the kernel is the only reduction, and the detector
refuses 'off'.

On a CUDA device ``submit_raw`` runs the program as one CUDA graph
(:func:`graph_step`, :class:`_GraphedProgram`): the first batch of each
raw shape runs eagerly, the second is captured, and it and every later
batch of that shape replay the capture, the same kernels in the same
order on the same plans, so the outputs are the eager program's bit for
bit.  A gated program's graph ends with its overflow flag among the
outputs; a replayed batch that overflowed re-runs from its own raw
bytes (:meth:`BatchDetector._redo_program`), as a second graph by the
same rule, advanced by overflows.  ``graph_captures`` and ``graph_replays``
count the program's graph, ``redo_replays`` the re-run's.  The kernels'
launch counters count the calls of their launchers, so they advance on
an eager run and on a capture, and not on a replay.  ``submit``,
``submit_raw_stream`` and a CPU detector run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from thrifty_tpu_torch.device import as_device
from thrifty_tpu_torch.dsp import carrier, dirichlet, mxu_fft, power_peak, \
    shift, unfold, xcorr
from thrifty_tpu_torch.dsp import iq as iq_mod

STATE_KEYS = ("tmpl_fft_conj", "tmpl_energy", "carrier_mask",
              "corr_mask_full")
CARRIER_INTERPS = ("dirichlet", "parabolic", "polyfit", "gaussian",
                   "cosine", "none")
CORR_INTERPS = ("gaussian", "parabolic", "cosine", "autocorr", "none",
                "maximise")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static configuration of the batched detector.

    The fields, defaults and accepted values are those of the JAX
    package's ``DetectorConfig``, less its three sub-knobs of the matmul
    transforms (the full-FFT carrier stage, a carrier-only precision and
    the full ramp): the port always runs their default, the windowed
    carrier DFT where eligible, ``fft_precision`` in every transform and
    the separable ramp.  The transform knobs mean here what the comments
    say.
    """

    block_len: int = 16384
    history_len: int = 4920
    carrier_thresh: tuple = (0.0, 15.0, 0.0)
    carrier_window: Optional[tuple] = None  # (start, stop) signed bins
    corr_thresh: tuple = (0.0, 15.0, 0.0)
    sync_mode: str = "fractional"
    num_preshift: int = 21
    interp_width: int = 6
    gn_iters: int = 12
    corr_interp: str = "gaussian"
    # 'auto' resolves to 'parabolic' in integer sync, 'dirichlet' else.
    carrier_interp: str = "auto"
    # 0 = off, -1 = (block_len // template_len - 1) * 2, else the length.
    peak_filter_len: int = 0
    # The power/peak reductions: 'auto' and 'on' launch the CUDA kernel
    # (csrc/power_peak.cu) on the card -- unlike JAX, whose 'auto' means
    # off, because on the H100 the kernel takes 0.022 ms against the
    # plain reductions' 0.104 ms at [256, 16384] (PERF.md section 6);
    # 'on' also refuses what JAX's kernel program refuses (batch % 8,
    # block_len % 2048, the peak filter, the gate).  'off' names the
    # plain reductions, which a CPU detector runs under every value; a
    # CUDA detector refuses it.
    use_pallas: str = "auto"
    # Transforms (dsp/mxu_fft.py): 'auto'/'xla' = torch.fft (cuFFT on
    # the card), 'matmul' = DFT / four-step as GEMMs, 'matmul3' = the
    # same with Karatsuba's three real products.
    fft_impl: str = "auto"
    # GEMM precision of the matmul impls on the card: 'highest' float32,
    # 'high' TF32 tensor cores, 'default' bf16 operands (CPU: float32).
    fft_precision: str = "highest"
    gate_capacity: int = 0


# The transform knobs' values, worded as the JAX detector's errors.
_CHOICES = (
    ("use_pallas", ("auto", "on", "off"), "'auto', 'on' or 'off'"),
    ("fft_impl", mxu_fft.IMPLS, "'auto', 'matmul', 'matmul3' or 'xla'"),
    ("fft_precision", ("highest", "high", "default"),
     "'highest', 'high' or 'default'"),
)


def _validate(config: DetectorConfig, template: np.ndarray):
    if config.sync_mode not in ("fractional", "integer", "preshift"):
        raise ValueError(
            "unknown sync_mode {!r}: expected 'fractional', 'integer' "
            "or 'preshift'".format(config.sync_mode))
    if config.sync_mode == "preshift" and config.num_preshift < 2:
        # linspace(-0.5, 0.5, 1) would pick a half-bin misaligned
        # template for every block.
        raise ValueError("num_preshift must be >= 2 (got {})".format(
            config.num_preshift))
    if template.ndim not in (1, 2):
        raise ValueError("template must be 1-D or a 2-D [T, L] bank, got "
                         "shape {}".format(template.shape))
    if config.corr_interp not in CORR_INTERPS:
        raise ValueError("unknown corr_interp: " + str(config.corr_interp))
    if config.carrier_interp not in ("auto",) + CARRIER_INTERPS:
        raise ValueError("unknown carrier_interp: "
                         + str(config.carrier_interp))
    for name, allowed, wording in _CHOICES:
        if getattr(config, name) not in allowed:
            raise ValueError("unknown {} {!r}: expected {}".format(
                name, getattr(config, name), wording))
    if config.gate_capacity < 0:
        raise ValueError("gate_capacity must be >= 0 (got {})".format(
            config.gate_capacity))
    if config.gate_capacity and config.use_pallas == "on":
        # The kernel program reduces the whole batch; JAX refuses the
        # pair rather than ignoring one knob.
        raise ValueError("gate_capacity and use_pallas='on' are mutually "
                         "exclusive")
    if config.history_len < template.shape[-1] - 1:
        raise ValueError("history_len must be >= template_len - 1")


def gated(gate_capacity, rows):
    """Does the carrier gate apply to a batch of ``rows`` blocks (a
    capacity that is set and below the batch)?"""
    return bool(gate_capacity) and gate_capacity < rows


def graph_step(device_type, shape, graphs):
    """How a graphed program runs on a raw batch of ``shape`` ([B, 2N]):
    'eager' (op by op, never graphed: a CPU device), 'first' (op by op,
    the shape's first batch), 'capture' (a shape seen before and not yet
    captured: captured as a CUDA graph, then replayed) or 'replay' (the
    shape's graph).  A shape that comes once is never captured.

    ``graphs``: shape -> its graph, or None where the shape has run
    once.  Two programs follow the rule, each with its own ``graphs``:
    ``submit_raw``'s, gated or not, batch by batch, and a gated batch's
    overflow re-run, overflow by overflow.
    """
    if device_type != "cuda":
        return "eager"
    shape = tuple(shape)
    if shape not in graphs:
        return "first"
    return "capture" if graphs[shape] is None else "replay"


# The key of a gated program's overflow flag among its graphed outputs.
OVERFLOW = "gate_overflow"


def pack_outputs(out):
    """(one uint8 tensor holding the bytes of every tensor of the dict
    ``out``, its layout for :func:`unpack_outputs`).  The widest dtype
    goes first, so that each field's offset is a multiple of its
    element size."""
    fields = sorted(out.items(), key=lambda kv: -kv[1].element_size())
    parts = [t.contiguous().reshape(-1).view(torch.uint8)
             for _, t in fields]
    return torch.cat(parts), ([(key, t.dtype, t.shape) for key, t in fields],
                              [part.numel() for part in parts], list(out))


def unpack_outputs(packed, layout):
    """The dict of :func:`pack_outputs`, as views of ``packed``, in the
    packed dict's key order (one split and a view a field: this runs on
    every replay)."""
    fields, sizes, keys = layout
    views = {}
    for (key, dtype, shape), part in zip(fields, packed.split(sizes)):
        view = part.view(dtype)
        views[key] = view if view.shape == shape else view.view(shape)
    return {key: views[key] for key in keys}


def _capture_failed(err):
    return RuntimeError("capturing the detect program as a CUDA graph "
                        "failed: {}".format(err))


class _GraphedProgram:
    """A program ``raw uint8 [B, 2N] -> output dict`` captured as a CUDA
    graph against the static input ``raw``, in the graph's own memory
    pool.

    Build it with a side stream current (a capture cannot run on the
    default stream), after an eager run of the program at this shape
    has made its cuFFT plans, loaded its kernels and uploaded its
    constants.  The capture launches nothing; the kernels' launchers
    are called once, as they record their launches into the graph.
    The graph ends by packing the output fields into one byte buffer
    (:func:`pack_outputs`).  A replay copies the batch into
    the static input, replays and clones the packed buffer, all on the
    current stream: each batch's outputs are views of its own clone, so
    any number of batches may be in flight.
    """

    def __init__(self, program, raw):
        self.input = raw
        graph = torch.cuda.CUDAGraph()
        # thread_local: a CUDA call that another thread (a reader, a
        # profiler) makes meanwhile is not refused for this capture.
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            self._packed, self._layout = pack_outputs(program(self.input))
        except Exception as err:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()  # the capture ``err`` left open
            raise _capture_failed(err) from err
        try:
            graph.capture_end()
        except RuntimeError as err:
            raise _capture_failed(err) from err
        self._graph = graph

    def replay(self, raw):
        """The outputs of ``raw`` (the captured shape), queued."""
        self.input.copy_(raw)
        self._graph.replay()
        return unpack_outputs(self._packed.clone(), self._layout)


class PendingBatch:
    """One batch queued on the detector's device.

    :meth:`result` returns the batch's output dict.  Under the carrier
    gate the batch also holds an on-device overflow flag (more carrier
    detections than the capacity): :meth:`result` reads it, and when it
    is set calls ``redo``, which re-runs the correlation on the whole
    batch, so no block is dropped and the decisions are those of the
    JAX gated detector's full-batch branch.  An eager batch's ``redo``
    reuses its intermediates; a replayed batch (whose graph's buffers
    hold a later batch by then) re-runs from its own raw bytes
    (:meth:`BatchDetector._redo`).  That flag is the one
    host read of a gated batch; a caller that copies the outputs back
    waits for the batch there anyway.  Ungated batches involve no host
    read.
    """

    def __init__(self, out, overflow=None, redo=None):
        self._out = out
        self._overflow = overflow
        self._redo = redo
        # None until resolved (or for an ungated batch), then bool.
        self.overflowed = None

    def program_outputs(self):
        """The output dict as the program left it, with a gated batch's
        on-device overflow flag under ``OVERFLOW``, unread: what a graph
        of the program packs."""
        if self._overflow is None:
            return self._out
        return dict(self._out, **{OVERFLOW: self._overflow})

    def result(self):
        if self._overflow is not None:
            self.overflowed = bool(self._overflow)
            if self.overflowed:
                self._out = self._redo()
            self._overflow = self._redo = None
        return self._out


class BatchDetector:
    """Batched detect: blocks [B, N] complex64 -> per-block detection tensors.

    Output dict fields (all [B], on the detector's device):
      detected       bool  -- carrier AND correlation detection
      carrier_detect bool
      carrier_bin    int32 -- FFT array index of carrier peak
      carrier_offset f32   -- sub-bin offset
      carrier_energy f32   -- carrier peak magnitude
      carrier_noise  f32
      corr_sample    int32 -- correlation peak lag within block
      corr_offset    f32   -- sub-sample offset
      corr_energy    f32   -- correlation peak magnitude
      corr_noise     f32
      template_idx   int32 -- best-matching template of a bank (else 0)

    Under the gate, carrier-negative rows report the corr fields as
    zeros and ``detected`` False (the reference computes nothing for
    them, thrifty/detect.py:64-71).
    """

    def __init__(self, template: np.ndarray, config: DetectorConfig,
                 device="cuda", state=None):
        template = np.asarray(template, dtype=np.float64)
        _validate(config, template)
        if config.use_pallas == "off" and torch.device(device).type \
                == "cuda":
            raise ValueError(
                "use_pallas='off' runs the plain power/peak reductions, "
                "which only a CPU detector runs: on a CUDA device the "
                "kernel is the only reduction ('auto' or 'on')")
        self.config = config
        self.device = as_device(device)
        self.bank = template.ndim == 2
        self.num_templates = template.shape[0] if self.bank else 1
        self.template_len = template.shape[-1]
        n = config.block_len
        self.corr_len = n - self.template_len + 1
        self.window = xcorr.corr_window(n, config.history_len,
                                        self.template_len)
        self.new_len = n - config.history_len
        # Integer sync is fastdet: offsets clip to +-0.5 and the carrier
        # offset defaults to the parabolic fit
        # (fastdet/corr_detector.cpp:88-116,190-194); the other syncs
        # follow the Python reference (clip 0.6, Dirichlet fit).
        fastdet = config.sync_mode == "integer"
        self.corr_clip = 0.5 if fastdet else 0.6
        interp = config.carrier_interp
        if interp == "auto":
            interp = "parabolic" if fastdet else "dirichlet"
        self.carrier_interp_resolved = interp
        self._interp = self._carrier_interpolator(interp, fastdet)
        if interp in ("dirichlet", "polyfit"):
            w = config.interp_width
            offs = torch.arange(-(w // 2), w // 2 + 1)
        else:
            offs = torch.arange(-1, 2)
        self._carrier_offs = offs.to(self.device)
        self._stream = unfold.StreamCarry(config.history_len, self.device)
        # Batches that overflowed the gate and re-ran in full.
        self.gate_overflows = 0
        # submit_raw's CUDA graphs, one per raw shape, None for a shape
        # that has run once (graph_step), and how often one was
        # captured and replayed; the overflow re-run's alike.
        self._graphs = {}
        self.graph_captures = 0
        self.graph_replays = 0
        self._redo_graphs = {}
        self.redo_replays = 0
        self._load_state(self.numpy_state(template, config)
                         if state is None else state)
        self._corr_interp, half = self._correlation_interpolator()
        self._corr_offs = torch.arange(-half, half + 1, device=self.device)

    def _carrier_interpolator(self, interp, fastdet):
        """``interp(values[..., P]) -> offset`` for the resolved carrier
        interpolator (None for 'none')."""
        cfg = self.config
        if interp == "dirichlet":
            return dirichlet.make_dirichlet_interpolator(
                block_len=cfg.block_len, carrier_len=self.template_len,
                width=cfg.interp_width, iters=cfg.gn_iters)
        if interp == "parabolic":
            return functools.partial(dirichlet.parabolic_interpolate,
                                     clip=0.5 if fastdet else None)
        if interp == "polyfit":
            return dirichlet.make_polyfit_interpolator(cfg.interp_width)
        if interp == "gaussian":
            return dirichlet.gaussian_interpolate
        if interp == "cosine":
            return dirichlet.cosine_interpolate
        return None

    def _correlation_interpolator(self):
        """(interp, neighbourhood half-width); ``interp(None, idx,
        values=, length=)``, or the spectrum interpolator of 'maximise'
        (reference bounds +-0.55, xcorr_interpolators.py:108)."""
        name = self.config.corr_interp
        if name == "maximise":
            return xcorr.make_maximise_interpolator(clip=0.55), 1
        if name == "autocorr":
            ac = xcorr.make_autocorr_interpolator(
                self._autocorr[0], self._autocorr[1], clip=self.corr_clip)
            return ac, ac.width
        fn = {"gaussian": xcorr.gaussian_interpolate,
              "parabolic": xcorr.parabolic_interpolate,
              "cosine": xcorr.cosine_interpolate,
              "none": xcorr.none_interpolate}[name]
        return functools.partial(fn, clip=self.corr_clip), 1

    @classmethod
    def from_numpy_state(cls, template, config, state, device="cuda"):
        """A detector whose constants come from ``state``, a dict of
        numpy arrays named as the JAX ``BatchDetector`` attributes that
        hold them, without the leading underscore (``tmpl_fft_conj``,
        ``tmpl_energy``, ``carrier_mask``, ``corr_mask_full``, and per
        option ``preshift_bank``, ``peak_filter``, ``carrier_sel``,
        ``autocorr_table``/``autocorr_dtable``, and ``carrier_win``, the
        windowed carrier stage's (sel, ext, half-width)), moved to
        ``device``.  A ``carrier_win`` in the state selects the windowed
        carrier stage, as it does in the JAX detector it came from."""
        return cls(template, config, device=device, state=state)

    @staticmethod
    def numpy_state(template, config):
        """The detector's constants, computed on the host in numpy, each
        bit-equal to the JAX detector's."""
        n = config.block_len
        template = np.asarray(template, dtype=np.float64)
        tmpl2d = np.atleast_2d(template)
        tlen = template.shape[-1]
        start, stop = xcorr.corr_window(n, config.history_len, tlen)
        corr_mask_full = np.zeros(n, dtype=bool)
        corr_mask_full[start:stop] = True
        state = {
            "tmpl_fft_conj": xcorr.template_fft_conj(template, n),
            "tmpl_energy": xcorr.template_energy(template),
            "carrier_mask": carrier.window_mask(config.carrier_window, n),
            "corr_mask_full": corr_mask_full,
        }
        if config.sync_mode == "preshift":
            # Conj template spectra pre-shifted by fractional bins in
            # [-0.5, 0.5] (reference experimental/detect_preshift.py:
            # 24-45), [S, N] or [S, T, N] for a bank.
            shifts = np.linspace(-0.5, 0.5, config.num_preshift)
            freqs = np.arange(n) / n - 0.5
            padded = np.zeros((tmpl2d.shape[0], n), dtype=np.complex128)
            padded[:, :tlen] = tmpl2d
            rows = np.stack([np.conj(np.fft.fft(
                padded * np.exp(-2j * np.pi * s * freqs))) for s in shifts])
            if template.ndim == 1:
                rows = rows[:, 0]
            state["preshift_bank"] = rows.astype(np.complex64)
        if config.peak_filter_len:
            flen = config.peak_filter_len
            if flen == -1:
                flen = (n // tlen - 1) * 2
            state["peak_filter"] = dirichlet.dirichlet_weights(flen, n, tlen)
            # Explicit window order: a mask cannot encode the start bin
            # of a wrapped full-span window, where the FIR's start-up
            # transient sits.
            w = config.carrier_window or (0, -1)
            state["carrier_sel"] = carrier.fft_window_indices(w[0], w[1], n)
        if config.corr_interp == "autocorr":
            table, dtable = xcorr.autocorr_tables(template)
            state["autocorr_table"] = table
            state["autocorr_dtable"] = dtable
        win = BatchDetector._carrier_window(config, tlen)
        if win is not None:
            state["carrier_win"] = win
        return state

    @staticmethod
    def _carrier_window(config, template_len):
        """JAX's ``_carrier_win``: (sel int32, ext int64, half-width) of
        the windowed carrier stage, or None where it does not apply."""
        interp = config.carrier_interp
        if interp == "auto":
            interp = "parabolic" if config.sync_mode == "integer" \
                else "dirichlet"
        if interp in ("dirichlet", "polyfit"):
            half = config.interp_width // 2
        elif interp == "none":
            half = 0
        else:  # parabolic / gaussian / cosine: 3-point fits
            half = 1
        if config.sync_mode != "fractional" or config.peak_filter_len != 0:
            return None
        win = carrier.windowed_selection(
            config.carrier_window, config.carrier_thresh, config.block_len,
            config.fft_impl, margin=half)
        return None if win is None else (win[0], win[1], half)

    def _load_state(self, state):
        cfg = self.config
        n = cfg.block_len
        need = list(STATE_KEYS)
        if cfg.sync_mode == "preshift":
            need.append("preshift_bank")
        if cfg.peak_filter_len:
            need += ["peak_filter", "carrier_sel"]
        if cfg.corr_interp == "autocorr":
            need += ["autocorr_table", "autocorr_dtable"]
        if self._carrier_window(cfg, self.template_len) is not None:
            need.append("carrier_win")
        missing = set(need) - set(state)
        if missing:
            raise ValueError("state lacks {}".format(sorted(missing)))
        lead = (self.num_templates,) if self.bank else ()

        def complex_tensor(name, shape):
            arr = np.asarray(state[name])
            if arr.dtype != np.complex64 or arr.shape != shape:
                raise ValueError("{} must be complex64 {}, got {} {}".format(
                    name, list(shape), arr.dtype, arr.shape))
            return torch.tensor(arr, device=self.device)

        self._tmpl_fft_conj = complex_tensor("tmpl_fft_conj", lead + (n,))
        self._tmpl_energy = torch.tensor(np.atleast_1d(np.asarray(
            state["tmpl_energy"], dtype=np.float32)), device=self.device)
        if not self.bank:
            self._tmpl_energy = self._tmpl_energy[0]
        self._carrier_mask = power_peak.Mask(state["carrier_mask"],
                                             self.device)
        self._corr_mask_full = power_peak.Mask(state["corr_mask_full"],
                                               self.device)
        for name in ("_carrier_mask", "_corr_mask_full"):
            if len(getattr(self, name)) != n:
                raise ValueError("{} must have length {}".format(
                    name[1:], n))
        # Stats masks of the stddev terms: every FFT bin for the carrier
        # (reference thrifty/carrier_detect.py:100-115), the unique
        # corr_len lags for the correlation.
        self._carrier_stats = self._corr_stats = None
        if cfg.carrier_thresh[2]:
            self._carrier_stats = power_peak.Mask(np.ones(n, bool),
                                                  self.device)
        if cfg.corr_thresh[2]:
            stats = np.zeros(n, dtype=bool)
            stats[:self.corr_len] = True
            self._corr_stats = power_peak.Mask(stats, self.device)
        self._preshift_bank = None
        if cfg.sync_mode == "preshift":
            self._preshift_bank = complex_tensor(
                "preshift_bank", (cfg.num_preshift,) + lead + (n,))
        self._peak_filter = self._carrier_sel = None
        if cfg.peak_filter_len:
            self._peak_filter = np.asarray(state["peak_filter"],
                                           dtype=np.float64)
            self._carrier_sel = torch.tensor(np.asarray(
                state["carrier_sel"], dtype=np.int64), device=self.device)
        self._autocorr = None
        if cfg.corr_interp == "autocorr":
            self._autocorr = tuple(
                torch.tensor(np.asarray(state[k], dtype=np.float32),
                             device=self.device)
                for k in ("autocorr_table", "autocorr_dtable"))
        # The windowed carrier stage runs where the state holds a window
        # (JAX's own ``_carrier_win`` included): the same path as the
        # detector the constants came from.
        self._carrier_win = None
        win = state.get("carrier_win")
        if win is not None:
            sel, ext, half = win
            sel = np.asarray(sel, dtype=np.int64)
            ext = np.asarray(ext, dtype=np.int64)
            half = int(half)
            if sel.ndim != 1 or not len(sel) or len(ext) != len(sel) \
                    + 2 * half or np.any((ext < 0) | (ext >= n)) \
                    or np.any(sel != ext[half:half + len(sel)]):
                raise ValueError("carrier_win must be (sel, ext, half) with "
                                 "ext = sel widened by half bins a side")
            self._carrier_win = (torch.tensor(sel, device=self.device), ext,
                                 half)
            self._carrier_win_offs = torch.arange(
                -half, half + 1, device=self.device)

    # -- the detect program --------------------------------------------------

    def _detect_batch(self, blocks):
        carrier_out, rows = self._carrier_and_rows(blocks)
        cap = self.config.gate_capacity
        if gated(cap, blocks.shape[0]):
            corr_out, overflow = self._corr_stage_gated(rows, carrier_out[0],
                                                        cap)

            def redo():
                self.gate_overflows += 1
                return self._overflow_outputs(carrier_out, rows)

            return PendingBatch(self._finish_outputs(*carrier_out,
                                                     *corr_out),
                                overflow, redo)
        return PendingBatch(self._finish_outputs(
            *carrier_out, *self._corr_stage(*rows)))

    def _carrier_and_rows(self, blocks):
        """Stages 1-2 of a [B, N] batch and what the correlation reads:
        (the carrier outputs (c_det, c_idx, c_off, c_mag, c_noise), the
        rows of :meth:`_corr_stage` (src, c_idx, c_off, signal
        energy))."""
        cfg = self.config
        if cfg.use_pallas == "on":
            self._check_kernel_program(blocks.shape[0])
        if self._carrier_win is not None:
            fft = None  # fractional sync reads the blocks, not the FFT
            carrier_out = self._carrier_stage_windowed(blocks)
        else:
            fft = mxu_fft.fft(blocks, cfg.fft_impl, cfg.fft_precision)
            carrier_out = self._carrier_stage(fft)
        _, c_idx, c_off = carrier_out[:3]

        # Stages 3-5 read the time-domain blocks (fractional: ramp +
        # second FFT) or roll the carrier FFT (integer, preshift).
        src = blocks if cfg.sync_mode == "fractional" else fft
        return carrier_out, (src, c_idx, c_off, self._signal_energy(blocks))

    def corr_rows(self, rows, overflowed=False):
        """The rows the correlation runs on in a batch of ``rows``
        blocks: all of them ungated; under the gate its capacity, and
        the whole batch again after an overflow."""
        cap = self.config.gate_capacity
        if not gated(cap, rows):
            return rows
        return cap + rows if overflowed else cap

    def _check_kernel_program(self, batch):
        """What JAX's kernel program (``use_pallas='on'``) refuses, worded
        as its error (thrifty_tpu/dsp/detector.py:414-436)."""
        cfg = self.config
        if cfg.block_len % 2048 or batch % 8 or cfg.peak_filter_len:
            raise ValueError(
                "use_pallas='on' requires: batch divisible by 8 "
                "(got {}), block_len divisible by 2048, and no "
                "carrier peak filter".format(batch))

    def _carrier_stage_windowed(self, blocks):
        """Stages 1-2 from the DFT at the carrier window's bins plus the
        interpolator's margin (:func:`carrier.detect_windowed`): argmax,
        noise and threshold over [B, W] as torch ops, the sub-bin fit on
        the extended window's magnitudes.  Returns (c_det, c_idx, c_off,
        c_mag, c_noise)."""
        cfg = self.config
        sel, ext, half = self._carrier_win
        c_det, c_idx, c_mag, c_noise, _, mag_w, rel = \
            carrier.detect_windowed(blocks, sel, ext, half,
                                    cfg.carrier_thresh, cfg.fft_impl,
                                    cfg.fft_precision)
        if self._interp is None:
            c_off = torch.zeros(c_idx.shape, dtype=torch.float32,
                                device=blocks.device)
        else:
            nidx = (rel.to(torch.int64) + half)[..., None] \
                + self._carrier_win_offs
            neigh = torch.gather(mag_w, -1, nidx)
            c_off = torch.where(c_det, self._interp(neigh), 0.0)
        return c_det, c_idx, c_off, c_mag, c_noise

    def _carrier_stage(self, fft):
        """Stages 1-2: carrier peak, energy (and magnitude stats) in one
        reduction, noise / threshold, sub-bin fit on the gathered
        neighbourhood (carrier bins wrap circularly).  With the peak
        filter, the search is :func:`carrier.detect_peak_filtered`.
        Returns (c_det, c_idx, c_off, c_mag, c_noise)."""
        cfg = self.config
        n = cfg.block_len
        c_std = cfg.carrier_thresh[2]
        if self._peak_filter is not None:
            c_det, c_idx, c_mag, c_noise = carrier.detect_peak_filtered(
                torch.abs(fft), self._peak_filter, self._carrier_sel,
                cfg.carrier_thresh)
        else:
            out = power_peak.fused_power_peak(
                fft, self._carrier_mask, stats_mask=self._carrier_stats)
            c_idx, c_peak_pow, c_energy = out[:3]
            c_mag = torch.sqrt(c_peak_pow)
            c_noise, c_thresh_sq = carrier.noise_and_threshold_sq(
                c_energy, c_peak_pow, n, cfg.carrier_thresh)
            if c_std:
                c_thresh_sq = c_thresh_sq + c_std * xcorr.var_from_stats(
                    out[3], out[4], n)
            c_det = c_mag > torch.sqrt(torch.clamp(c_thresh_sq, min=0.0))
        if self._interp is None:
            c_off = torch.zeros(c_idx.shape, dtype=torch.float32,
                                device=fft.device)
        else:
            neigh = torch.abs(dirichlet.gather_neighborhood(
                fft, c_idx, self._carrier_offs))
            c_off = torch.where(c_det, self._interp(neigh), 0.0)
        return c_det, c_idx, c_off, c_mag, c_noise

    def _corr_stage(self, src, c_idx, c_off, signal_energy):
        """Stages 3-5 on [R, N] rows: carrier removal + despread, the
        correlation peak through the power/peak reduction on the
        full-length circular correlation (non-unique lags masked; a
        bank's [R, T, N] correlation as [R*T, N] rows), sub-sample
        offset, noise / threshold.

        Strictly row-wise, so the gated path may run it on any
        compacted subset of the batch.  Returns (p_idx, p_mag, p_det,
        p_off, noise), each [R] or [R, T].
        """
        cfg = self.config
        n = cfg.block_len
        u_const, u_snr, u_std = cfg.corr_thresh
        corr_full, spec = self._remove_carrier_and_despread(src, c_idx,
                                                            c_off)
        out = power_peak.fused_power_peak(corr_full.reshape(-1, n),
                                          self._corr_mask_full,
                                          stats_mask=self._corr_stats)
        lead = corr_full.shape[:-1]
        p_idx = out[0].reshape(lead)
        p_mag = torch.sqrt(out[1]).reshape(lead)
        if cfg.corr_interp == "maximise":
            p_off = self._corr_interp(spec, p_idx)
        elif cfg.corr_interp == "none":
            p_off = xcorr.none_interpolate(None, p_idx)
        else:
            neigh = torch.abs(dirichlet.gather_neighborhood(
                corr_full, p_idx, self._corr_offs))
            p_off = self._corr_interp(None, p_idx, values=neigh,
                                      length=self.corr_len)
        noise = self._corr_noise(signal_energy, p_mag, n)
        u_thresh_sq = u_const + u_snr * torch.square(noise)
        if u_std:
            u_thresh_sq = u_thresh_sq + u_std * xcorr.var_from_stats(
                out[3], out[4], self.corr_len).reshape(lead)
        p_det = p_mag > torch.sqrt(u_thresh_sq)
        return p_idx, p_mag, p_det, p_off, noise

    def _corr_stage_gated(self, rows, c_det, cap):
        """Correlation on the batch's first ``cap`` carrier-positive rows.

        A stable sort of the carrier flag (integer keys, carriers first,
        index order kept) picks ``cap`` distinct row indices; those rows
        are gathered into contiguous [cap, N] tensors, run
        :meth:`_corr_stage` (power/peak kernel included, on [cap*T, N]
        rows for a bank) and are scattered back.  Capacity FILLER rows
        (carrier-negative rows gathered because the batch has fewer
        than ``cap`` carriers) are masked to the zero defaults, like
        every other carrier-negative row, so a noise block's outputs
        never depend on its batch.

        Returns (corr outputs [B] or [B, T], overflow): ``overflow`` is
        an on-device bool, set when the batch holds more than ``cap``
        carrier detections; the gathered rows then miss some carriers
        and :class:`PendingBatch` re-runs the full batch
        (:meth:`_corr_stage_masked`).  The JAX package takes that
        branch inside its program with ``lax.cond``.
        """
        batch = c_det.shape[0]
        key = torch.logical_not(c_det).to(torch.int32)
        sel = torch.sort(key, stable=True).indices[:cap]
        outs = self._corr_stage(*(a.index_select(0, sel) for a in rows))
        keep = c_det.index_select(0, sel)
        if self.bank:
            keep = keep[:, None]
        # index_copy_: the rows of sel are distinct, and it checks its
        # indices on the device (no host sync inside a graph's capture).
        scattered = tuple(
            torch.zeros((batch,) + o.shape[1:], dtype=o.dtype,
                        device=o.device).index_copy_(
                0, sel, torch.where(keep, o, torch.zeros_like(o)))
            for o in outs)
        overflow = torch.count_nonzero(c_det) > cap
        return scattered, overflow

    def _corr_stage_masked(self, rows, c_det):
        """The full-batch correlation of an overflowed gated batch, with
        the gate's carrier-negative masking (zeros / not detected)."""
        keep = c_det[:, None] if self.bank else c_det
        return tuple(torch.where(keep, o, torch.zeros_like(o))
                     for o in self._corr_stage(*rows))

    def _remove_carrier_and_despread(self, src, c_idx, c_off):
        """Carrier-compensated full-length circular correlation [R, N]
        ([R, T, N] for a bank) and its spectrum.

        ``src``: the time-domain blocks (fractional sync) or their FFT
        (integer and preshift sync).
        """
        cfg = self.config
        n = cfg.block_len
        if cfg.sync_mode == "integer":
            shifted = shift.integer_roll_fft(src, -c_idx)
            spec = xcorr.despread_spec(shifted, self._tmpl_fft_conj)
        else:
            # Wrap the peak's FFT index to its SIGNED bin: ramps for s
            # and s+N are the same for even N, but a |shift| ~ N ramp
            # accumulates ~pi*N radians of f32 phase and loses ~3 digits
            # of carrier alignment for negative-frequency carriers (and
            # preshift's f32 fraction only ~2e-3 granularity).
            signed = torch.remainder(c_idx + n // 2, n) - n // 2
            shift_total = -(signed.to(torch.float32) + c_off)
            if cfg.sync_mode == "fractional":
                spec = xcorr.despread_spec(
                    shift.fractional_shift_fft(
                        src, shift_total, cfg.fft_impl, cfg.fft_precision),
                    self._tmpl_fft_conj)
            else:
                # preshift: integer roll + the template spectrum
                # pre-shifted by the nearest fraction (no second FFT).
                int_shift = torch.round(shift_total).to(torch.int32)
                frac = torch.clamp(shift_total - int_shift, -0.5, 0.5)
                shifted = shift.integer_roll_fft(src, int_shift)
                sel = torch.round((frac + 0.5) * (cfg.num_preshift - 1))
                tconj = self._preshift_bank.index_select(
                    0, sel.to(torch.int64))  # [R, (T,) N]
                if self.bank:
                    shifted = shifted[:, None, :]
                spec = shifted * tconj
        # Full length, as JAX's kernel program asks: the reduction masks
        # the non-unique lags itself.
        return mxu_fft.ifft_head(spec, n, cfg.fft_impl,
                                 cfg.fft_precision), spec

    @staticmethod
    def _signal_energy(blocks):
        """Time-domain block energy sum(|x|^2) for the corr noise."""
        return torch.sum(torch.square(blocks.real)
                         + torch.square(blocks.imag), dim=-1)

    def _corr_noise(self, signal_energy, p_mag, n):
        if self.bank:
            signal_energy = signal_energy[:, None]
        return xcorr.noise_rms(p_mag, signal_energy, self._tmpl_energy, n)

    def _finish_outputs(self, c_det, c_idx, c_off, c_mag, c_noise,
                        p_idx, p_mag, p_det, p_off, noise):
        """Mask the offset on non-detections, reduce a bank to the
        template with the largest peak per block, assemble the output."""
        p_off = torch.where(p_det, p_off, 0.0)
        if self.bank:
            best = torch.argmax(p_mag, dim=-1)

            def take(a):
                return torch.gather(a, -1, best[:, None])[:, 0]

            p_idx, p_mag, noise = take(p_idx), take(p_mag), take(noise)
            p_det, p_off = take(p_det), take(p_off)
            template_idx = best.to(torch.int32)
        else:
            template_idx = torch.zeros_like(c_idx)
        return {
            "detected": c_det & p_det,
            "carrier_detect": c_det,
            "carrier_bin": c_idx,
            "carrier_offset": c_off,
            "carrier_energy": c_mag,
            "carrier_noise": c_noise,
            "corr_sample": p_idx,
            "corr_offset": p_off,
            "corr_energy": p_mag,
            "corr_noise": noise,
            "template_idx": template_idx,
        }

    def _stream_program(self, new_u8, carry):
        rows, carry = unfold.unfold_stream(
            new_u8, carry, self.config.block_len, self.config.history_len)
        return self._detect_batch(iq_mod.raw_to_iq(rows)), carry

    # -- host API ------------------------------------------------------------
    #
    # submit* queue a batch and return its PendingBatch; the other three
    # return the resolved output dict.

    def submit(self, blocks):
        """Queue a [B, N] complex64 batch (tensor or numpy array)."""
        blocks = torch.as_tensor(blocks).to(self.device)
        if blocks.dtype != torch.complex64 or blocks.dim() != 2 \
                or blocks.shape[1] != self.config.block_len:
            raise ValueError("blocks must be complex64 [B, {}]".format(
                self.config.block_len))
        return self._detect_batch(blocks.contiguous())

    def submit_raw(self, raw):
        """Queue raw uint8 interleaved I/Q [B, 2N] (tensor or numpy);
        the conversion to complex64 runs on the detector's device.  On a
        CUDA device the program runs as the CUDA graph of its shape
        (:func:`graph_step`), and a gated batch keeps ``raw`` for its
        overflow re-run: a device tensor passed in must not be written
        before the batch's ``result()``."""
        raw = torch.as_tensor(raw).to(self.device)
        if raw.dtype != torch.uint8 or raw.dim() != 2 \
                or raw.shape[1] != 2 * self.config.block_len:
            raise ValueError("raw must be uint8 [B, {}]".format(
                2 * self.config.block_len))
        key = tuple(raw.shape)
        step = graph_step(self.device.type, key, self._graphs)
        if step in ("eager", "first"):
            if step == "first":
                self._graphs[key] = None
            return self._detect_batch(iq_mod.raw_to_iq(raw))
        out = self._replay(self._graphs, self._raw_program, raw)
        self.graph_captures += step == "capture"
        self.graph_replays += 1
        overflow = out.pop(OVERFLOW, None)
        if overflow is None:
            return PendingBatch(out)
        return PendingBatch(out, overflow, functools.partial(self._redo, raw))

    def _raw_program(self, raw):
        """The program a graph of ``submit_raw`` captures: the output
        dict, with a gated batch's on-device overflow flag under
        OVERFLOW (read by its :class:`PendingBatch`, never here)."""
        return self._detect_batch(iq_mod.raw_to_iq(raw)).program_outputs()

    def _redo_program(self, raw):
        """The overflow re-run of a gated batch from its raw bytes: the
        carrier stage again (the same kernels on the same input, so the
        eager re-run's values bit for bit) and the full-batch
        correlation (:meth:`_corr_stage_masked`)."""
        return self._overflow_outputs(
            *self._carrier_and_rows(iq_mod.raw_to_iq(raw)))

    def _overflow_outputs(self, carrier_out, rows):
        """An overflowed gated batch's outputs from its carrier outputs
        and correlation rows (:meth:`_carrier_and_rows`): the full-batch
        correlation with the gate's masking."""
        return self._finish_outputs(*carrier_out, *self._corr_stage_masked(
            rows, carrier_out[0]))

    def _redo(self, raw):
        """The re-run of a replayed gated batch that overflowed:
        :meth:`_redo_program` on the batch's own ``raw``, as
        :func:`graph_step` says for the re-run's graphs (a shape's first
        overflow eager, the second captured, replays after)."""
        self.gate_overflows += 1
        key = tuple(raw.shape)
        if graph_step(self.device.type, key, self._redo_graphs) == "first":
            self._redo_graphs[key] = None
            return self._redo_program(raw)
        self.redo_replays += 1
        return self._replay(self._redo_graphs, self._redo_program, raw)

    def _replay(self, graphs, program, raw):
        """``program(raw)``'s outputs, replayed from the graph of
        ``raw``'s shape in ``graphs``, captured first where ``graphs``
        holds None for the shape."""
        key = tuple(raw.shape)
        with torch.cuda.device(self.device):
            if graphs[key] is None:
                graphs[key] = self._capture(program, raw)
            return graphs[key].replay(raw)

    def _capture(self, program, raw):
        """The graph of ``program`` at ``raw``'s shape, captured on a
        side stream (a capture cannot run on the default stream).  The
        shape's first run was eager on the current stream and made its
        cuFFT plans, loaded its kernels and uploaded its constants."""
        static = torch.empty_like(raw)  # written on the current stream
        with torch.cuda.stream(torch.cuda.Stream()):
            return _GraphedProgram(program, static)

    def submit_raw_stream(self, new_raw):
        """Queue CONTIGUOUS raw uint8 I/Q stream bytes [B*2*new_len]:
        the stream's new bytes for B blocks with no repeated history.
        The overlap-save unfold runs on the detector's device against a
        carry of the previous call's tail kept there (pre-stream
        history: 0x80 zero-signal bytes); call :meth:`reset_stream`
        before reusing the detector on another stream."""
        return self._stream.call(self._stream_program, new_raw,
                                 new_len=self.new_len)

    def __call__(self, blocks):
        """Detect on a [B, N] complex64 batch (tensor or numpy array)."""
        return self.submit(blocks).result()

    def detect_raw(self, raw):
        """Detect on raw uint8 interleaved I/Q [B, 2N]."""
        return self.submit_raw(raw).result()

    def detect_raw_stream(self, new_raw):
        """Detect on contiguous raw stream bytes (see
        :meth:`submit_raw_stream`)."""
        return self.submit_raw_stream(new_raw).result()

    def reset_stream(self):
        """Reset the stream carry to the zero-signal pre-stream state."""
        self._stream.reset()

    def soa(self, block_idx, corr_sample, corr_offset):
        """Absolute sample-of-arrival since receiver start (host, float64).

        soa = (block_len - history_len)*block_idx + peak + offset
        (reference thrifty/detect.py:67-69).  Float64 on the host:
        block_idx can be large enough that float32 would lose
        sub-sample precision.
        """
        return (
            np.asarray(block_idx, dtype=np.float64) * self.new_len
            + np.asarray(corr_sample, dtype=np.float64)
            + np.asarray(corr_offset, dtype=np.float64)
        )
