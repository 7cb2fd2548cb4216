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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from thrifty_tpu_torch.device import as_device
from thrifty_tpu_torch.dsp import carrier, dirichlet, power_peak, shift, \
    unfold, xcorr
from thrifty_tpu_torch.dsp import fft as fft_mod
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

    The fields and defaults are those of the JAX package's
    ``DetectorConfig``; its TPU-only knobs (``use_pallas``, ``fft_impl``,
    ``fft_precision``, ``carrier_fast``, ``carrier_precision``,
    ``ramp_fast``) have no counterpart here.
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
    gate_capacity: int = 0


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
    if config.gate_capacity < 0:
        raise ValueError("gate_capacity must be >= 0 (got {})".format(
            config.gate_capacity))
    if config.history_len < template.shape[-1] - 1:
        raise ValueError("history_len must be >= template_len - 1")


class PendingBatch:
    """One batch queued on the detector's device.

    :meth:`result` returns the batch's output dict.  Under the carrier
    gate the batch also holds an on-device overflow flag (more carrier
    detections than the capacity): :meth:`result` reads it, and when it
    is set re-runs the correlation on the whole batch before returning,
    so no block is dropped and the decisions are those of the JAX gated
    detector's full-batch branch.  That flag is the one host read of a
    gated batch; a caller that copies the outputs back waits for the
    batch there anyway.  Ungated batches involve no host read.
    """

    def __init__(self, out, overflow=None, redo=None):
        self._out = out
        self._overflow = overflow
        self._redo = redo
        # None until resolved (or for an ungated batch), then bool.
        self.overflowed = None

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
        ``autocorr_table``/``autocorr_dtable``), moved to ``device``."""
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
        return state

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

    # -- the detect program --------------------------------------------------

    def _detect_batch(self, blocks):
        cfg = self.config
        fft = fft_mod.fft(blocks)
        carrier_out = self._carrier_stage(fft)
        c_det, c_idx, c_off = carrier_out[:3]

        # Stages 3-5 read the time-domain blocks (fractional: ramp +
        # second FFT) or roll the carrier FFT (integer, preshift).
        src = blocks if cfg.sync_mode == "fractional" else fft
        rows = (src, c_idx, c_off, self._signal_energy(blocks))
        cap = cfg.gate_capacity
        if cap and cap < blocks.shape[0]:
            corr_out, overflow = self._corr_stage_gated(rows, c_det, cap)

            def redo():
                self.gate_overflows += 1
                return self._finish_outputs(
                    *carrier_out, *self._corr_stage_masked(rows, c_det))

            return PendingBatch(self._finish_outputs(*carrier_out,
                                                     *corr_out),
                                overflow, redo)
        return PendingBatch(self._finish_outputs(
            *carrier_out, *self._corr_stage(*rows)))

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
        out = power_peak.fused_power_peak(
            corr_full.reshape(-1, n), self._corr_mask_full,
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
        scattered = []
        for o in outs:
            full = torch.zeros((batch,) + o.shape[1:], dtype=o.dtype,
                               device=o.device)
            full[sel] = torch.where(keep, o, torch.zeros_like(o))
            scattered.append(full)
        overflow = torch.count_nonzero(c_det) > cap
        return tuple(scattered), overflow

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
                    shift.fractional_shift_fft(src, shift_total),
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
        return fft_mod.ifft(spec), spec

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
        the conversion to complex64 runs on the detector's device."""
        raw = torch.as_tensor(raw).to(self.device)
        if raw.dim() != 2 or raw.shape[1] != 2 * self.config.block_len:
            raise ValueError("raw must be uint8 [B, {}]".format(
                2 * self.config.block_len))
        return self._detect_batch(iq_mod.raw_to_iq(raw))

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
