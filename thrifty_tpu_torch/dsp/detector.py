"""The batched detector on PyTorch (counterpart of thrifty_tpu.dsp.detector).

A whole batch of blocks [B, N] goes through the detect program at once:

  carrier FFT -> fused power/peak reduction (windowed carrier argmax,
  peak power, spectrum energy) -> noise / threshold -> sub-bin fit ->
  carrier removal + despread -> IFFT -> fused power/peak reduction
  (windowed correlation argmax, peak power) -> noise / threshold ->
  Gaussian sub-sample offset

which is the JAX package's kernel program (``_detect_batch_pallas``,
run there under ``use_pallas='on'``).  On a CUDA device both reductions
are the hand-written kernel of ``csrc/power_peak.cu``; on the CPU they
are its plain PyTorch version.  Every decision is computed as a tensor
and masked, with no data-dependent host control flow, so a batch is
queued on the card without a synchronisation.

Two carrier syncs: ``fractional`` (the Python reference: Dirichlet fit,
phase ramp + second FFT, offsets clipped to +-0.6) and ``integer``
(fastdet: parabolic fit clipped to +-0.5, a roll of the carrier FFT
already computed, offsets clipped to +-0.5).

With ``gate_capacity`` C the correlation runs only on the batch's first
C carrier-positive rows, compacted into a contiguous [C, N] tensor; see
:meth:`BatchDetector._corr_stage_gated` and :class:`PendingBatch` for
the overflow contract.

Not ported: preshift sync, template banks, the carrier peak filter,
stddev threshold terms and the other interpolators; each raises
``ValueError`` naming the option.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from thrifty_tpu_torch.dsp import carrier, dirichlet, power_peak, shift, \
    unfold, xcorr
from thrifty_tpu_torch.dsp import fft as fft_mod
from thrifty_tpu_torch.dsp import iq as iq_mod

STATE_KEYS = ("tmpl_fft_conj", "tmpl_energy", "carrier_mask",
              "corr_mask_full")
CARRIER_INTERPS = ("dirichlet", "parabolic")


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
    interp_width: int = 6
    gn_iters: int = 12
    corr_interp: str = "gaussian"
    # 'auto' resolves to 'parabolic' in integer sync, 'dirichlet' else.
    carrier_interp: str = "auto"
    peak_filter_len: int = 0
    gate_capacity: int = 0


def _not_ported(option, value, supported):
    return ValueError(
        "{}={!r} is not implemented by thrifty_tpu_torch yet (supported: "
        "{}); use thrifty_tpu for it".format(option, value, supported))


def _validate(config: DetectorConfig, template: np.ndarray):
    if config.sync_mode not in ("fractional", "integer", "preshift"):
        raise ValueError(
            "unknown sync_mode {!r}: expected 'fractional', 'integer' "
            "or 'preshift'".format(config.sync_mode))
    if config.sync_mode == "preshift":
        raise _not_ported("sync_mode", config.sync_mode,
                          "'fractional', 'integer'")
    if template.ndim != 1:
        raise _not_ported("template", "bank of shape {}".format(
            template.shape), "one 1-D template")
    if config.corr_interp != "gaussian":
        raise _not_ported("corr_interp", config.corr_interp, "'gaussian'")
    if config.carrier_interp not in ("auto",) + CARRIER_INTERPS:
        raise _not_ported("carrier_interp", config.carrier_interp,
                          "'auto', 'dirichlet', 'parabolic'")
    if config.peak_filter_len:
        raise _not_ported("peak_filter_len", config.peak_filter_len, "0")
    if config.gate_capacity < 0:
        raise ValueError("gate_capacity must be >= 0 (got {})".format(
            config.gate_capacity))
    for name in ("carrier_thresh", "corr_thresh"):
        if getattr(config, name)[2]:
            raise _not_ported(name, getattr(config, name),
                              "stddev term d == 0")
    if config.history_len < len(template) - 1:
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
      carrier_offset f32   -- sub-bin offset (Dirichlet / parabolic fit)
      carrier_energy f32   -- carrier peak magnitude
      carrier_noise  f32
      corr_sample    int32 -- correlation peak lag within block
      corr_offset    f32   -- sub-sample offset (Gaussian interp)
      corr_energy    f32   -- correlation peak magnitude
      corr_noise     f32
      template_idx   int32 -- always 0 (one template)

    Under the gate, carrier-negative rows report the corr fields as
    zeros and ``detected`` False (the reference computes nothing for
    them, thrifty/detect.py:64-71).
    """

    def __init__(self, template: np.ndarray, config: DetectorConfig,
                 device="cpu"):
        template = np.asarray(template, dtype=np.float64)
        _validate(config, template)
        self.config = config
        self.device = torch.device(device)
        self.template_len = len(template)
        n = config.block_len
        self.corr_len = n - self.template_len + 1
        self.window = xcorr.corr_window(n, config.history_len,
                                        self.template_len)
        self.new_len = n - config.history_len
        # Integer sync is fastdet: offsets clip to +-0.5 and the carrier
        # offset defaults to the parabolic fit
        # (fastdet/corr_detector.cpp:88-116,190-194); fractional sync
        # follows the Python reference (clip 0.6, Dirichlet fit).
        fastdet = config.sync_mode == "integer"
        self.corr_clip = 0.5 if fastdet else 0.6
        interp = config.carrier_interp
        if interp == "auto":
            interp = "parabolic" if fastdet else "dirichlet"
        self.carrier_interp_resolved = interp
        if interp == "dirichlet":
            self._interp = dirichlet.make_dirichlet_interpolator(
                block_len=n, carrier_len=self.template_len,
                width=config.interp_width, iters=config.gn_iters)
            w = config.interp_width
            offs = torch.arange(-(w // 2), w // 2 + 1)
        else:
            clip = 0.5 if fastdet else None
            self._interp = lambda values: dirichlet.parabolic_interpolate(
                values, clip=clip)
            offs = torch.arange(-1, 2)
        self._carrier_offs = offs.to(self.device)
        self._corr_offs = torch.arange(-1, 2, device=self.device)
        self._stream = unfold.StreamCarry(config.history_len, self.device)
        # Batches that overflowed the gate and re-ran in full.
        self.gate_overflows = 0
        self._load_state(self.numpy_state(template, config))

    @classmethod
    def from_numpy_state(cls, template, config, state, device="cpu"):
        """A detector whose trace-time constants come from ``state``, a
        dict of numpy arrays ``tmpl_fft_conj``, ``tmpl_energy``,
        ``carrier_mask`` and ``corr_mask_full`` (what the JAX
        ``BatchDetector`` holds as ``_tmpl_fft_conj`` etc.), moved to
        ``device``."""
        det = cls(template, config, device=device)
        det._load_state(state)
        return det

    @staticmethod
    def numpy_state(template, config):
        """The detector's constants, computed on the host in numpy."""
        n = config.block_len
        template = np.asarray(template, dtype=np.float64)
        start, stop = xcorr.corr_window(n, config.history_len,
                                        len(template))
        corr_mask_full = np.zeros(n, dtype=bool)
        corr_mask_full[start:stop] = True
        return {
            "tmpl_fft_conj": xcorr.template_fft_conj(template, n),
            "tmpl_energy": xcorr.template_energy(template),
            "carrier_mask": carrier.window_mask(config.carrier_window, n),
            "corr_mask_full": corr_mask_full,
        }

    def _load_state(self, state):
        missing = set(STATE_KEYS) - set(state)
        if missing:
            raise ValueError("state lacks {}".format(sorted(missing)))
        n = self.config.block_len
        conj = np.asarray(state["tmpl_fft_conj"])
        if conj.dtype != np.complex64 or conj.shape != (n,):
            raise ValueError("tmpl_fft_conj must be complex64 [{}], got "
                             "{} {}".format(n, conj.dtype, conj.shape))
        self._tmpl_fft_conj = torch.from_numpy(
            np.ascontiguousarray(conj)).to(self.device)
        self._tmpl_energy = torch.tensor(
            np.float32(state["tmpl_energy"]), device=self.device)
        self._carrier_mask = power_peak.Mask(state["carrier_mask"],
                                             self.device)
        self._corr_mask_full = power_peak.Mask(state["corr_mask_full"],
                                               self.device)
        for name in ("_carrier_mask", "_corr_mask_full"):
            if len(getattr(self, name)) != n:
                raise ValueError("{} must have length {}".format(
                    name[1:], n))

    # -- the detect program --------------------------------------------------

    def _detect_batch(self, blocks):
        cfg = self.config
        n = cfg.block_len

        # Stage 1: carrier peak + spectrum energy in one pass.
        fft = fft_mod.fft(blocks)
        c_idx, c_peak_pow, c_energy = power_peak.fused_power_peak(
            fft, self._carrier_mask)
        c_mag = torch.sqrt(c_peak_pow)
        c_noise, c_thresh_sq = carrier.noise_and_threshold_sq(
            c_energy, c_peak_pow, n, cfg.carrier_thresh)
        c_det = c_mag > torch.sqrt(torch.clamp(c_thresh_sq, min=0.0))

        # Stage 2: sub-bin fit on the gathered complex neighbourhood
        # (carrier bins wrap circularly).
        neigh = torch.abs(dirichlet.gather_neighborhood(
            fft, c_idx, self._carrier_offs))
        c_off = torch.where(c_det, self._interp(neigh), 0.0)
        carrier_out = (c_det, c_idx, c_off, c_mag, c_noise)

        # Stages 3-5 read the time-domain blocks (fractional: ramp +
        # second FFT) or roll the carrier FFT (integer).
        src = fft if cfg.sync_mode == "integer" else blocks
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

    def _corr_stage(self, src, c_idx, c_off, signal_energy):
        """Stages 3-5 on [R, N] rows: carrier removal + despread, the
        correlation peak through the power/peak reduction on the
        full-length circular correlation (non-unique lags masked),
        sub-sample offset, noise / threshold.

        Strictly row-wise, so the gated path may run it on any
        compacted subset of the batch.  Returns (p_idx, p_mag, p_det,
        p_off, noise).
        """
        u_const, u_snr, _ = self.config.corr_thresh
        corr_full = self._remove_carrier_and_despread(src, c_idx, c_off)
        p_idx, p_peak_pow, _ = power_peak.fused_power_peak(
            corr_full, self._corr_mask_full)
        p_mag = torch.sqrt(p_peak_pow)
        neigh = torch.abs(dirichlet.gather_neighborhood(
            corr_full, p_idx, self._corr_offs))
        p_off = xcorr.gaussian_interpolate(
            None, p_idx, clip=self.corr_clip, values=neigh,
            length=self.corr_len)
        noise = self._corr_noise(signal_energy, p_mag,
                                 self.config.block_len)
        p_det = p_mag > torch.sqrt(u_const + u_snr * torch.square(noise))
        return p_idx, p_mag, p_det, p_off, noise

    def _corr_stage_gated(self, rows, c_det, cap):
        """Correlation on the batch's first ``cap`` carrier-positive rows.

        A stable sort of the carrier flag (integer keys, carriers first,
        index order kept) picks ``cap`` distinct row indices; those rows
        are gathered into contiguous [cap, N] tensors, run
        :meth:`_corr_stage` (power/peak kernel included) and are
        scattered back.  Capacity FILLER rows (carrier-negative rows
        gathered because the batch has fewer than ``cap`` carriers) are
        masked to the zero defaults, like every other carrier-negative
        row, so a noise block's outputs never depend on its batch.

        Returns (corr outputs [B], overflow): ``overflow`` is an
        on-device bool, set when the batch holds more than ``cap``
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
        scattered = []
        for o in outs:
            full = torch.zeros(batch, dtype=o.dtype, device=o.device)
            full[sel] = torch.where(keep, o, torch.zeros_like(o))
            scattered.append(full)
        overflow = torch.count_nonzero(c_det) > cap
        return tuple(scattered), overflow

    def _corr_stage_masked(self, rows, c_det):
        """The full-batch correlation of an overflowed gated batch, with
        the gate's carrier-negative masking (zeros / not detected)."""
        return tuple(torch.where(c_det, o, torch.zeros_like(o))
                     for o in self._corr_stage(*rows))

    def _remove_carrier_and_despread(self, src, c_idx, c_off):
        """Carrier-compensated full-length circular correlation [R, N].

        ``src``: the time-domain blocks (fractional sync) or their FFT
        (integer sync).
        """
        n = self.config.block_len
        if self.config.sync_mode == "integer":
            shifted = shift.integer_roll_fft(src, -c_idx)
        else:
            # Wrap the peak's FFT index to its SIGNED bin before building
            # the phase ramp: ramps for s and s+N are the same for even
            # N, but a |shift| ~ N ramp accumulates ~pi*N radians of f32
            # phase and loses ~3 digits of carrier alignment for
            # negative-frequency carriers.
            signed = torch.remainder(c_idx + n // 2, n) - n // 2
            shift_bins = -(signed.to(torch.float32) + c_off)
            shifted = shift.fractional_shift_fft(src, shift_bins)
        spec = xcorr.despread_spec(shifted, self._tmpl_fft_conj)
        return fft_mod.ifft(spec)

    @staticmethod
    def _signal_energy(blocks):
        """Time-domain block energy sum(|x|^2) for the corr noise."""
        return torch.sum(torch.square(blocks.real)
                         + torch.square(blocks.imag), dim=-1)

    def _corr_noise(self, signal_energy, p_mag, n):
        return xcorr.noise_rms(p_mag, signal_energy, self._tmpl_energy, n)

    @staticmethod
    def _finish_outputs(c_det, c_idx, c_off, c_mag, c_noise,
                        p_idx, p_mag, p_det, p_off, noise):
        """Mask the offset on non-detections and assemble the output."""
        p_off = torch.where(p_det, p_off, 0.0)
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
            "template_idx": torch.zeros_like(c_idx),
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
