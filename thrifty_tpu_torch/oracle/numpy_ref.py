"""Float64 numpy implementation of the reference detector equations.

This module is the *numerical ground truth* for the TPU detector: a
faithful, per-block float64 implementation of the reference's detection
math (thrifty/carrier_detect.py, carrier_sync.py, soa_estimator.py,
detect.py), using scipy's iterative curve_fit for the Dirichlet
interpolation exactly like the reference does.  It serves two purposes:

1. Test oracle: the batched TPU kernels must agree with it within the
   float32/SNR noise bound (the reference's own oracle-test pattern,
   tests/test_soa_estimator.py:65-75).
2. CPU baseline for bench.py: the reference code itself is Python 2 and
   cannot run here, so this is the measured stand-in for its
   single-threaded numpy hot loop.

It is NOT a port of the reference's class structure -- just its equations.
"""

from __future__ import annotations

import dataclasses
import numpy as np
from scipy.optimize import curve_fit

from thrifty_tpu_torch.dsp.carrier import fft_window_indices


@dataclasses.dataclass
class OracleResult:
    carrier_detect: bool
    carrier_bin: int
    carrier_offset: float
    carrier_energy: float
    carrier_noise: float
    detected: bool = False
    corr_sample: int = 0
    corr_offset: float = 0.0
    corr_energy: float = 0.0
    corr_noise: float = 0.0


def dirichlet_kernel(x, block_len, carrier_len):
    n, w = block_len, carrier_len
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sin(np.pi * w * x / n) / np.sin(np.pi * x / n) / w
    return np.where(np.isnan(out), 1.0, out)


class OracleDetector:
    """Per-block float64 detector implementing the reference equations."""

    def __init__(self, template, block_len=16384, history_len=4920,
                 carrier_thresh=(0.0, 15.0, 0.0), carrier_window=None,
                 corr_thresh=(0.0, 15.0, 0.0), interp_width=6,
                 peak_filter=None):
        self.block_len = block_len
        self.history_len = history_len
        self.carrier_thresh = carrier_thresh
        self.corr_thresh = corr_thresh
        self.interp_width = interp_width
        self.peak_filter = None if peak_filter is None else \
            np.asarray(peak_filter, dtype=np.float64)

        self.template = np.asarray(template, dtype=np.float64)
        tlen = len(self.template)
        self.template_energy = np.sum(self.template**2)
        padded = np.zeros(block_len)
        padded[:tlen] = self.template
        self.template_fft_conj = np.conj(np.fft.fft(padded))
        self.corr_len = block_len - tlen + 1

        # Unique-lag window (thrifty/soa_estimator.py:20-39).
        padding = history_len - tlen + 1
        left = padding // 2
        self.window = (left, self.corr_len - (padding - left))

        if carrier_window is None:
            carrier_window = (0, -1)
        self.carrier_idx = fft_window_indices(
            carrier_window[0], carrier_window[1], block_len)

        self.new_len = block_len - history_len
        self.carrier_len = tlen

    # carrier stage (thrifty/carrier_detect.py:61-154)
    def carrier_detect(self, fft_mag):
        sel = fft_mag[self.carrier_idx]
        if self.peak_filter is not None:
            # Reference _filter/_window_peak: energy-domain FIR over
            # the contiguous wrapped window selection (zero initial
            # conditions at the window start), argmax over every
            # filter output, peak index delay-corrected and may fall
            # below the window (thrifty/carrier_detect.py:131-154).
            import scipy.signal
            w = self.peak_filter
            delay = len(w) - int(np.argmax(w)) - 1
            filt = np.sqrt(scipy.signal.lfilter(w[::-1] ** 2, 1,
                                                sel ** 2))
            k = int(np.argmax(filt))
            peak_idx = int(
                (k - delay + self.carrier_idx[0]) % len(fft_mag))
            peak_mag = filt[k]
        else:
            k = int(np.argmax(sel))
            peak_idx = int(self.carrier_idx[k])
            peak_mag = sel[k]
        noise = np.sqrt(
            (np.sum(fft_mag**2) - 2 * peak_mag**2) / (len(fft_mag) - 1))
        c, s, d = self.carrier_thresh
        thr_sq = c + s * noise**2
        if d:
            thr_sq += d * np.std(fft_mag) ** 2
        return peak_mag > np.sqrt(thr_sq), peak_idx, peak_mag, noise

    # Dirichlet curve-fit interpolation (thrifty/carrier_sync.py:150-196)
    def carrier_interpolate(self, fft_mag, peak_idx):
        width = self.interp_width
        xdata = np.arange(-(width // 2), width // 2 + 1)
        ydata = fft_mag[(peak_idx + xdata) % len(fft_mag)]

        def model(x, ampl, offset):
            return ampl * np.abs(
                dirichlet_kernel(x - offset, self.block_len, self.carrier_len))

        popt, _ = curve_fit(model, xdata, ydata,
                            p0=(fft_mag[peak_idx], 0.0))
        return popt[1]

    # freq shift (thrifty/carrier_sync.py:222-238)
    def freq_shift_fft(self, block, shift):
        n = len(block)
        freqs = np.arange(n) / n - 0.5
        return np.fft.fft(block * np.exp(2j * np.pi * shift * freqs))

    def sync_fft(self, block, fft, c_bin, c_off):
        """Carrier-removed FFT for the analysis tooling (fractional)."""
        return self.freq_shift_fft(block, -(c_bin + c_off))

    # SoA stage (thrifty/soa_estimator.py:78-170)
    def soa_estimate(self, shifted_fft, signal_energy):
        corr = np.fft.ifft(shifted_fft * self.template_fft_conj)
        corr = corr[:self.corr_len]
        corr_mag = np.abs(corr)
        start, stop = self.window
        peak_idx = int(np.argmax(corr_mag[start:stop])) + start
        peak_mag = corr_mag[peak_idx]

        corr_energy = signal_energy * self.template_energy
        noise = np.sqrt((corr_energy - peak_mag**2) / self.block_len)

        c, s, d = self.corr_thresh
        thr_sq = c + s * noise**2
        if d:
            thr_sq += d * np.std(corr_mag) ** 2
        detected = peak_mag > np.sqrt(thr_sq)

        offset = 0.0
        if detected and 0 < peak_idx < len(corr_mag) - 1:
            la, lb, lc = np.log(corr_mag[peak_idx - 1:peak_idx + 2])
            offset = 0.5 * (lc - la) / (2 * lb - la - lc)
            offset = float(np.clip(offset, -0.6, 0.6))
        return detected, peak_idx, offset, peak_mag, noise

    def detect_block(self, block) -> OracleResult:
        """Full single-block detection (float64)."""
        block = np.asarray(block, dtype=np.complex128)
        fft = np.fft.fft(block)
        fft_mag = np.abs(fft)
        c_det, c_idx, c_mag, c_noise = self.carrier_detect(fft_mag)

        result = OracleResult(
            carrier_detect=bool(c_det), carrier_bin=c_idx,
            carrier_offset=0.0, carrier_energy=float(c_mag),
            carrier_noise=float(c_noise))
        if not c_det:
            return result

        c_off = float(self.carrier_interpolate(fft_mag, c_idx))
        result.carrier_offset = c_off

        shifted_fft = self.sync_fft(block, fft, c_idx, c_off)
        signal_energy = np.sum(np.abs(block) ** 2)
        det, p_idx, p_off, p_mag, p_noise = self.soa_estimate(
            shifted_fft, signal_energy)

        result.detected = bool(det)
        result.corr_sample = int(p_idx)
        result.corr_offset = float(p_off)
        result.corr_energy = float(p_mag)
        result.corr_noise = float(p_noise)
        return result

    def soa(self, block_idx, corr_sample, corr_offset):
        return self.new_len * block_idx + corr_sample + corr_offset


class FastdetOracleDetector(OracleDetector):
    """Float64 oracle for fastdet's (C++) detection semantics.

    Differences from the Python-reference path implemented by
    :class:`OracleDetector` (fastdet/corr_detector.cpp):

    * frequency sync is an *integer* roll of the FFT by -argmax
      (corr_detector.cpp:177-182) -- no fractional phase-ramp shift;
    * the correlation sub-sample offset uses Gaussian interpolation on
      log magnitudes clipped to +-0.5, not +-0.6
      (corr_detector.cpp:103-116);
    * the carrier sub-bin offset uses 3-point parabolic interpolation
      on magnitudes, clipped to +-0.5 (corr_detector.cpp:88-101,
      190-194), not the Dirichlet curve fit.
    """

    def carrier_interpolate(self, fft_mag, peak_idx):
        n = len(fft_mag)
        a = fft_mag[(peak_idx - 1) % n]
        b = fft_mag[peak_idx]
        c = fft_mag[(peak_idx + 1) % n]
        den = 4 * b - 2 * a - 2 * c
        if den == 0:  # flat neighborhood: no sub-bin information
            return 0.0
        return float(np.clip((c - a) / den, -0.5, 0.5))

    def soa_estimate(self, shifted_fft, signal_energy):
        det, p_idx, p_off, p_mag, p_noise = super().soa_estimate(
            shifted_fft, signal_energy)
        return det, p_idx, float(np.clip(p_off, -0.5, 0.5)), p_mag, p_noise

    def sync_fft(self, block, fft, c_bin, c_off):
        """Integer-bin roll (fastdet/corr_detector.cpp:177-182)."""
        return np.roll(fft, -c_bin)
