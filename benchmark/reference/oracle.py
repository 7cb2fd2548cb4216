"""Frozen float64 NumPy detector: the benchmark's plain reference.

A copy of the port's float64 oracle (``thrifty_tpu_torch/oracle/numpy_ref.py``
as of the benchmark's first version), kept here so that no change to the
program can move the yardstick.  It implements the upstream Thrifty
detector equations per block in float64 (thrifty/carrier_detect.py,
carrier_sync.py, soa_estimator.py, detect.py), and fastdet's
integer-sync numerics in :class:`FastdetOracleDetector`
(fastdet/corr_detector.cpp).  It imports nothing of the program.

One departure from the copied oracle: the Dirichlet carrier fit is the
bounded damped Gauss-Newton fit the program defines (as the JAX
detector does), in float64, in place of upstream's scipy ``curve_fit``.
Both minimise the same squares, but ``curve_fit`` is unbounded and
stops at its own tolerance: where the minimum lies more than a bin from
the peak bin (a weak carrier in noise) the two land apart, and
elsewhere they differ by ``curve_fit``'s tolerance, as much as a
lower-precision program does.  The copy's unused peak filter and
``soa`` helper are left out.
"""

from __future__ import annotations

import dataclasses
import numpy as np


def fft_window_indices(start, stop, length):
    """Wrapped FFT array indices of a closed signed-bin interval
    (upstream thrifty/carrier_detect.py:17-58); (0, -1) is the full
    range."""
    if abs(start) >= length or abs(stop) >= length:
        raise ValueError(
            "frequency window out of range: {} - {}".format(start, stop))
    if start < 0 and stop >= 0:
        start, stop = length + start, length + stop
    if start < 0:
        start = length + start
    if stop < 0:
        stop = length + stop
    if stop < start:
        start, stop = stop, start
    return np.arange(start, stop + 1) % length


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


class OracleDetector:
    """Per-block float64 detector implementing the reference equations."""

    def __init__(self, template, block_len=16384, history_len=4920,
                 carrier_thresh=(0.0, 15.0, 0.0), carrier_window=None,
                 corr_thresh=(0.0, 15.0, 0.0), interp_width=6):
        self.block_len = block_len
        self.history_len = history_len
        self.carrier_thresh = carrier_thresh
        self.corr_thresh = corr_thresh
        self.interp_width = interp_width

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

    # Dirichlet fit (thrifty/carrier_sync.py:150-196 fits the same model)
    def carrier_interpolate(self, fft_mag, peak_idx, iters=12,
                            damping=1e-4):
        """Sub-bin offset of |A * D(x - delta)| fitted to the magnitudes
        at x = -P//2 .. P//2 around the peak bin: ``iters`` damped
        Gauss-Newton steps from delta = 0 and A = the peak magnitude,
        delta clamped to [-1, 1] after each step."""
        half = self.interp_width // 2
        x = np.arange(-half, half + 1, dtype=np.float64)
        y = fft_mag[(peak_idx + np.arange(-half, half + 1)) % len(fft_mag)]
        a = np.pi / self.block_len
        w = self.carrier_len
        amp, delta = y[half], 0.0
        for _ in range(iters):
            u = x - delta
            near = np.abs(u) < 1e-2
            sin_wu, cos_wu = np.sin(a * w * u), np.cos(a * w * u)
            sin_u, cos_u = np.sin(a * u), np.cos(a * u)
            safe = np.where(near, 1.0, sin_u)
            d = np.where(near, 1.0 - a * a * u * u * (w * w - 1.0) / 6.0,
                         sin_wu / (w * safe))
            dd = np.where(near, -a * a * u * (w * w - 1.0) / 3.0,
                          (a * w * cos_wu * sin_u - a * sin_wu * cos_u)
                          / (w * safe * safe))
            resid = y - amp * np.abs(d)
            j_a = np.abs(d)
            j_d = -amp * np.sign(d) * dd
            a11 = np.sum(j_a * j_a) * (1.0 + damping)
            a22 = np.sum(j_d * j_d) * (1.0 + damping) + 1e-20
            a12 = np.sum(j_a * j_d)
            b1, b2 = np.sum(j_a * resid), np.sum(j_d * resid)
            det = a11 * a22 - a12 * a12
            if abs(det) < 1e-30:
                det = 1e-30
            amp += (a22 * b1 - a12 * b2) / det
            delta = float(np.clip(delta + (a11 * b2 - a12 * b1) / det,
                                  -1.0, 1.0))
        return delta

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
