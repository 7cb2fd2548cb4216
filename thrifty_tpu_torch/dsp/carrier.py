"""Batched carrier detection helpers (counterpart of thrifty_tpu.dsp.carrier).

The carrier search window is a constant boolean FFT-index mask (it
handles the negative-bin wrap without data-dependent control flow); the
detector feeds it to the fused power/peak reduction and turns the
reduction's peak and energy into the noise estimate and threshold here
(reference thrifty/carrier_detect.py:61-115, fastcard/cardet.c:7-41):

  noise_rms  = sqrt((sum(mag^2) - 2*peak^2) / (N - 1))
  threshold  = sqrt(c + s*noise_rms^2 + d*var(mag))
  detected   = peak > threshold

The carrier peak filter (:func:`detect_peak_filtered`) searches the
argmax of a FIR-filtered magnitude window, which the power/peak
reduction cannot do; it runs as torch ops on the detector's device.
So does the windowed carrier stage (:func:`detect_windowed`): a DFT at
the window's bins only, its argmax over [B, W] and the spectrum energy
from Parseval on the time-domain block.
"""

from __future__ import annotations

import numpy as np
import torch

from thrifty_tpu_torch.dsp import mxu_fft


def fft_window_indices(start: int, stop: int, length: int) -> np.ndarray:
    """Resolve a closed signed-bin interval to wrapped FFT array indices.

    Reference bin-range semantics (thrifty/carrier_detect.py:17-58): a
    (start, stop) pair of signed frequency bins, e.g. (-10, 10) ->
    indices 1014..1023, 0..10 for N=1024, and (0, -1) meaning the full
    range.
    """
    if abs(start) >= length or abs(stop) >= length:
        raise ValueError(
            "frequency window out of range: {} - {}".format(start, stop)
        )
    if start < 0 and stop >= 0:
        start, stop = length + start, length + stop
    if start < 0:
        start = length + start
    if stop < 0:
        stop = length + stop
    if stop < start:
        start, stop = stop, start
    return np.arange(start, stop + 1) % length


def window_mask(window, length: int) -> np.ndarray:
    """Boolean FFT-index mask for a closed signed-bin interval
    (``window=None`` selects the full range)."""
    if window is None:
        window = (0, -1)
    mask = np.zeros(length, dtype=bool)
    mask[fft_window_indices(window[0], window[1], length)] = True
    return mask


def noise_and_threshold_sq(energy: torch.Tensor, peak_power: torch.Tensor,
                           n: int, thresh_coeffs):
    """Carrier noise estimate and squared threshold (no stddev term).

    Signed noise variance, as fastcard keeps it (fastcard/cardet.c:
    22-27): a carrier holding more than half the block's energy drives
    the variance negative, and the threshold then follows the signed
    value, so the strongest carriers are still detected.  The reported
    noise magnitude is clamped at zero.  Where the variance is
    non-negative the threshold uses ``square(noise_rms)``, which rounds
    like the reference's sqrt-then-square.
    """
    c, s, _ = thresh_coeffs
    noise_var = (energy - 2.0 * peak_power) / (n - 1)
    noise_rms = torch.sqrt(torch.clamp(noise_var, min=0.0))
    thresh_sq = c + s * torch.where(noise_var < 0.0, noise_var,
                                    torch.square(noise_rms))
    return noise_rms, thresh_sq


def apply_peak_filter(fft_mag: torch.Tensor, weights):
    """Matched-filter the magnitude spectrum with peak-shaped weights.

    ``filtered[k] = sqrt(sum_j w[j]^2 * mag[k - (W-1) + j]^2)``: a causal
    energy-domain FIR with zero initial conditions along the last axis
    (reference thrifty/carrier_detect.py:128-135, JAX
    ``carrier.apply_peak_filter``).  Returns (filtered, delay), where
    ``delay`` realigns the argmax to the true peak position.
    """
    weights = np.asarray(weights, dtype=np.float64)
    delay = len(weights) - int(np.argmax(weights)) - 1
    coeffs = (weights ** 2).astype(np.float32)
    power = torch.square(fft_mag)
    k = power.shape[-1]
    padded = torch.nn.functional.pad(power, (len(weights) - 1, 0))
    acc = None
    for s, coeff in enumerate(coeffs):
        term = float(coeff) * padded[..., s:s + k]
        acc = term if acc is None else acc + term
    return torch.sqrt(acc), delay


def detect_peak_filtered(fft_mag: torch.Tensor, weights,
                         selection: torch.Tensor, thresh_coeffs):
    """Carrier detection with the peak filter, on |FFT| [B, N] (the
    peak-filter branch of JAX ``carrier.detect``, carrier.py:136-170).

    The FIR runs over the window's bins in window order (``selection``,
    int64 on the magnitudes' device, so a window crossing the DC wrap
    sees its circular neighbours and its first W-1 bins the start-up
    transient), the argmax spans every filter output, and the peak index
    is reduced mod N: it may fall up to ``delay`` bins below the window
    start.  Noise from the unfiltered spectrum energy; with a stddev
    term d the threshold adds d*var(|FFT|) over all N bins.

    Returns (detected, peak_idx int32, peak_mag, noise_rms).
    """
    n = fft_mag.shape[-1]
    filtered, delay = apply_peak_filter(
        fft_mag.index_select(-1, selection), weights)
    filt_idx = torch.argmax(filtered, dim=-1)
    peak_mag = torch.gather(filtered, -1, filt_idx[..., None])[..., 0]
    peak_idx = torch.remainder(filt_idx - delay + selection[0], n).to(
        torch.int32)
    energy = torch.sum(torch.square(fft_mag), dim=-1)
    noise, thresh_sq = noise_and_threshold_sq(
        energy, torch.square(peak_mag), n, thresh_coeffs)
    if thresh_coeffs[2]:
        thresh_sq = thresh_sq + thresh_coeffs[2] * torch.var(
            fft_mag, dim=-1, correction=0)
    detected = peak_mag > torch.sqrt(torch.clamp(thresh_sq, min=0.0))
    return detected, peak_idx, peak_mag, noise


def windowed_selection(carrier_window, thresh_coeffs, n, fft_impl,
                       margin=0):
    """Eligibility and index sets of the windowed carrier DFT.

    Returns ``(sel int32, ext int64)`` when the windowed stage applies --
    an explicit carrier window, no stddev threshold term (it needs every
    bin's magnitude), a matmul FFT impl, and the window plus ``margin``
    wrapped neighbour bins a side within n // 8 -- else ``None``.
    ``sel`` are the window's FFT bins in window order; ``ext`` adds the
    interpolation margin.  Shared by the detector's carrier stage and
    the capture gate (JAX ``carrier.windowed_selection``).
    """
    if carrier_window is None or thresh_coeffs[2]:
        return None
    if not mxu_fft._use_matmul(fft_impl):
        return None
    sel = fft_window_indices(carrier_window[0], carrier_window[1], n)
    if len(sel) + 2 * margin > n // 8:
        return None
    ext = (int(sel[0]) - margin
           + np.arange(len(sel) + 2 * margin)) % n
    return sel.astype(np.int32), ext.astype(np.int64)


def detect_windowed(blocks: torch.Tensor, sel: torch.Tensor, ext,
                    margin: int, thresh_coeffs, fft_impl="auto",
                    fft_precision="highest"):
    """Carrier detection from a DFT at the window's bins only (JAX
    ``carrier.detect_windowed``, carrier.py:225-260).

    The carrier stage needs only the windowed argmax with its
    interpolation neighbourhood and the spectrum energy, which is
    Parseval's ``n * sum|x|^2`` on the time-domain block, so no [B, N]
    spectrum is made.  ``sel`` (int64 on the blocks' device), ``ext``
    (numpy) and ``margin`` come from :func:`windowed_selection`.

    Returns ``(det, idx int32, peak_mag, noise, thresh_sq, mag_ext,
    rel)``: the verdict, peak FFT bin, peak magnitude, noise RMS and
    squared threshold (:func:`noise_and_threshold_sq`), the extended
    window's magnitudes and the peak's position in the core window.
    """
    n = blocks.shape[-1]
    mag_w = torch.abs(mxu_fft.windowed_dft(blocks, ext, fft_impl,
                                           fft_precision))
    core = mag_w[..., margin:margin + len(sel)] if margin else mag_w
    rel = torch.argmax(core, dim=-1)
    peak_mag = torch.gather(core, -1, rel[..., None])[..., 0]
    idx = sel[rel].to(torch.int32)
    # Parseval: sum|FFT|^2 = N * sum|x|^2 (float32 rounding differs from
    # the spectral sum by ~1e-6 relative).
    energy = n * torch.sum(torch.square(blocks.real)
                           + torch.square(blocks.imag), dim=-1)
    noise, thresh_sq = noise_and_threshold_sq(
        energy, torch.square(peak_mag), n, thresh_coeffs)
    det = peak_mag > torch.sqrt(torch.clamp(thresh_sq, min=0.0))
    return det, idx, peak_mag, noise, thresh_sq, mag_w, rel.to(torch.int32)
