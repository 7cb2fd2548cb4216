"""Batched carrier detection helpers (counterpart of thrifty_tpu.dsp.carrier).

The carrier search window is a constant boolean FFT-index mask (it
handles the negative-bin wrap without data-dependent control flow); the
detector feeds it to the fused power/peak reduction and turns the
reduction's peak and energy into the noise estimate and threshold here
(reference thrifty/carrier_detect.py:61-115, fastcard/cardet.c:7-41):

  noise_rms  = sqrt((sum(mag^2) - 2*peak^2) / (N - 1))
  threshold  = sqrt(c + s*noise_rms^2)
  detected   = peak > threshold
"""

from __future__ import annotations

import numpy as np
import torch


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
