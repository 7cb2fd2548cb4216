"""Small shared DSP utilities."""

from __future__ import annotations

import numpy as np


def snr_db(peak_ampl, noise_rms):
    """SNR in dB from a peak amplitude and noise RMS."""
    return 20.0 * np.log10(np.divide(peak_ampl, noise_rms))


def fft_bin(idx: int, fft_len: int) -> int:
    """Convert a standard-order FFT array index to a signed frequency bin."""
    if idx < 0 or idx <= (2 * fft_len - 1) / 4:
        return idx
    return idx - fft_len
