"""Batched matched filtering and sub-sample SoA estimation (counterpart of
thrifty_tpu.dsp.xcorr).

  corr      = IFFT(FFT(block_shifted) * conj(FFT(template)))
  noise_rms = sqrt((E_signal * E_template - peak^2) / N)
  offset    = gaussian 3-point log interpolation, clipped to +-0.6

(reference thrifty/soa_estimator.py:42-170).  The template constants are
numpy, computed once on the host in float64 and rounded to the device
dtypes exactly as the JAX package rounds them.
"""

from __future__ import annotations

import numpy as np
import torch


def corr_window(block_len: int, history_len: int, template_len: int):
    """Half-open [start, stop) interval of correlation lags unique to a block.

    With overlap-save blocking a correlation peak inside this window
    appears in exactly one block (reference thrifty/soa_estimator.py:20-39).
    """
    if history_len < template_len - 1:
        raise ValueError("history_len must be >= template_len - 1")
    corr_len = block_len - template_len + 1
    padding = history_len - template_len + 1
    left = padding // 2
    right = padding - left
    return left, corr_len - right


def template_fft_conj(template: np.ndarray, block_len: int) -> np.ndarray:
    """conj(FFT(zero-padded template)) as complex64 [block_len]
    (one template; computed in float64)."""
    template = np.asarray(template, dtype=np.float64)
    if template.ndim != 1:
        raise ValueError("expected one 1-D template")
    padded = np.zeros(block_len, dtype=np.float64)
    padded[:len(template)] = template
    return np.conj(np.fft.fft(padded)).astype(np.complex64)


def template_energy(template: np.ndarray) -> np.ndarray:
    """Sum of squared template samples, float32."""
    template = np.asarray(template, dtype=np.float64)
    return np.sum(template**2, axis=-1).astype(np.float32)


def despread_spec(shifted_fft: torch.Tensor,
                  tmpl_fft_conj: torch.Tensor) -> torch.Tensor:
    """Correlation spectrum X = FFT(block_shifted) * conj(FFT(template));
    [B, N] * [N] -> [B, N], with corr = IFFT(X)."""
    return shifted_fft * tmpl_fft_conj


def noise_rms(peak_mag, signal_energy, tmpl_energy, block_len: int):
    """Correlation-domain noise estimate: the block's time-domain energy
    sum(|x|^2) times the template energy is the total correlation
    energy; the peak's power is subtracted (reference
    thrifty/soa_estimator.py:108-120)."""
    corr_energy = signal_energy * tmpl_energy
    power = (corr_energy - torch.square(peak_mag)) / block_len
    return torch.sqrt(torch.clamp(power, min=0.0))


def _gather_neighborhood(corr_mag, peak_idx, half, values=None,
                         length=None):
    """(y [..., 2*half+1], in_bounds [...]) around each peak.

    ``values`` bypasses the gather with a precomputed neighbourhood
    (pass ``length`` for the bounds check then).  Peaks within ``half``
    of either edge are flagged out of bounds (callers return offset 0
    there); the gather indices are clipped so those lanes still read
    valid memory.
    """
    n = corr_mag.shape[-1] if length is None else length
    if values is None:
        safe_idx = torch.clamp(peak_idx.to(torch.int64), half, n - half - 1)
        offs = torch.arange(-half, half + 1, device=peak_idx.device)
        y = torch.gather(corr_mag, -1, safe_idx[..., None] + offs)
    else:
        y = values
    in_bounds = (peak_idx >= half) & (peak_idx < n - half)
    return y, in_bounds


def gaussian_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                         values=None, length=None):
    """Batched Gaussian (log-parabolic) sub-sample peak interpolation.

    offset = 0.5*(ln c - ln a)/(2 ln b - ln a - ln c), clipped to +-clip
    (reference thrifty/soa_estimator.py:159-170).  Out-of-bounds peaks
    return offset 0.  ``values`` bypasses the gather with a
    precomputed [..., 3] magnitude neighbourhood (pass ``length`` for
    the bounds check then); ``corr_mag`` may then be None.
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1, values,
                                        length)
    y = torch.clamp(y, min=1e-30)  # guard log of zero magnitudes
    la, lb, lc = torch.log(y[..., 0]), torch.log(y[..., 1]), \
        torch.log(y[..., 2])
    den = 2.0 * lb - la - lc
    tiny = torch.where(den < 0.0, -1e-30, 1e-30)
    den = torch.where(torch.abs(den) < 1e-30, tiny, den)
    offset = 0.5 * (lc - la) / den
    offset = torch.clamp(offset, -clip, clip)
    return torch.where(in_bounds, offset, 0.0)
