"""Batched transforms on ``torch.fft`` (cuFFT on the card).

Counterpart of ``thrifty_tpu.dsp.mxu_fft``'s ``fft``, ``ifft`` and the
full-ramp branch of ``fft_ramped``.  The TPU-only knobs (matmul /
four-step transforms, their accumulation precision, the separable ramp)
exist to put the transform on the TPU's matrix unit and have no
counterpart here: cuFFT computes the transform in float32 directly.
"""

from __future__ import annotations

import numpy as np
import torch

# 2*pi rounded to float32, as JAX rounds the weak-typed constant.
_TWO_PI = float(np.float32(2.0 * np.pi))


def fft(x: torch.Tensor) -> torch.Tensor:
    """Batched FFT along the last axis."""
    return torch.fft.fft(x, dim=-1)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Batched inverse FFT along the last axis (1/n normalised)."""
    return torch.fft.ifft(x, dim=-1)


def fft_ramped(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """FFT of ``x * exp(2j*pi*shift*(t/n - 0.5))``: the reference's
    fractional carrier shift (thrifty/carrier_sync.py:60-75).

    ``x``: complex64 [..., n]; ``shift``: float32 [...] in bins.  The
    ramp formula is the JAX package's full-ramp branch
    (``mxu_fft.fft_ramped(separable=False)``) term for term:
    ``pos = arange(n)/n - 0.5`` in float32 and phase
    ``(2*pi * shift) * pos``.
    """
    n = x.shape[-1]
    pos = torch.arange(n, dtype=torch.float32, device=x.device) / n - 0.5
    phase = (shift[..., None] * _TWO_PI) * pos
    ramp = torch.complex(torch.cos(phase), torch.sin(phase))
    return fft(x * ramp)
