"""Batched carrier removal (counterpart of thrifty_tpu.dsp.shift).

Two modes, matching the reference's two numerical variants:

- ``fractional``: shift each block by a fractional number of bins with
  the shift theorem -- a phase ramp in the time domain, then an FFT
  (reference thrifty/carrier_sync.py:222-238); the ramp and the
  transform are ``mxu_fft.fft_ramped``'s.
- ``integer``: circular roll of the block's FFT by the integer peak bin
  (fastdet/corr_detector.cpp:13-17,178-182); no second FFT.
"""

from __future__ import annotations

import torch

from thrifty_tpu_torch.dsp import mxu_fft


def fractional_shift_fft(blocks: torch.Tensor, shift: torch.Tensor,
                         impl="auto", precision="highest") -> torch.Tensor:
    """FFT of ``blocks`` [..., N] shifted by ``shift`` [...] bins
    (positive moves energy to higher bins), with the transform ``impl``
    and ``precision`` of :mod:`mxu_fft`.  On the four-step path the ramp
    is factored over its split (JAX's ``ramp='separable'``); elsewhere
    it is the explicit reference-shaped product.  Kept as this module's
    counterpart of JAX's ``shift.fractional_shift_fft``, which the parity
    tests hold it against."""
    return mxu_fft.fft_ramped(blocks, shift, impl, precision)


def integer_roll_fft(fft: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row circular roll: ``out[..., k] = fft[..., (k - shift) % N]``,
    np.roll along the last axis with one integer shift per row.

    A gather is a permutation, so the result is bitwise np.roll (the
    fastdet golden contract).  The JAX version's ``max_start`` bound is
    dropped: it only shortens the wrapped extension that a TPU
    dynamic-slice needs, and a gather has none.
    """
    n = fft.shape[-1]
    cols = torch.arange(n, device=fft.device)
    idx = torch.remainder(cols - shift.to(torch.int64)[..., None], n)
    return torch.gather(fft, -1, idx)
