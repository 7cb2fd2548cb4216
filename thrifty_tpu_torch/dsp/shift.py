"""Batched carrier removal (counterpart of thrifty_tpu.dsp.shift).

Two modes, matching the reference's two numerical variants:

- ``fractional``: shift each block by a fractional number of bins with
  the shift theorem -- a phase ramp in the time domain, then an FFT
  (reference thrifty/carrier_sync.py:222-238).
- ``integer``: circular roll of the block's FFT by the integer peak bin
  (fastdet/corr_detector.cpp:13-17,178-182); no second FFT.
"""

from __future__ import annotations

import torch

from thrifty_tpu_torch.dsp import fft as fft_mod


def fractional_shift_fft(blocks: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """FFT of ``blocks`` [..., N] shifted by ``shift`` [...] bins
    (positive moves energy to higher bins)."""
    return fft_mod.fft_ramped(blocks, shift)


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
