"""Batched carrier removal (counterpart of thrifty_tpu.dsp.shift).

Fractional mode only: shift each block by a fractional number of bins
with the shift theorem -- a phase ramp in the time domain, then an FFT
(reference thrifty/carrier_sync.py:222-238).
"""

from __future__ import annotations

import torch

from thrifty_tpu_torch.dsp import fft as fft_mod


def fractional_shift_fft(blocks: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """FFT of ``blocks`` [..., N] shifted by ``shift`` [...] bins
    (positive moves energy to higher bins)."""
    return fft_mod.fft_ramped(blocks, shift)
