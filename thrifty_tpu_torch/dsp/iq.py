"""RTL-SDR 8-bit interleaved I/Q <-> complex64.

Counterpart of ``thrifty_tpu.dsp.iq``: the same ``(x - 127.4) / 128``
conversion (reference thrifty/block_data.py:38-67), so the batch crosses
host -> device as uint8 (2 bytes per sample) and is widened there.
``raw_to_iq`` (torch) and ``raw_to_iq_host`` (numpy, for ``io.card`` and
``sim``) are bit-equal to the host numpy ``thrifty_tpu.dsp.iq.raw_to_iq``;
``iq_to_raw`` is the host numpy quantiser that writes synthetic captures.
"""

from __future__ import annotations

import numpy as np
import torch

DC_OFFSET = 127.4
SCALE = 1.0 / 128.0


def raw_to_iq(raw: torch.Tensor) -> torch.Tensor:
    """uint8 interleaved I/Q [..., 2N] -> complex64 [..., N] (same device).

    Converts every byte in one float32 pass and reinterprets the
    (I, Q) pairs as complex64 with ``view_as_complex`` -- no strided copy.
    """
    if raw.dtype != torch.uint8 or raw.shape[-1] % 2:
        raise ValueError("raw must be uint8 [..., 2N], got {} {}".format(
            raw.dtype, tuple(raw.shape)))
    f = (raw.to(torch.float32) - DC_OFFSET) * SCALE
    return torch.view_as_complex(f.reshape(f.shape[:-1] + (-1, 2)))


def raw_to_iq_host(raw: np.ndarray) -> np.ndarray:
    """uint8 interleaved I/Q [..., 2N] -> complex64 [..., N] (host numpy)."""
    raw = np.asarray(raw, dtype=np.uint8)
    f = raw.astype(np.float32)
    i = (f[..., 0::2] - DC_OFFSET) * SCALE
    q = (f[..., 1::2] - DC_OFFSET) * SCALE
    return (i + 1j * q).astype(np.complex64)


def iq_to_raw(iq: np.ndarray) -> np.ndarray:
    """complex64 [..., N] -> uint8 interleaved I/Q [..., 2N] (host numpy).

    Clipped to the ADC range and truncated like the reference's
    complex_to_raw (thrifty/block_data.py:55-67).
    """
    iq = np.asarray(iq, dtype=np.complex64)
    pairs = np.stack([iq.real, iq.imag], axis=-1).reshape(
        iq.shape[:-1] + (2 * iq.shape[-1],))
    return np.clip(pairs * 128.0 + DC_OFFSET, 0.0, 255.0).astype(np.uint8)
