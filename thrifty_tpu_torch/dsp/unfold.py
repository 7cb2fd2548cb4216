"""Device-side overlap-save unfold of a contiguous byte stream
(counterpart of thrifty_tpu.dsp.unfold).

Shared by the detector (``BatchDetector.detect_raw_stream``) and the
capture carrier gate (``CarrierGate.gate_stream``): the host ships only
the stream's NEW bytes and the overlap-save rows are rebuilt on the
device against a history carry kept there (reference geometry:
fastcard/raw_reader.c:22-30).

The JAX package moves packed uint16 I/Q byte pairs because a TPU
gathers 2-byte lanes well; PyTorch has few uint16 ops, so the port stays
in bytes: ``Tensor.unfold`` over ``[carry | new bytes]`` gives the rows
as a strided view for any history length, and ``iq.raw_to_iq`` widens
them.  The rows are bit-equal to the JAX package's
``unfold_stream`` + ``iq.u16_to_iq_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_SIGNAL = 0x80  # one zero-amplitude I or Q byte


class StreamCarry:
    """The history carry of a streaming overlap-save, on one device.

    Holds the last ``2*history_len`` bytes of the stream (pre-stream
    state: zero-signal ``0x80`` bytes); one implementation for the
    detector and the capture gate, so their carry conventions cannot
    drift apart.
    """

    def __init__(self, history_len, device):
        self.history_len = history_len
        self.device = torch.device(device)
        self.carry = None  # uint8 [2*history_len] once streaming starts

    def reset(self):
        """Back to the zero-signal pre-stream state."""
        self.carry = torch.full((2 * self.history_len,), ZERO_SIGNAL,
                                dtype=torch.uint8, device=self.device)

    def call(self, stream_fn, new_raw, new_len=None):
        """Run ``stream_fn(new_bytes, carry) -> (out, new_carry)`` on
        ``new_raw`` (uint8, numpy or tensor, moved to the carry's
        device) and advance the carry.  ``new_len``: when given, the
        byte count must be a whole number of blocks of ``new_len``
        samples."""
        if isinstance(new_raw, np.ndarray):
            new_raw = torch.from_numpy(np.ascontiguousarray(new_raw))
        if new_raw.dtype != torch.uint8:
            raise ValueError("stream bytes must be uint8, got {}".format(
                new_raw.dtype))
        new_raw = new_raw.reshape(-1).to(self.device)
        if new_len is not None and new_raw.numel() % (2 * new_len):
            raise ValueError("stream bytes must be a whole number of "
                             "blocks (pad the final batch)")
        if self.carry is None:
            self.reset()
        out, self.carry = stream_fn(new_raw, self.carry)
        return out


def overlap_rows(full, block_len, history_len):
    """Overlap-save rows of ``full`` [..., history + B*new] as a view
    [..., B, block_len]: row s spans ``full[..., s*new : s*new + block]``
    with ``new = block_len - history_len``.  Any ``history_len <
    block_len`` works, history longer than the advance included."""
    new = block_len - history_len
    return full.unfold(-1, block_len, new)


def unfold_stream(new_u8, carry_u8, block_len, history_len):
    """uint8 new bytes [B*2*new_len] + carry [2*history_len] ->
    (rows uint8 [B, 2*block_len], new carry [2*history_len]).

    ``block_len`` and ``history_len`` count samples (two bytes each).
    The new carry is a copy: it never aliases the caller's buffer.
    """
    new = block_len - history_len
    if new_u8.dim() != 1 or new_u8.numel() == 0 \
            or new_u8.numel() % (2 * new):
        # A floored-away remainder would skip those samples as any
        # block's unique region while the carry advanced past them.
        raise ValueError(
            "stream must carry a whole positive number of blocks: {} "
            "bytes is not a multiple of 2*new_len={} (pad the final "
            "batch)".format(new_u8.numel(), 2 * new))
    if carry_u8.shape != (2 * history_len,):
        raise ValueError("carry must be uint8 [{}], got {}".format(
            2 * history_len, tuple(carry_u8.shape)))
    stream = torch.cat([carry_u8, new_u8])
    rows = overlap_rows(stream, 2 * block_len, 2 * history_len)
    return rows, stream[stream.numel() - 2 * history_len:].clone()
