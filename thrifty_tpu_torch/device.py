"""Explicit device selection for the port.

The port runs on the card unless the caller asks for the CPU: every
entry point's ``device`` defaults to ``"cuda"``, the tests pass
``"cpu"``.  Asking for ``"cuda"`` on a machine without a usable card is
an error, not a quiet fall back to the CPU (a detector that silently
runs on the CPU is a detector that silently misses real time).
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> :class:`torch.device`; raises
    ``RuntimeError`` for ``"cuda"`` when no card is available.

    Also pins float32 arithmetic to full precision: TF32 off for both
    matrix products (``torch.backends.cuda.matmul.allow_tf32 = False``)
    and cuDNN (``torch.backends.cudnn.allow_tf32 = False``).  TF32
    keeps about three decimal digits, far too few for sub-sample
    arrival times.
    """
    if name not in DEVICES:
        raise ValueError("unknown device {!r}: expected 'cuda' or "
                         "'cpu'".format(name))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is false (no CUDA card or a CPU-only PyTorch build)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def as_device(device) -> torch.device:
    """A device name or :class:`torch.device` of type ``"cuda"`` or
    ``"cpu"`` -> :class:`torch.device`, through :func:`resolve_device`
    (so a CUDA device without a usable card raises ``RuntimeError``);
    an explicit index such as ``"cuda:1"`` is kept."""
    dev = torch.device(device)
    resolved = resolve_device(dev.type)
    return resolved if dev.index is None else dev
