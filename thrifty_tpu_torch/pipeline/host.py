"""Host-side helpers shared by the detect and capture loops: the input
byte stream and the pinned upload of each batch."""

from __future__ import annotations

import sys

import numpy as np
import torch

from thrifty_tpu_torch import spans


def open_source(args, config, path):
    """The raw input stream a CLI asked for: a live rtl_tcp or USB
    RTL-SDR source (``args.rtl_tcp`` / ``args.rtlsdr``, tuned from
    ``config``), stdin for ``'-'``, or the file ``path``.

    Returns ``None`` after printing ``stream error:`` when a live source
    cannot be opened (the CLIs then exit 1, like a stream that dies).
    The live sources are the port's numpy host modules (``io.rtlsdr``,
    ``io.rtl_tcp``).
    """
    if args.rtlsdr is not None:
        from thrifty_tpu_torch.io import rtlsdr

        return rtlsdr.make_source_cli(
            args.rtlsdr, config, bias_tee=args.bias_tee, quiet=args.quiet,
            ppm=args.ppm)
    if args.rtl_tcp is not None:
        from thrifty_tpu_torch.io import rtl_tcp

        return rtl_tcp.make_source_cli(
            args.rtl_tcp, config, bias_tee=args.bias_tee,
            reconnect=args.reconnect, quiet=args.quiet, ppm=args.ppm)
    return sys.stdin.buffer if path == "-" else open(path, "rb")


class PinnedUpload:
    """Copies uint8 host batches to ``device`` through two pinned
    buffers used in turn, with ``non_blocking=True``.

    The caller keeps at most one batch in flight: the buffer of batch k
    is written again only for batch k+2, after batch k has been drained
    (its outputs copied back, which orders after the upload on the same
    stream).  On the CPU the array is wrapped without a copy, or copied
    once when it is read-only (a zero-copy view of a mapped file).
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned = [None, None]
        self._turn = 0

    def __call__(self, array: np.ndarray, batch=None) -> torch.Tensor:
        """The batch on the device; ``batch``: the id its ``upload``
        span is recorded under (see :mod:`thrifty_tpu_torch.spans`)."""
        with spans.span("upload", batch):
            array = np.ascontiguousarray(array, dtype=np.uint8)
            if self.device.type != "cuda":
                if not array.flags.writeable:
                    array = array.copy()
                return torch.from_numpy(array)
            k = self._turn
            self._turn ^= 1
            if self._pinned[k] is None \
                    or self._pinned[k].shape != array.shape:
                self._pinned[k] = torch.empty(
                    array.shape, dtype=torch.uint8, pin_memory=True)
            self._pinned[k].numpy()[...] = array
            return self._pinned[k].to(self.device, non_blocking=True)
