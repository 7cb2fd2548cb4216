"""How a cell's stream reaches the program: through an OS pipe from the
feeder process into the port's ``StreamPump``, or as a ``.card`` file
read in passes by the port's ``iter_card_batches`` behind its
``prefetch_iter``, as ``detect`` reads each input."""

from __future__ import annotations

import base64
import collections
import hashlib
import os
import subprocess
import sys

import numpy as np

from benchmark.reference.inputs import CyclicStream

FEEDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "feeder.py")


class PipeSource:
    """The feeder writes the base stream into a pipe, cyclically; the
    port's ``StreamPump`` reads it (``batches_contiguous`` under device
    unfold, ``batches`` otherwise), stamping blocks from ``t0``."""

    def __init__(self, base_u8, settings, traffic, tmpdir, device_unfold):
        from thrifty_tpu_torch.io.stream import StreamPump

        path = os.path.join(tmpdir, "base_stream.u8")
        base_u8.tofile(path)
        self.proc = subprocess.Popen(
            [sys.executable, FEEDER, path], stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, bufsize=0)
        self.pump = StreamPump(
            self.proc.stdout, settings["block_size"],
            settings["block_history"], settings["batch_size"],
            sample_rate=settings["sample_rate"], t0=traffic["t0"])
        self.device_unfold = device_unfold
        self.starts = None  # a batch starts when the pump is asked for it

    def batches(self):
        return (self.pump.batches_contiguous() if self.device_unfold
                else self.pump.batches())

    def close(self):
        self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        self.pump.close()


class CardSource:
    """A ``.card`` file of the blocks a capture would archive from the
    cyclic stream (those any burst touches), ``card_lines`` lines, read
    again from the start when a pass ends."""

    def __init__(self, base_u8, settings, traffic, tmpdir, archived):
        self.path = os.path.join(tmpdir, "capture.card")
        self.batch = settings["batch_size"]
        stream = CyclicStream(base_u8, settings["block_size"],
                              settings["block_history"])
        block_dt = stream.new_len / settings["sample_rate"]
        encoded = {}
        lines = []
        cycle = 0
        while len(lines) < traffic["card_lines"]:
            for j in archived:
                g = cycle * stream.period + j
                key = stream.key(g)
                if key not in encoded:
                    encoded[key] = base64.b64encode(
                        stream.block_bytes(key).tobytes()).decode("ascii")
                lines.append("{:.6f} {} {}\n".format(
                    traffic["t0"] + g * block_dt, g, encoded[key]))
                if len(lines) == traffic["card_lines"]:
                    break
            cycle += 1
        with open(self.path, "w") as f:
            f.writelines(lines)
        # When the wrapped reader starts each batch, before the
        # prefetch queue: the queue's wait counts in the latency.
        self.starts = collections.deque()
        self._passes = None

    def _passes_iter(self, clock):
        from thrifty_tpu_torch.io.card import iter_card_batches

        while True:
            with open(self.path, "rb") as f:
                it = iter_card_batches(f, self.batch)
                while True:
                    t = clock()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    self.starts.append(t)
                    yield item

    def batches(self, clock):
        from thrifty_tpu_torch.io.stream import prefetch_iter

        self._passes = prefetch_iter(self._passes_iter(clock), depth=2)
        return self._passes

    def close(self):
        if self._passes is not None:
            self._passes.close()


def card_reference_blocks(path):
    """The reference's view of a ``.card`` file: (key_of, bytes_of,
    ts_of) over its own decode, one key per distinct payload."""
    from benchmark.reference.inputs import read_card

    ts, idx, rows = read_card(path)
    key_by_idx, rows_by_key, ts_by_idx = {}, {}, {}
    for t, i, row in zip(ts, idx, rows):
        key = hashlib.sha1(row.tobytes()).hexdigest()
        key_by_idx[int(i)] = key
        rows_by_key[key] = row
        ts_by_idx[int(i)] = float(t)
    return (key_by_idx.__getitem__, rows_by_key.__getitem__,
            ts_by_idx.__getitem__)


def stream_reference_blocks(base_u8, settings, traffic):
    """The reference's view of the cyclic stream: (key_of, bytes_of,
    ts_of), timestamps ``t0 + block * block_dt`` as a receiver given
    ``--t0`` stamps them."""
    stream = CyclicStream(base_u8, settings["block_size"],
                          settings["block_history"])
    block_dt = stream.new_len / settings["sample_rate"]
    t0 = traffic["t0"]
    return (stream.key, stream.block_bytes,
            lambda g: t0 + np.float64(g) * block_dt)
