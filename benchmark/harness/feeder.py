"""The pipe cells' generator process: writes a file's bytes to its
standard output over and over, as fast as the pipe takes them.

    python3 benchmark/harness/feeder.py BASE_STREAM_FILE

It stands for an SDR source writing into the FIFO of a receiver's
deployment (``deploy/detect_torch.sh``): a closed loop, with backpressure
through the pipe.  It imports nothing but the standard library, so it
starts in milliseconds and takes no CPU from the reader but its writes.
"""

import os
import sys

CHUNK = 1 << 20


def feed(path, fd=1):
    with open(path, "rb") as f:
        view = memoryview(f.read())
    try:
        while True:
            off = 0
            while off < len(view):
                off += os.write(fd, view[off:off + CHUNK])
    except (BrokenPipeError, KeyboardInterrupt):
        pass


if __name__ == "__main__":
    feed(sys.argv[1])
