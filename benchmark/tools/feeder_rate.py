"""The pipe cells' generator alone: the feeder process writing a cell's
base stream into a pipe that a reader drains and discards.

    python3 benchmark/tools/feeder_rate.py [--seconds 5] [--seed 1]
        [--workload rx_example.pipe_hostunfold]

Prints one JSON line with the bytes and IQ samples per second the
feeder sustains, to set beside each pipe cell's ``iq_samples_per_s``:
when it is far above them, the generator does not set the pace.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


from benchmark.harness import cells, traffic  # noqa: E402
from benchmark.harness.inputs import FEEDER  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", default="rx_example.pipe_hostunfold")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    spec = cells.manifest()
    entry = cells.cell(spec, args.workload)
    settings = cells.config(entry["config"])
    mix = traffic.load(entry["traffic"])
    template = cells.template(settings)
    base, _ = traffic.base_stream(mix, settings, template, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base_stream.u8")
        base.tofile(path)
        proc = subprocess.Popen([sys.executable, FEEDER, path],
                                stdout=subprocess.PIPE, bufsize=0)
        buf = bytearray(1 << 20)
        total = 0
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < args.seconds:
                total += proc.stdout.readinto(buf)
        finally:
            elapsed = time.perf_counter() - t0
            proc.kill()
            proc.wait()
            proc.stdout.close()
    print(json.dumps({"workload": args.workload, "bytes_per_s":
                      total / elapsed, "iq_samples_per_s":
                      total / 2 / elapsed, "seconds": elapsed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
