"""CLI: run the port's detector throughput benchmark (see
``thrifty_tpu_torch/bench.py``)."""

from __future__ import annotations

import sys


def _main(argv=None):
    from thrifty_tpu_torch import bench

    return bench.main(argv)


if __name__ == "__main__":
    sys.exit(_main())
