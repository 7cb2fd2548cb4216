"""Command dispatcher of the port: ``python -m thrifty_tpu_torch.cli <command>``.

Mirrors ``thrifty_tpu.cli`` with the commands ported so far, lazily
importing each command module of the port.  ``identify``, ``match`` and
``tdoa`` are numpy, copies of the JAX package's modules; ``pos`` adds
the batched solver on torch.
"""

from __future__ import annotations

import importlib
import sys

HELP = """usage: python -m thrifty_tpu_torch.cli <command> [<args>]

thrifty-tpu on PyTorch + CUDA.

Receiver commands:
    capture           Carrier-gate a raw I/Q stream into a .card archive
    detect            Detect positioning signals, estimate SoA (batched, GPU)

Server commands:
    identify          Merge .toad files, identify transmitter IDs, dedup
    match             Match detections across receivers
    tdoa              Estimate TDOAs using beacon clock sync
    pos               Estimate positions from TDOAs (--batched: GPU solver)

Use 'python -m thrifty_tpu_torch.cli help <command>' for a command's
arguments.  Commands not listed here run on the JAX package
(python -m thrifty_tpu.cli)."""

COMMANDS = {
    "capture": "thrifty_tpu_torch.pipeline.capture",
    "detect": "thrifty_tpu_torch.pipeline.detect",
    "identify": "thrifty_tpu_torch.pipeline.identify",
    "match": "thrifty_tpu_torch.pipeline.matchmaker",
    "tdoa": "thrifty_tpu_torch.pipeline.tdoa",
    "pos": "thrifty_tpu_torch.pipeline.pos",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP)
        return 1

    command = argv.pop(0)
    if command in ("help", "--help", "-h"):
        if argv:
            command, argv = argv[0], argv[1:] + ["--help"]
        else:
            print(HELP)
            return 0

    if command not in COMMANDS:
        print("thrifty_tpu_torch: {!r} is not a command. "
              "See 'python -m thrifty_tpu_torch.cli --help'.".format(command),
              file=sys.stderr)
        return 1

    module = importlib.import_module(COMMANDS[command])
    return module._main(argv) or 0


if __name__ == "__main__":
    sys.exit(main())
