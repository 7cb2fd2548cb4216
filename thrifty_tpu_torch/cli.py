"""Command dispatcher of the port: ``python -m thrifty_tpu_torch.cli <command>``.

Mirrors ``thrifty_tpu.cli`` with all of its commands, lazily importing
each command module of the port.  The commands that build a detector or
run the batched solver (``detect``, ``capture``, ``pos --batched``,
``serve``, ``template_extract``, ``doctor``, ``bench``) take
``--device`` (the card by default); the rest are numpy on the host,
copies of the JAX package's modules.
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
    serve             Live positioning: tail .toad files, emit fixes (GPU solver)
    track             Kalman-smooth position fixes into tracks

Analysis commands:
    analyze_toads     Statistics on .toads detection data
    analyze_detect    Per-stage detection diagnostics
    analyze_beacon    Beacon clock-sync quality between two receivers
    analyze_tdoa      TDOA precision measurement

Utilities:
    template_generate Generate a new (ideal) Gold-code template
    template_extract  Extract a template from captured data (GPU detector)
    gold              Generate Gold codes / print code stats
    scope             Live time/freq/histogram scope with triggers
    doctor            Check this node can run the full pipeline on its card
    bench             Detector throughput benchmark (GPU)

Use 'python -m thrifty_tpu_torch.cli help <command>' for a command's
arguments."""

COMMANDS = {
    "capture": "thrifty_tpu_torch.pipeline.capture",
    "detect": "thrifty_tpu_torch.pipeline.detect",
    "identify": "thrifty_tpu_torch.pipeline.identify",
    "match": "thrifty_tpu_torch.pipeline.matchmaker",
    "tdoa": "thrifty_tpu_torch.pipeline.tdoa",
    "pos": "thrifty_tpu_torch.pipeline.pos",
    "serve": "thrifty_tpu_torch.pipeline.server",
    "track": "thrifty_tpu_torch.pipeline.track",
    "analyze_toads": "thrifty_tpu_torch.analysis.toads_analysis",
    "analyze_detect": "thrifty_tpu_torch.analysis.detect_analysis",
    "analyze_beacon": "thrifty_tpu_torch.analysis.beacon_analysis",
    "analyze_tdoa": "thrifty_tpu_torch.analysis.tdoa_analysis",
    "template_generate": "thrifty_tpu_torch.pipeline.template_generate",
    "template_extract": "thrifty_tpu_torch.pipeline.template_extract",
    "gold": "thrifty_tpu_torch.pipeline.gold_cli",
    "scope": "thrifty_tpu_torch.pipeline.scope",
    "doctor": "thrifty_tpu_torch.pipeline.doctor",
    "bench": "thrifty_tpu_torch.pipeline.bench_cli",
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
