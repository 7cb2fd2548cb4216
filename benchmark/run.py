"""The benchmark of the PyTorch + CUDA port of thrifty-tpu: one run of one
cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is a receiver configuration
(``benchmark/configs/<config>.json``) under a traffic mix
(``benchmark/traffic/<traffic>.json``).  The run synthesizes the mix's
stream from ``--seed``, feeds it to the port's ``detect`` loop
(``thrifty_tpu_torch.pipeline.detect.detect_batches``) through the
port's readers, warms up, measures for ``--seconds``, checks the
``.toad`` records written in the window against the float64 reference in
``benchmark/reference/``, and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``benchmark/metrics/<name>.py``) from spans and a profiler trace.

It needs an NVIDIA card and never falls back to the CPU.  Build and
kernel caches stay inside the checkout (``thrifty_tpu_torch/_build/``,
``.bench_cache/``).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")
# Fixed cache directories inside the checkout, set before CUDA or any
# compiler starts, so that only a checkout's first run builds.
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
if REPO not in sys.path:
    sys.path.insert(0, REPO)



def card_name_and_limit():
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = parser.parse_args(argv)

    from benchmark.harness import cells, session

    spec = cells.manifest()
    entry = cells.cell(spec, args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print("benchmark: needs {} CUDA card(s), found {}; no result".format(
            entry["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3

    result = session.run_cell(entry, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS)
    found = session.forbidden_modules()
    if found:
        print("benchmark: the run loaded {}; no result".format(
            ", ".join(found)), file=sys.stderr)
        return 4

    units = {m["name"]: m["unit"]
             for m in spec["end_to_end"] + spec["per_layer"]}
    if args.trace:
        values = result["per_layer"]
    else:
        values = session.end_to_end(result)
    metrics = {}
    for m in cells.metrics_for(spec, args.workload, args.trace):
        value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": result["memory_peak"]}
    line = {"correct": result["correct"],
            "attempted": result["info"]["batches"],
            "failed": result["info"]["failed_batches"],
            "metrics": metrics, "device": device}
    if args.trace:
        from benchmark.harness import trace as trace_mod

        events = result["events"]
        device["busy_s"] = trace_mod.busy_us(events) * 1e-6
        device["window_s"] = result["trace"]["window_s"]
        line["breakdown"] = {
            "device_ops": trace_mod.top_device_ops(events),
            "idle_gaps": trace_mod.idle_gaps(events, result["spans"])}
    line["checks"] = {name: {"value": float(value), "limit": float(limit)}
                      for name, value, limit in result["checks"]}

    info = dict(result["info"], card=card_name_and_limit(),
                setup_s=result["setup_s"])
    print("benchmark: " + json.dumps(info), file=sys.stderr)
    for name, value, limit in result["checks"]:
        print("check {} {!r} limit {!r}".format(name, float(value),
                                                float(limit)),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
