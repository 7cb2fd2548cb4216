"""kernels_per_batch: device kernels in the profiler trace's slice of
the window, per batch submitted in that slice."""

from benchmark.harness.trace import kernels


def read(ctx):
    found = kernels(ctx.get("events") or [])
    batches = (ctx.get("trace") or {}).get("batches")
    if not found or not batches:
        return None
    return len(found) / batches
