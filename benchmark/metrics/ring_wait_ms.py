"""ring_wait_ms: host milliseconds per batch the program's reader spent
blocked on the native ring until the pipe had delivered the batch (the
ring's ``read_wait_ns``, counted at ``ingest.read``), averaged over the
batches finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.ingest_ms(ctx, wait=True)
