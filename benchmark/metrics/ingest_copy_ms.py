"""ingest_copy_ms: host milliseconds per batch in the program's
``ingest.read`` span less the ring's wait in it: the copy out of the
ring (fused with the host unfold on that path), the tail splice and the
stamps, averaged over the batches finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.ingest_ms(ctx, wait=False)
