"""d2h_ms: host milliseconds per batch in the program's ``drain.copy``
span, the batch's outputs copied to the host, averaged over the batches
finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.span_ms(ctx, "drain.copy")
