"""device_wait_ms: host milliseconds per batch in the program's
``drain.wait`` span: ``result()`` (under the gate, the overflow flag's
read and any re-run) and the wait for the batch's work on the card,
averaged over the batches finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.span_ms(ctx, "drain.wait")
