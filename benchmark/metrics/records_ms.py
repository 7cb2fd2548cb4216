"""records_ms: host milliseconds per batch in the program's
``drain.records`` span (the SoA, summary lines and ``.card`` tee when
asked for, and the ``.toad`` record array), averaged over the batches
finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.span_ms(ctx, "drain.records")
