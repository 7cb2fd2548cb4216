"""upload_ms: host milliseconds per batch in the program's ``upload``
span (``pipeline.host.PinnedUpload``: the staging copy into pinned
memory and the non-blocking copy to the card's queue), averaged over the
batches finished in the window."""

from benchmark.harness import program


def read(ctx):
    return program.span_ms(ctx, "upload")
