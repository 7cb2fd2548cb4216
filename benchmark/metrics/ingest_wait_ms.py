"""ingest_wait_ms: host milliseconds per batch spent in the reader's
``next()`` (the pump's ring read and host unfold, or the ``.card``
prefetch queue), averaged over the batches finished in the window."""


def read(ctx):
    window = ctx["window"]
    if not window:
        return None
    return sum(b.t_got - b.t_ask for b in window) * 1e3 / len(window)
