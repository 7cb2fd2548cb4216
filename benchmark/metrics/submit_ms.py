"""submit_ms: host milliseconds per batch inside the detector's
``submit_raw``/``submit_raw_stream``, the cost of launching the detector
program, averaged over the batches finished in the window."""


def read(ctx):
    window = ctx["window"]
    if not window:
        return None
    return sum(b.submit_s for b in window) * 1e3 / len(window)
