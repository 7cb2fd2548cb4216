"""drain_ms: host milliseconds per batch from the call of its
``result()`` to its records handed back by ``detect_batches`` (the
device wait, the host copies, the SoA and the record array), averaged
over the batches finished in the window."""


def read(ctx):
    window = ctx["window"]
    if not window:
        return None
    return sum(b.t_records - b.t_result for b in window) * 1e3 / len(window)
