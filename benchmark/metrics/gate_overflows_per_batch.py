"""gate_overflows_per_batch: batches whose carrier-positive blocks
overflowed the gate's capacity and re-ran the correlation in full (the
detector's ``gate_overflows`` counter over the window), per batch
finished in the window.  Nothing to read in an ungated configuration."""


def read(ctx):
    if not ctx["settings"].get("gate_capacity") or not ctx["window"]:
        return None
    return ctx["overflows"] / len(ctx["window"])
