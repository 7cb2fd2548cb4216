"""device_idle_pct: the share of the traced slice of the window in
which no device operation (kernel, copy or set) ran, in percent."""

from benchmark.harness.trace import busy_us, device_events


def read(ctx):
    events = ctx.get("events") or []
    window_s = (ctx.get("trace") or {}).get("window_s")
    if not device_events(events) or not window_s:
        return None
    return 100.0 * (1.0 - busy_us(events) * 1e-6 / window_s)
