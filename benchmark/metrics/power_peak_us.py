"""power_peak_us: the mean device time, in microseconds, of a launch of
the fused power/peak kernel (``thrifty_tpu_torch/csrc/power_peak.cu``)
over the traced slice of the window, from the kernels named ``KERNEL``
in the trace.

It is a time and not a share of a roofline: on the detect path the
kernel's input has just been written by cuFFT and is read from L2, so
the bytes it must move over HBM bandwidth would credit it with a roof
it does not meet, and no DRAM byte count is read here."""

from benchmark.harness.trace import kernels

KERNEL = "power_peak_kernel"


def read(ctx):
    timed = [e["dur"] for e in kernels(ctx.get("events") or [])
             if KERNEL in e["name"]]
    if not timed:
        return None
    return sum(timed) / len(timed)
