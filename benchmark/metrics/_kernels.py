"""Helpers the kernel readers share (not a metric: no ``read``)."""


def device_time(ctx, *names):
    """(device seconds, {name: launches}) of the trace's operations whose
    name contains one of ``names``."""
    secs, counts = 0.0, {n: 0 for n in names}
    for op, (s, c) in ctx["kernels"].items():
        for n in names:
            if n in op:
                secs += s
                counts[n] += c
    return secs, counts
