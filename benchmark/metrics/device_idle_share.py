"""`device_idle_share`: the share of the profiled part's wall time in
which no device activity (kernel, copy or set) ran: 1 minus the union of
their intervals over the part's seconds, so work on two streams at once
counts once."""

from benchmark.tracing import busy_seconds


def read(ctx):
    if not ctx.device or ctx.window_s <= 0:
        return None
    return 1.0 - busy_seconds(ctx.device) / ctx.window_s
