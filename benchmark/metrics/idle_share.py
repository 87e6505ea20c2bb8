"""Share of the traced window in which no activity ran on the device:
1 - (union of the device's activity intervals) / (the window's host span),
in percent. Reads ``idle_share.<anything>``."""

from benchmark import trace as T


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - T.busy_us(ctx.trace) / T.window_us(ctx.trace))
