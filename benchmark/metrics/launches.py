"""Kernel launches per unit of traced work (a request or a step): the
kernels the device ran in the traced units (one per launch; copies and
memsets apart), over the units. Reads ``launches.<anything>``."""

from benchmark import trace as T


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    n = T.kernel_launches(ctx.trace)
    return n / ctx.units if n else None
