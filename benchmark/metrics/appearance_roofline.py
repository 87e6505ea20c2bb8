"""The appearance head's share of its roofline in the traced requests, in
percent: the least time the head needs for the rows each frame shows (the
reference's on-screen gaussians, ``visible``, times the model's
``APP_OPS_PER_ROW`` at 67 TFLOP/s or its ``APP_BYTES_PER_ROW`` at 3.35
TB/s, whichever is longer) over the device time of the operations that
the span ``viewer.appearance`` enqueued (``benchmark.appearance_spans``).
The bound is the same whatever evaluates the head, and however many rows
it evaluates. Reads ``appearance_roofline.<anything>``; nothing where the
model has no head or no operation was enqueued in the span."""

from benchmark import appearance_spans as A
from benchmark import counts as C


def read(ctx):
    m = ctx.model
    if ctx.trace is None or not hasattr(m, "APP_OPS_PER_ROW"):
        return None
    got = A.attribute(ctx.trace)
    us = (got.get("device") or {}).get("appearance", 0.0) if got else 0.0
    if us <= 0:
        return None
    bound = sum(max(r["visible"] * m.APP_OPS_PER_ROW / C.F32_FLOPS,
                    r["visible"] * m.APP_BYTES_PER_ROW / C.HBM_BYTES_PER_S)
                for r in ctx.work()["rows"])
    return 100.0 * bound / (us * 1e-6)
