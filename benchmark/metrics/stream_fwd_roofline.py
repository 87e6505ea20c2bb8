"""``stream_fwd``'s share of its roofline in the traced units of work, in
percent: the least time the forward compositing of their views needs
(``benchmark.counts.fwd_bound_s``: the needed pairs x 26 operations at 67
TFLOP/s, or its bytes at 3.35 TB/s, whichever is longer) over the device
time of the kernels named ``stream_fwd_kernel``. Reads
``stream_fwd_roofline.<anything>``."""

import re

from benchmark import counts as C
from benchmark import trace as T

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?stream_fwd_kernel[(<]")


def read(ctx):
    if ctx.trace is None:
        return None
    t = T.device_seconds(ctx.trace, NAME.match)
    if t <= 0:
        return None
    w = ctx.work()
    bound = sum(C.fwd_bound_s(r["pairs"], r["visible"], w["pixels"]) for r in w["rows"])
    return 100.0 * bound / t
