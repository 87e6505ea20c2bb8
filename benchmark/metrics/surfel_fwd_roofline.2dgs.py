"""``surfel_fwd``'s share of its roofline in the traced requests, in
percent: the least time the surfel forward of their views needs
(``benchmark.surfel_counts.fwd_bound_s``: the needed pairs x the model's
``OPS_PER_PAIR`` at 67 TFLOP/s, or each on-screen surfel's ``FIELDS``
read and each pixel written once at 3.35 TB/s, whichever is longer) over
the device time of the kernels named ``surfel_fwd_kernel``. Reads
``surfel_fwd_roofline.2dgs``; nothing where no such kernel ran."""

import re

from benchmark import surfel_counts as SC
from benchmark import trace as T

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?surfel_fwd_kernel[(<]")


def read(ctx):
    if ctx.trace is None:
        return None
    t = T.device_seconds(ctx.trace, NAME.match)
    if t <= 0:
        return None
    w = ctx.work()
    bound = sum(SC.fwd_bound_s(r["pairs"], r["visible"], w["pixels"], ctx.model)
                for r in w["rows"])
    return 100.0 * bound / t
