"""``project_fwd``'s share of its roofline in the traced units of work, in
percent: the least time the projection of their views needs
(``benchmark.counts.project_bound_s``: each live gaussian's parameters read
once, ``BYTES_PER_GAUSSIAN`` of the configuration's model, and each
on-screen gaussian's 10 fields written once, at 3.35 TB/s; or its
``OPS_PER_GAUSSIAN`` operations at 67 TFLOP/s, whichever is longer) over
the device time of the kernels named ``project_fwd_kernel``. Reads
``project_fwd_roofline.<anything>``; nothing where no such kernel ran."""

import re

from benchmark import counts as C
from benchmark import trace as T

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?project_fwd_kernel[(<]")


def read(ctx):
    if ctx.trace is None:
        return None
    t = T.device_seconds(ctx.trace, NAME.match)
    if t <= 0:
        return None
    w, m = ctx.work(), ctx.model
    bound = sum(C.project_bound_s(w["n_alive"], r["visible"], m.OPS_PER_GAUSSIAN,
                                  m.BYTES_PER_GAUSSIAN) for r in w["rows"])
    return 100.0 * bound / t
