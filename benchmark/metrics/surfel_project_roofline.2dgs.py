"""``surfel_project``'s share of its roofline in the traced requests, in
percent: the least time the surfel projection of their views needs
(``benchmark.surfel_counts.project_bound_s``: each live surfel's
``BYTES_PER_GAUSSIAN`` read and each on-screen surfel's ``FIELDS``
written once at 3.35 TB/s, or its ``OPS_PER_GAUSSIAN`` operations at 67
TFLOP/s, whichever is longer) over the device time of the kernels named
``surfel_project_kernel``. Reads ``surfel_project_roofline.2dgs``;
nothing where no such kernel ran."""

import re

from benchmark import surfel_counts as SC
from benchmark import trace as T

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?surfel_project_kernel[(<]")


def read(ctx):
    if ctx.trace is None:
        return None
    t = T.device_seconds(ctx.trace, NAME.match)
    if t <= 0:
        return None
    w = ctx.work()
    bound = sum(SC.project_bound_s(w["n_alive"], r["visible"], ctx.model) for r in w["rows"])
    return 100.0 * bound / t
