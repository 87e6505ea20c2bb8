"""A 2DGS viewer request's share of the card's float32 peak, in percent:
the request's operations as ``benchmark.surfel_counts.view_ops`` counts
them with the surfel model's counts (every live surfel's projection and
colour, the needed (pixel, surfel) pairs x ``OPS_PER_PAIR``, the frame's
assembly per pixel), over the untraced window's mean time per request x
67 TFLOP/s. Reads ``mfu.2dgs``."""

from benchmark import counts as C
from benchmark import surfel_counts as SC


def read(ctx):
    if ctx.unit_s is None:
        return None
    w = ctx.work()
    ops = [SC.view_ops(w["n_alive"], w["pixels"], r["pairs"], ctx.model) for r in w["rows"]]
    return 100.0 * (sum(ops) / len(ops)) / (ctx.unit_s * C.F32_FLOPS)
