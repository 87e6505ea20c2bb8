"""A viewer request's share of the card's float32 peak, in percent: the
request's operations as ``benchmark.counts.view_ops`` counts them
(the model's ``OPS_PER_GAUSSIAN`` for every live gaussian: projection and
colour; the needed (pixel, gaussian) pairs x 26; the frame's assembly per
pixel), over the untraced window's mean time per request x 67 TFLOP/s.
Reads ``mfu.<anything>``; a cell whose unit of work is not a viewer
request brings its own ``mfu.<suffix>.py``."""

from benchmark import counts as C


def read(ctx):
    if ctx.unit_s is None:
        return None
    w = ctx.work()
    ops = [C.view_ops(w["n_alive"], w["pixels"], r["pairs"], ctx.model.OPS_PER_GAUSSIAN)
           for r in w["rows"]]
    return 100.0 * (sum(ops) / len(ops)) / (ctx.unit_s * C.F32_FLOPS)
