"""An appearance model's viewer request's share of the card's float32
peak, in percent: the request's operations as ``mfu.py`` counts them (the
model's ``OPS_PER_GAUSSIAN``, the projection, for every live gaussian;
the needed pairs x 26; the frame's assembly per pixel) and the head's
``APP_OPS_PER_ROW`` for each gaussian on screen (the reference's
``visible``: the rows whose colour the frame reads), over the untraced
window's mean time per request x 67 TFLOP/s. The count is the same
whatever evaluates the head, and however many rows it evaluates. Reads
``mfu.app``."""

from benchmark import counts as C


def read(ctx):
    if ctx.unit_s is None:
        return None
    w, m = ctx.work(), ctx.model
    ops = [C.view_ops(w["n_alive"], w["pixels"], r["pairs"], m.OPS_PER_GAUSSIAN)
           + r["visible"] * m.APP_OPS_PER_ROW for r in w["rows"]]
    return 100.0 * (sum(ops) / len(ops)) / (ctx.unit_s * C.F32_FLOPS)
